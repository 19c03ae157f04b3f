"""Embedding-cache helpers (counterpart of
``labelanything_tpu/data/embeddings.py``).

A cache file holds one ``{"embedding": (C, H, W)}`` tensor (reference:
preprocess.py:70-73, written by ``preprocess.py``) or a feature pyramid
``{"stageN": (C, H, W)}`` (reference: preprocess.py:309-322); the model
takes them channels-last.
"""

from __future__ import annotations

from typing import Dict, List, Union

import torch

from ..utils.safetensors import load_file

Embedding = Union[torch.Tensor, Dict[str, torch.Tensor]]


def _channels_last(e: torch.Tensor) -> torch.Tensor:
    return e.permute(1, 2, 0) if e.dim() == 3 else e


def embedding_from_file(tensors: Dict[str, torch.Tensor]) -> Embedding:
    """Channels-last embedding (or stage dict) of a loaded cache file."""
    if "embedding" in tensors:
        return _channels_last(tensors["embedding"])
    stages = {k: _channels_last(v) for k, v in tensors.items()
              if k.startswith("stage")}
    if not stages:
        raise KeyError("embedding cache has neither 'embedding' nor 'stageN' "
                       f"keys: {sorted(tensors)}")
    return stages


def load_embedding(path: str) -> Embedding:
    """:func:`embedding_from_file` of the cache file at ``path``."""
    return embedding_from_file(load_file(path))


def stack_embeddings(embs: List[Embedding]) -> Embedding:
    """Stack per-image embeddings along a new leading axis; pyramid dicts
    stack per stage."""
    if isinstance(embs[0], dict):
        return {k: torch.stack([e[k] for e in embs]) for k in embs[0]}
    return torch.stack(embs)
