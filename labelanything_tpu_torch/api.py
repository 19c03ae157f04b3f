"""Public model API (counterpart of ``labelanything_tpu/api.py``; reference:
label_anything/models/build_lam.py:402-508).

``LabelAnything`` builds a model from a config onto a device (the first
CUDA card unless the caller names another, such as ``"cpu"``) and serves it:

    la = LabelAnything(config, device="cuda", seed=0)   # seeded weights
    embeddings = la.generate_class_embeddings(support_batch)
    logits = la.predict(query_batch, embeddings)

Batches are dicts of numpy arrays or tensors in the JAX package's
channels-last layout (``labelanything_tpu.data.synthetic.random_batch``);
they are moved to the model's device. Checkpoints:

    la = LabelAnything.from_pretrained("path/to/checkpoint_dir")
    la.save_pretrained("out_dir")

A checkpoint directory holds ``config.json`` and the weights as a state
dict of the reference layout: ``model.safetensors`` (read and written by
``utils/safetensors.py``), ``pytorch_model.bin`` or ``model.pth``; the JAX
package's ``save_torch_compatible`` writes one and reads the port's.
Hugging Face ids resolve through a local ``LABELANYTHING_CACHE`` /
``HF_HOME`` snapshot; nothing is downloaded. The JAX package's own
``params/`` (orbax) directories are not read: re-save them there with
``save_torch_compatible``. :meth:`LabelAnything.from_jax_params` takes the
JAX package's parameters in memory.
"""

from __future__ import annotations

import json
import os
import pathlib
from typing import Any, Dict, Optional, Union

import torch

from .models.build_lam import build_lam
from .models.registry import model_registry
from .typing import ResultDict
from .utils.safetensors import load_file, save_file
from .utils.weights import (init_weights, reference_state_dict,
                            state_dict_from_jax)

Batch = Dict[str, Any]

CONFIG_NAME = "config.json"
TORCH_WEIGHTS = ("model.safetensors", "pytorch_model.bin", "model.pth")
JAX_PARAMS_DIR = "params"
# keys a reference config may carry that name no builder argument
_TORCH_ONLY_KEYS = ("checkpoint", "use_sam_checkpoint", "torch_dtype",
                    "transformers_version", "architectures")


class LabelAnythingConfig(dict):
    """Plain-dict config (reference: build_lam.py:402-464): any key of a
    model block, the LAM variants' included, goes to ``config.json`` and
    back unchanged."""

    @classmethod
    def from_file(cls, path: str) -> "LabelAnythingConfig":
        with open(path) as f:
            return cls(json.load(f))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(dict(self), f, indent=2)


def _resolve_checkpoint_dir(name_or_path: str) -> pathlib.Path:
    """A checkpoint directory: the path itself, or a Hugging Face id's local
    snapshot under ``LABELANYTHING_CACHE``, ``HF_HOME`` or
    ``~/.cache/huggingface`` (JAX ``api.py:52-81``; the hub download it
    falls back to is not ported)."""
    p = pathlib.Path(name_or_path)
    if p.is_dir():
        return p
    for root in (os.environ.get("LABELANYTHING_CACHE"),
                 os.environ.get("HF_HOME"),
                 os.path.expanduser("~/.cache/huggingface")):
        if not root:
            continue
        repo_dir = pathlib.Path(root) / "hub" / (
            "models--" + name_or_path.replace("/", "--")) / "snapshots"
        if repo_dir.exists():
            snaps = sorted(repo_dir.iterdir())
            if snaps:
                return snaps[-1]
        flat = pathlib.Path(root) / name_or_path.replace("/", "--")
        if flat.is_dir():
            return flat
    raise FileNotFoundError(
        f"Checkpoint {name_or_path!r} not found locally (no hub download "
        f"here); put the snapshot under LABELANYTHING_CACHE.")


def load_weights_file(path: str) -> Dict[str, torch.Tensor]:
    """A state dict from ``.safetensors`` or a ``torch.save`` file (whose
    ``state_dict`` entry is taken when it has one), on the CPU."""
    if str(path).endswith(".safetensors"):
        return load_file(str(path))
    state = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in state:
        state = state["state_dict"]
    return dict(state)

# config keys that name the architecture or the weights' origin, not a
# builder argument; ``backbone_checkpoint`` (DCAMA's Swin-B weights, a file
# the repository does not hold) is dropped as the JAX builder drops it
# (ROADMAP C17)
_NOT_BUILD_ARGS = ("model_type", "name", "checkpoint", "use_sam_checkpoint",
                   "backbone_checkpoint")


def build_from_config(config: Dict[str, Any]) -> torch.nn.Module:
    """Build the model a config describes: ``name`` picks an entry of the
    registry (the LAM models "lam_b", "lam_l", "lam_h", "lam_no_vit", or the
    baselines "panet", "ppnet", "denet", "bam", "hdmnet", "dcama",
    "fptrans"); without one it
    is, like the JAX ``LabelAnything``, the no-encoder ``build_lam``. Every
    other key is a builder argument, the LAM variants' included
    (``fusion_transformer``, ``class_embedding_dim``, ``prompt_encoder``,
    ``embeddings_per_example``, ``dropout``, ...: ``models.build_lam``)."""
    args = {k: v for k, v in config.items() if k not in _NOT_BUILD_ARGS}
    name = config.get("name")
    if name is None:
        return build_lam(**args)
    if name not in model_registry:
        raise ValueError(f"unknown model {name!r}; ported: "
                         f"{sorted(model_registry)}")
    return model_registry[name](**args)


def build_on_device(config: Dict[str, Any],
                    device: Union[str, torch.device] = "cuda",
                    seed: Optional[int] = 0) -> torch.nn.Module:
    """The model of ``config`` (a ``Lam`` or a baseline) built straight on
    ``device`` (no CPU copy first). With a ``seed`` every parameter and
    buffer comes from :func:`init_weights` (BatchNorm's running variances
    1 + 0.05 x, positive); with ``seed=None`` they are left unset for a
    following ``load_state_dict``."""
    with torch.device("meta"):
        model = build_from_config(config)
    model = model.to_empty(device=torch.device(device))
    if seed is not None:
        init_weights(model, seed)
    return model


class LabelAnything:
    """Model bundle with the reference's serving surface."""

    def __init__(self, config: Dict[str, Any],
                 device: Union[str, torch.device] = "cuda",
                 seed: Optional[int] = 0):
        """Build on ``device`` (see :func:`build_on_device`), in ``eval()``
        mode."""
        self.config = dict(config)
        self.device = torch.device(device)
        self.model = build_on_device(self.config, self.device, seed).eval()

    @classmethod
    def from_jax_params(cls, config: Dict[str, Any], params: Dict[str, Any],
                        device: Union[str, torch.device] = "cuda"
                        ) -> "LabelAnything":
        """The model with the JAX package's parameters (numpy leaves)."""
        la = cls(config, device, seed=None)
        la.load_state_dict(state_dict_from_jax(params))
        return la

    @classmethod
    def from_pretrained(cls, name_or_path: str,
                        device: Union[str, torch.device] = "cuda",
                        **config_overrides) -> "LabelAnything":
        """The model of a checkpoint directory (:func:`_resolve_checkpoint_dir`)
        on ``device``, from its ``config.json`` (updated by
        ``config_overrides``) and the first of :data:`TORCH_WEIGHTS` it
        holds (JAX ``api.py:114-143``)."""
        ckpt_dir = _resolve_checkpoint_dir(name_or_path)
        config = LabelAnythingConfig.from_file(str(ckpt_dir / CONFIG_NAME))
        config.update(config_overrides)
        for key in _TORCH_ONLY_KEYS:
            config.pop(key, None)
        for fname in TORCH_WEIGHTS:
            fpath = ckpt_dir / fname
            if fpath.exists():
                la = cls(config, device, seed=None)
                la.load_state_dict(reference_state_dict(
                    load_weights_file(str(fpath)), la.model.state_dict()))
                return la
        if (ckpt_dir / JAX_PARAMS_DIR).exists():
            raise ValueError(
                f"{ckpt_dir} holds the JAX package's {JAX_PARAMS_DIR}/ "
                f"(orbax) weights, which the port does not read; write "
                f"model.safetensors from the JAX package with "
                f"LabelAnything.save_torch_compatible")
        raise FileNotFoundError(f"No weights found under {ckpt_dir}")

    def save_pretrained(self, out_dir: str) -> None:
        """``config.json`` and ``model.safetensors`` (the reference-layout
        state dict) under ``out_dir``."""
        out = pathlib.Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        LabelAnythingConfig(self.config).save(str(out / CONFIG_NAME))
        save_file(self.model.state_dict(), str(out / "model.safetensors"))

    def save_torch_compatible(self, out_dir: str) -> None:
        """What :meth:`save_pretrained` writes: the port's weights already
        are the reference layout, which both packages and the reference
        read (JAX ``api.py:153-164``)."""
        self.save_pretrained(out_dir)

    def load_state_dict(self, state_dict: Dict[str, torch.Tensor]) -> None:
        """Load a reference-layout state dict; every key must match."""
        self.model.load_state_dict(state_dict, strict=True)

    def to_device(self, batch: Batch) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in batch.items()}

    @torch.no_grad()
    def __call__(self, batch: Batch) -> Dict[str, torch.Tensor]:
        """Full episode: query (index 0) plus examples in one batch."""
        return self.model(self.to_device(batch))

    @torch.no_grad()
    def generate_class_embeddings(self, example_batch: Batch) -> dict:
        """Class embeddings of a support batch (reference: lam.py:349-361)."""
        return self.model.generate_class_embeddings(self.to_device(example_batch))

    @torch.no_grad()
    def predict(self, batch: Batch, class_embeddings: Optional[dict] = None
                ) -> torch.Tensor:
        """Logits (B, C, S, S) of the query (index 0) against cached class
        embeddings, or of the whole episode when none are given
        (reference: lam.py:362-382)."""
        if class_embeddings is None:
            return self(batch)[ResultDict.LOGITS]
        return self.model.predict(self.to_device(batch), class_embeddings)
