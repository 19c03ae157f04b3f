"""Public model API (counterpart of ``labelanything_tpu/api.py``; reference:
label_anything/models/build_lam.py:402-508).

``LabelAnything`` builds a model from a config onto a device (the first
CUDA card unless the caller names another, such as ``"cpu"``) and serves it:

    la = LabelAnything(config, device="cuda", seed=0)   # seeded weights
    embeddings = la.generate_class_embeddings(support_batch)
    logits = la.predict(query_batch, embeddings)

Batches are dicts of numpy arrays or tensors in the JAX package's
channels-last layout (``labelanything_tpu.data.synthetic.random_batch``);
they are moved to the model's device. Loading released checkpoints
(``from_pretrained``) is not ported yet; :meth:`LabelAnything.from_jax_params`
takes the JAX package's parameters.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

from .models.build_lam import build_lam
from .models.lam import Lam
from .models.registry import model_registry
from .typing import ResultDict
from .utils.weights import init_weights, state_dict_from_jax

Batch = Dict[str, Any]

# config keys that name the architecture or the weights' origin, not a
# builder argument
_NOT_BUILD_ARGS = ("model_type", "name", "checkpoint", "use_sam_checkpoint")


def build_from_config(config: Dict[str, Any]) -> Lam:
    """Build the model a config describes: ``name`` picks an entry of the
    registry ("lam_b", "lam_l", "lam_h", "lam_no_vit"); without one it is,
    like the JAX ``LabelAnything``, the no-encoder ``build_lam``."""
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
                    seed: Optional[int] = 0) -> Lam:
    """The model of ``config`` built straight on ``device`` (no CPU copy
    first). With a ``seed`` the weights come from :func:`init_weights`; with
    ``seed=None`` they are left unset for a following ``load_state_dict``."""
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
