"""Optimizer and learning-rate schedule (counterpart of
``labelanything_tpu/train/optim.py``; reference: experiment/utils.py:53-100
and models/lam.py:321-347, the backbone's own learning rate).

The schedules are the closed forms of the optax schedules the JAX package
joins, as factors of the base learning rate for ``LambdaLR``. Mind two
defaults that differ between the frameworks: ``torch.optim.AdamW`` decays
weights by 0.01 unless told otherwise where ``optax.adamw`` here gets 0.0,
so the weight decay is always passed on; and SGD's weight decay is the
coupled L2 term of ``torch.optim.SGD``, which is what the JAX package
builds out of ``add_decayed_weights`` before the momentum.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

# The JAX package also freezes ``positional_encoding_gaussian_matrix``; in
# the port that matrix is a buffer, so it is in no parameter group to begin
# with.
BACKBONE = "image_encoder"


def build_scheduler(name: str = "constant_with_warmup",
                    num_warmup_steps: int = 0,
                    num_training_steps: Optional[int] = None,
                    **_: Any) -> Callable[[int], float]:
    """``step -> lr / learning_rate`` of the HF-style schedules (reference:
    experiment/utils.py:77-100)."""
    warmup = max(num_warmup_steps, 1)

    def ramp(step: int) -> float:
        return min(max(step, 0) / warmup, 1.0)

    if name == "constant":
        return lambda step: 1.0
    if name == "constant_with_warmup":
        return ramp
    if name == "linear":
        decay = max((num_training_steps or 1) - num_warmup_steps, 1)

        def linear(step: int) -> float:
            if step < warmup:
                return ramp(step)
            return 1.0 - min((step - warmup) / decay, 1.0)

        return linear
    if name == "cosine":
        total = max(num_training_steps or 0, warmup + 1)

        def cosine(step: int) -> float:
            if step < warmup:
                return ramp(step)
            frac = min((step - warmup) / (total - warmup), 1.0)
            return 0.5 * (1.0 + math.cos(math.pi * frac))

        return cosine
    raise ValueError(f"Unknown scheduler {name!r}")


def parameter_groups(named_params, learning_rate: float,
                     backbone_lr: Optional[float] = None,
                     freeze_backbone: bool = False):
    """Split ``(name, parameter)`` pairs into the optimizer's groups: main,
    and backbone (names with an ``image_encoder`` part) when it has its own
    learning rate. With ``freeze_backbone`` the backbone's parameters are in
    no group and stop requiring grad, so no gradient is computed for them
    and the encoder's backward kernels never launch."""
    main, backbone = [], []
    own_group = freeze_backbone or backbone_lr is not None
    for name, param in named_params:
        if own_group and BACKBONE in name.split("."):
            if freeze_backbone:
                param.requires_grad_(False)
            else:
                backbone.append(param)
        else:
            main.append(param)
    groups = [{"params": main, "lr": learning_rate}]
    if backbone:
        groups.append({"params": backbone, "lr": backbone_lr})
    return groups


def build_optimizer(named_params, name: str = "AdamW",
                    learning_rate: float = 5e-5, weight_decay: float = 0.0,
                    momentum: float = 0.9,
                    backbone_lr: Optional[float] = None,
                    scheduler: Optional[Dict[str, Any]] = None,
                    freeze_backbone: bool = False, schedule_div: int = 1
                    ) -> Tuple[torch.optim.Optimizer,
                               torch.optim.lr_scheduler.LambdaLR]:
    """(optimizer, scheduler) over ``named_params``, an iterable of
    ``(name, parameter)`` (reference: experiment/utils.py:53-74).

    ``schedule_div``: schedules that advance once per epoch pass the steps
    per epoch here and the schedule sees ``step // schedule_div``. Call
    ``scheduler.step()`` after every ``optimizer.step()``."""
    groups = parameter_groups(named_params, learning_rate, backbone_lr,
                              freeze_backbone)
    if name.lower() == "adamw":
        optimizer = torch.optim.AdamW(groups, lr=learning_rate,
                                      betas=(0.9, 0.999), eps=1e-8,
                                      weight_decay=weight_decay)
    elif name.lower() == "sgd":
        optimizer = torch.optim.SGD(groups, lr=learning_rate,
                                    momentum=momentum,
                                    weight_decay=weight_decay)
    else:
        raise ValueError(f"Unknown optimizer {name!r}")
    factor = build_scheduler(**dict(scheduler or {"name": "constant"}))
    lr_lambda = ((lambda step: factor(step // schedule_div))
                 if schedule_div > 1 else factor)
    return optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, lr_lambda)


def named_parameters(**modules: nn.Module):
    """``(name, parameter)`` pairs of several modules, names prefixed by the
    keyword (``model.image_encoder...``, ``loss.t_prime``)."""
    for prefix, module in modules.items():
        for name, param in module.named_parameters():
            yield f"{prefix}.{name}", param
