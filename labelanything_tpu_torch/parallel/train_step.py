"""Training and evaluation steps (counterpart of
``labelanything_tpu/parallel/train_step.py``).

One call of the train step carries a whole pass: forward, loss, backward,
gradient accumulation and the optimizer update. Parameters are fp32 and
every layer casts to its compute dtype at use (bf16 for training on the
card), the loss reduces in fp32: fp32 master weights, bf16 compute, as the
JAX package trains.

Gradient accumulation over substitution passes follows the reference's
``nosync_accumulation`` (experiment/utils.py:252-259): passes with
``apply_update=False`` add into ``.grad``, the final pass applies the sum.
The JAX package also fuses a pass, or several, into one device dispatch
(``make_pass_step``, ``make_chunk_step``); that is a device of its runtime
and has no counterpart here: the substitution loop is
:class:`..train.substitutor.Substitutor` iterating the train step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Union

import torch
from torch import nn

from ..api import build_on_device
from ..train.metrics import (binary_confusion_matrix, confusion_matrix,
                             confusion_matrix_per_sample)
from ..train.optim import build_optimizer, named_parameters
from ..typing import LossDict, ResultDict

Batch = Dict[str, Any]


@dataclasses.dataclass
class TrainState:
    """What a step reads and updates in place."""

    model: nn.Module
    loss: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0          # optimizer updates applied so far


def init_train_state(model: Union[nn.Module, Dict[str, Any]],
                     loss_module: nn.Module,
                     device: Union[str, torch.device] = "cuda",
                     seed: Optional[int] = 0,
                     **optimizer_args: Any) -> TrainState:
    """Train state on ``device``: the first CUDA card unless the caller
    names another, such as ``"cpu"``. ``model`` is a model config, built
    there with the weights of ``seed`` (:func:`..api.build_on_device`), or
    a built model, which is moved there (``seed`` unused). The optimizer
    and schedule are those of :func:`..train.optim.build_optimizer`
    (``name``, ``learning_rate``,
    ``weight_decay``, ``backbone_lr``, ``scheduler``, ``freeze_backbone``,
    ...). With ``freeze_backbone`` the image encoder's parameters stop
    requiring grad."""
    if isinstance(model, nn.Module):
        model = model.to(device)
    else:
        model = build_on_device(model, device, seed)
    loss_module = loss_module.to(device)
    optimizer, scheduler = build_optimizer(
        named_parameters(model=model, loss=loss_module), **optimizer_args)
    return TrainState(model, loss_module, optimizer, scheduler)


def _device_of(module: nn.Module) -> torch.device:
    return next(module.parameters()).device


def _to_device(batch: Batch, device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _metrics(aux: dict, preds, gt, num_classes: Optional[int],
             with_confmat: bool, logit_classes: int) -> None:
    if num_classes is not None:
        aux["confmat"] = confusion_matrix(preds, gt, num_classes)
        aux["confmat2"] = binary_confusion_matrix(preds, gt)
    if with_confmat:
        aux["confmat_ps"] = confusion_matrix_per_sample(preds, gt,
                                                        logit_classes)
        aux.setdefault("confmat2", binary_confusion_matrix(preds, gt))


def make_train_step(num_classes: Optional[int] = None,
                    with_confmat: bool = False) -> Callable:
    """Build the train step.

    ``train_step(state, batch, gt, generator, loss_scale, *,
    apply_update=True, use_accum=True) -> (state, aux)``:

    * ``batch`` / ``gt`` as :func:`..train.substitutor.divide_query_examples`
      gives them (numpy arrays or tensors; moved to the model's device);
    * ``generator``: the CPU ``torch.Generator`` of the class-row draw of
      ``RandomMatrixEncoder``, handed to the model's forward (None:
      PyTorch's default generator);
    * ``loss_scale``: the gradients are multiplied by it (the reference's
      1 / loss_normalizer of substitution accumulation); the reported loss
      is not;
    * ``apply_update=False`` adds this pass's gradients into ``.grad`` and
      leaves the parameters alone; ``apply_update=True`` steps the
      optimizer on the accumulated sum and clears it. With
      ``use_accum=False`` the step is on this pass's gradients alone
      (anything accumulated before is dropped).

    ``aux`` holds ``loss``, ``components``, ``preds`` (argmax over classes)
    and, when ``num_classes`` is given, ``confmat`` and ``confmat2``; with
    ``with_confmat`` also ``confmat_ps`` (classes from the logits' shape).
    """

    def train_step(state: TrainState, batch: Batch, gt,
                   generator: Optional[torch.Generator],
                   loss_scale: float = 1.0, *, apply_update: bool = True,
                   use_accum: bool = True):
        model = state.model
        device = _device_of(model)
        batch, gt = _to_device(batch, device), torch.as_tensor(gt, device=device)
        model.train()
        if generator is None:
            generator = torch.default_generator
        if apply_update and not use_accum:
            state.optimizer.zero_grad(set_to_none=True)

        result = model(batch, generator)
        loss_out = state.loss(result, gt)
        loss = loss_out[LossDict.VALUE]
        # .grad accumulates across calls: backward of (scale * loss) adds
        # scale * dloss/dp to what earlier passes left there
        (loss * loss_scale).backward()

        if apply_update:
            state.optimizer.step()
            state.scheduler.step()
            state.optimizer.zero_grad(set_to_none=True)
            state.step += 1

        with torch.no_grad():
            logits = result[ResultDict.LOGITS]
            preds = logits.argmax(dim=1)
            aux = {"loss": loss.detach(),
                   "components": {k: v.detach() for k, v in
                                  loss_out[LossDict.COMPONENTS].items()},
                   "preds": preds}
            _metrics(aux, preds, gt, num_classes, with_confmat,
                     logits.shape[1])
        return state, aux

    return train_step


def make_eval_step(num_classes: int) -> Callable:
    """``eval_step(model, batch, gt) -> {"confmat", "confmat2", "preds"}``
    in ``eval()`` mode under ``no_grad``."""

    @torch.no_grad()
    def eval_step(model: nn.Module, batch: Batch, gt):
        device = _device_of(model)
        batch, gt = _to_device(batch, device), torch.as_tensor(gt, device=device)
        model.eval()
        preds = model(batch)[ResultDict.LOGITS].argmax(dim=1)
        aux = {"preds": preds}
        _metrics(aux, preds, gt, num_classes, False, 0)
        return aux

    return eval_step
