"""Checkpoint evaluation: the published validation protocol with fixed weights
(counterpart of ``labelanything_tpu/experiment/evaluate.py``; reference:
README.md:64-71, parameters/validation/COCO/mae.yaml,
experiment/run.py:603-742).

``python -m labelanything_tpu_torch.cli validate --parameters
parameters/validation/COCO/mae.yaml --checkpoint <dir>`` runs every grid
point of the file as one fold (the YAML's ``other_grids``: 4 folds) x
``val_params.reruns`` seeded reruns x its episodes a validation set, with
the checkpoint's weights; it writes ``results.json`` (``fold{i}/<set>_<metric>``,
``mean/miou``, ``mean/fbiou``), logs a fold table and, given a JSON of
reference values (``--compare``), their deltas.

A checkpoint is one of:

* a ``save_pretrained`` directory or a local snapshot (``config.json`` and
  a reference-layout state dict), read by ``api.LabelAnything.from_pretrained``;
* a run's ``checkpoints`` directory: ``latest`` before ``best``, as the
  JAX package takes them, or one such tag directory;
* a bare weights file (``.pth``, ``.bin``, ``.safetensors``) in the
  reference's names.

The weights load with ``load_state_dict(strict=True)``; a checkpoint of
another architecture raises ``ValueError`` naming some of its missing and
unexpected keys. The JAX package's orbax directories are not read.
"""

from __future__ import annotations

import json
import pathlib
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from ..utils.logging import get_logger

logger = get_logger(__name__)

CHECKPOINT_TAGS = ("latest", "best")


def _orbax_error(path: pathlib.Path) -> ValueError:
    return ValueError(
        f"{path} holds no weights the port reads: a training run's "
        "checkpoints of the JAX package (orbax directories) are not readable "
        "here; write the model from the JAX package with "
        "LabelAnything.save_torch_compatible and pass that directory")


def _load_model_params(checkpoint: str, run) -> Dict[str, torch.Tensor]:
    """The state dict, in the port's names, that ``checkpoint`` holds for
    ``run.state.model`` (on the CPU)."""
    from ..api import (CONFIG_NAME, LabelAnything, load_weights_file)
    from ..train.checkpoint import STATE_FILE, CheckpointManager
    from ..utils.weights import reference_state_dict

    p = pathlib.Path(checkpoint)
    model_keys = run.state.model.state_dict().keys()
    if p.is_dir() and (p / CONFIG_NAME).exists():
        return LabelAnything.from_pretrained(str(p), device="cpu"
                                             ).model.state_dict()
    tags = [t for t in CHECKPOINT_TAGS if (p / t).exists()]
    if p.is_dir() and (tags or (p / STATE_FILE).exists()):
        directory, tag = (p, tags[0]) if tags else (p.parent, p.name)
        state, meta = CheckpointManager(str(directory)).model_state(tag)
        if state is None:
            raise _orbax_error(directory / tag)
        logger.info("checkpoint %s (epoch %s)", directory / tag,
                    meta.get("epoch"))
        return state
    if p.is_file():
        return reference_state_dict(load_weights_file(str(p)), model_keys)
    if p.is_dir():
        raise _orbax_error(p)
    raise FileNotFoundError(f"cannot interpret checkpoint {checkpoint!r}")


def _check_tree_match(model: torch.nn.Module,
                      loaded: Dict[str, torch.Tensor]) -> None:
    """Raise ``ValueError`` unless ``loaded`` has every key of ``model``'s
    state dict, no other, each of its shape (what the strict load would
    refuse, named as the JAX package names it)."""
    expected = model.state_dict()
    missing = sorted(set(expected) - set(loaded))
    extra = sorted(set(loaded) - set(expected))
    shapes = sorted(k for k in set(expected) & set(loaded)
                    if tuple(expected[k].shape) != tuple(loaded[k].shape))
    if missing or extra or shapes:
        raise ValueError(
            f"checkpoint does not match the configured architecture: "
            f"{len(missing)} missing (e.g. {missing[:5]}), "
            f"{len(extra)} unexpected (e.g. {extra[:5]}), "
            f"{len(shapes)} of another shape (e.g. "
            f"{[(k, tuple(loaded[k].shape)) for k in shapes[:5]]})")


def fold_table(results: Dict[str, Any], folds: List[int]) -> str:
    """The fold table: a fold a line with its mIoU and the mean of its
    sets' FB-IoU, then the means."""
    lines = ["fold  " + "miou".rjust(8) + "fbiou".rjust(9)]
    for fold in folds:
        miou = results.get(f"fold{fold}/miou", float("nan"))
        fb = [v for k, v in results.items()
              if k.startswith(f"fold{fold}/") and k.endswith("_fbiou")]
        lines.append(f"{fold:>4}  {miou:8.4f}"
                     f"{float(np.mean(fb)) if fb else float('nan'):9.4f}")
    if "mean/miou" in results:
        lines.append(f"mean  {results['mean/miou']:8.4f}"
                     + (f"{results['mean/fbiou']:9.4f}"
                        if "mean/fbiou" in results else ""))
    return "\n".join(lines)


def evaluate_checkpoint(
    parameters: str,
    checkpoint: str,
    out_dir: str = "runs/evaluate",
    folds: Optional[List[int]] = None,
    reruns: Optional[int] = None,
    compare: Optional[str] = None,
    device: Union[str, torch.device] = "cuda",
) -> Dict[str, Any]:
    """The fold x rerun protocol with the weights of ``checkpoint``.

    ``folds`` picks grid indexes (default: all); ``reruns`` replaces
    ``val_params.reruns``; ``compare`` is a JSON file of reference values
    by key (``"fold0/val_coco20i_N1K1_miou"``, ``"mean/miou"``), whose
    deltas (result - reference) come back under ``deltas_vs_reference``
    with their largest magnitude as ``max_abs_delta``. One ``Run`` a fold
    on ``device``, closed (its loaders with it) before the next."""
    from ..utils.config import expand_experiment, load_yaml
    from .run import Run

    flats = expand_experiment(load_yaml(parameters))
    folds = list(range(len(flats))) if folds is None else list(folds)

    results: Dict[str, Any] = {}
    per_fold_miou, per_fold_fbiou = [], []
    for fold in folds:
        flat = dict(flats[fold])
        if reruns is not None:
            flat["val_params"] = dict(flat.get("val_params", {}),
                                      reruns=reruns)
        run = Run().init(flat, run_dir=f"{out_dir}/fold{fold}", device=device)
        try:
            loaded = _load_model_params(checkpoint, run)
            _check_tree_match(run.state.model, loaded)
            run.state.model.load_state_dict(loaded, strict=True)
            metrics = run.validate(epoch=0)
        finally:
            run.close()
        results.update({f"fold{fold}/{k}": v for k, v in metrics.items()})
        if "miou" in metrics:
            per_fold_miou.append(metrics["miou"])
        fb = [v for k, v in metrics.items() if k.endswith("_fbiou")]
        if fb:
            per_fold_fbiou.append(float(np.mean(fb)))
        logger.info("fold %d: %s", fold,
                    {k: round(v, 4) for k, v in metrics.items()})

    if per_fold_miou:
        results["mean/miou"] = float(np.mean(per_fold_miou))
    if per_fold_fbiou:
        results["mean/fbiou"] = float(np.mean(per_fold_fbiou))

    if compare:
        ref = json.loads(pathlib.Path(compare).read_text())
        deltas = {k: results[k] - ref[k] for k in ref if k in results}
        results["deltas_vs_reference"] = deltas
        results["max_abs_delta"] = max((abs(v) for v in deltas.values()),
                                       default=0.0)
        logger.info("max |delta| vs reference table: %.4f",
                    results["max_abs_delta"])

    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "results.json").write_text(json.dumps(results, indent=2))
    logger.info("checkpoint eval table:\n%s", fold_table(results, folds))
    return results
