"""Checkpoint save and restore of a training run (counterpart of
``labelanything_tpu/train/checkpoint.py``; reference: Accelerate's
``save_state`` into ``files/best`` / ``files/latest``,
experiment/run.py:299-309 and logger/wandb.py:935-944).

Layout, as the JAX package writes it:

  <dir>/latest/state.pt   the rolling checkpoint of the whole train state
  <dir>/best/state.pt     the best one by the watch metric
  <dir>/<tag>.meta.json   epoch, metric value and what the caller adds

``state.pt`` is one ``torch.save`` of the model's, the loss module's, the
optimizer's and the schedule's state dicts, the update count, and (when
given) the class-row generator's state, so a restored run takes the same
steps as the run that saved it. The JAX package writes orbax trees, which
the port does not read.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..parallel.train_step import TrainState
from ..utils.safetensors import load_file, save_file

STATE_FILE = "state.pt"


class CheckpointManager:
    def __init__(self, directory: str, watch_metric: str = "mIoU",
                 higher_is_better: bool = True):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.watch_metric = watch_metric
        self.higher_is_better = higher_is_better
        self.best_value: Optional[float] = self._read_meta("best").get(
            "value")

    def _meta_path(self, tag: str) -> pathlib.Path:
        return self.dir / f"{tag}.meta.json"

    def _read_meta(self, tag: str) -> Dict[str, Any]:
        p = self._meta_path(tag)
        return json.loads(p.read_text()) if p.exists() else {}

    def _save(self, tag: str, state: TrainState, meta: Dict[str, Any],
              generator: Optional[torch.Generator] = None) -> None:
        """Crash-safe: written to a temporary sibling, then swapped in, so
        the old checkpoint survives until the new one is on disk."""
        path, tmp = self.dir / tag, self.dir / f"{tag}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        payload = {"model": state.model.state_dict(),
                   "loss": state.loss.state_dict(),
                   "optimizer": state.optimizer.state_dict(),
                   "scheduler": state.scheduler.state_dict(),
                   "step": state.step}
        if generator is not None:
            payload["generator"] = generator.get_state()
        torch.save(payload, tmp / STATE_FILE)
        tmp_meta = self.dir / f"{tag}.meta.json.tmp"
        tmp_meta.write_text(json.dumps(meta))
        if path.exists():
            shutil.rmtree(path)
        os.rename(tmp, path)
        os.replace(tmp_meta, self._meta_path(tag))

    def save_latest(self, state: TrainState, epoch: int,
                    generator: Optional[torch.Generator] = None, **meta):
        self._save("latest", state, {"epoch": epoch, **meta}, generator)

    def maybe_save_best(self, state: TrainState, epoch: int, value: float,
                        generator: Optional[torch.Generator] = None,
                        **meta) -> bool:
        """Save as ``best`` when ``value`` of the watch metric beats the best
        so far (or is the first); True when it did."""
        better = (self.best_value is None
                  or (value > self.best_value) == self.higher_is_better)
        if better and value != self.best_value:
            self.best_value = float(value)
            self._save("best", state, {"epoch": epoch, "value": float(value),
                                       "metric": self.watch_metric, **meta},
                       generator)
            return True
        return False

    def _recover(self, tag: str) -> pathlib.Path:
        """The path of ``tag``, completing a swap that a crash cut between
        its steps (the temporary save is whole)."""
        path, tmp = self.dir / tag, self.dir / f"{tag}.tmp"
        if not path.exists() and (tmp / STATE_FILE).exists():
            os.rename(tmp, path)
            tmp_meta = self.dir / f"{tag}.meta.json.tmp"
            if tmp_meta.exists():
                os.replace(tmp_meta, self._meta_path(tag))
        return path

    def model_state(self, tag: str = "latest"
                    ) -> Tuple[Optional[Dict[str, torch.Tensor]],
                               Dict[str, Any]]:
        """(the model's state dict of checkpoint ``tag`` on the CPU, meta),
        or (None, {}) when there is none: the weights alone, for an
        evaluation whose optimizer need not be the one that trained."""
        path = self._recover(tag)
        if not (path / STATE_FILE).exists():
            return None, {}
        payload = torch.load(path / STATE_FILE, map_location="cpu",
                             weights_only=True)
        return payload["model"], self._read_meta(tag)

    def restore(self, state: TrainState, tag: str = "latest",
                generator: Optional[torch.Generator] = None
                ) -> Tuple[Optional[TrainState], Dict[str, Any]]:
        """Load checkpoint ``tag`` into ``state`` (a train state built as the
        saved one was, on the device to restore onto) and ``generator``:
        (state, meta), or (None, {}) when there is none."""
        path = self._recover(tag)
        if not (path / STATE_FILE).exists():
            return None, {}
        device = next(state.model.parameters()).device
        payload = torch.load(path / STATE_FILE, map_location=device,
                             weights_only=True)
        state.model.load_state_dict(payload["model"], strict=True)
        state.loss.load_state_dict(payload["loss"], strict=True)
        state.optimizer.load_state_dict(payload["optimizer"])
        state.scheduler.load_state_dict(payload["scheduler"])
        state.step = int(payload["step"])
        if generator is not None and "generator" in payload:
            generator.set_state(payload["generator"].cpu())
        return state, self._read_meta(tag)


def save_params(path: str, model: nn.Module) -> None:
    """The model's weights alone, a reference-layout state dict in one
    safetensors file (for ``from_pretrained``-style distribution)."""
    save_file(model.state_dict(), path)


def load_params(path: str, model: nn.Module) -> nn.Module:
    """Load :func:`save_params`' file into ``model``; every key must
    match."""
    device = next(model.parameters()).device
    model.load_state_dict(load_file(path, device), strict=True)
    return model
