"""Experiment logging (counterpart of ``labelanything_tpu/utils/logging.py``;
reference: label_anything/logger/).

``get_logger`` mirrors the colorlog console logger (text_logger.py:5-56)
without the colorlog dependency. ``ExperimentLogger`` replaces WandBLogger:
metric namespacing by phase contexts (wandb.py:949-981) and a JSONL metric
sink in the run dir (``metrics.jsonl``, ``run_meta.json``); the port has no
wandb backend.
"""

from __future__ import annotations

import json
import logging
import pathlib
import time
from contextlib import contextmanager
from typing import Any, Dict, Optional

_FMT = "%(asctime)s %(levelname)s %(name)s: %(message)s"


def get_logger(name: str = "labelanything_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(_FMT, datefmt="%H:%M:%S"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


class ExperimentLogger:
    """Phase-namespaced metric logger with a JSONL sink."""

    def __init__(self, run_dir: str, name: str = "run"):
        self.run_dir = pathlib.Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.name = name
        self._prefix = ""
        # run-id resume (reference: logger/wandb.py:115-178): a stable id is
        # minted on first init and reused when the run dir already has one,
        # so resumed runs append to the same logical run
        meta_path = self.run_dir / "run_meta.json"
        if meta_path.exists():
            meta = json.loads(meta_path.read_text())
            self.run_id = meta["run_id"]
            self.resumed = True
        else:
            import uuid

            self.run_id = uuid.uuid4().hex[:8]
            self.resumed = False
            meta_path.write_text(json.dumps(
                {"run_id": self.run_id, "name": name, "created": time.time()}))
        self._sink = open(self.run_dir / "metrics.jsonl", "a")

    @contextmanager
    def phase(self, name: str):
        """Namespace metrics like the reference's train/validate/test
        contexts (wandb.py:949-981)."""
        old = self._prefix
        self._prefix = f"{name}/"
        try:
            yield self
        finally:
            self._prefix = old

    def log_metrics(self, metrics: Dict[str, Any], step: Optional[int] = None,
                    epoch: Optional[int] = None):
        record = {f"{self._prefix}{k}": _to_py(v) for k, v in metrics.items()}
        record["_time"] = time.time()
        if step is not None:
            record["_step"] = int(step)
        if epoch is not None:
            record["_epoch"] = int(epoch)
        self._sink.write(json.dumps(record) + "\n")
        self._sink.flush()

    def log_training_state(self, tag: str, epoch: int,
                           checkpoint_dir: str, **meta):
        """Record a checkpoint-save event (reference: wandb.py:935-944
        log_training_state saves accelerator state under files/best|latest;
        here the checkpoint is already on disk — this logs the pointer)."""
        self.log_metrics({
            f"checkpoint/{tag}": str(checkpoint_dir),
            f"checkpoint/{tag}_epoch": epoch,
            **{f"checkpoint/{tag}_{k}": v for k, v in meta.items()},
        })

    def close(self):
        if not self._sink.closed:
            self._sink.close()


def _to_py(v):
    try:
        import numpy as np

        if isinstance(v, (np.generic,)):
            return v.item()
        if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
            return float(v.item())
    except Exception:
        pass
    if isinstance(v, (list, tuple)):
        return [_to_py(x) for x in v]
    return v
