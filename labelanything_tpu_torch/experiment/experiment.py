"""Grid-search experiment orchestration (counterpart of
``labelanything_tpu/experiment/experiment.py``; reference:
label_anything/experiment/experiment.py).

A parameter YAML expands (``utils/config.expand_experiment``) into run
configs; the ``Experimenter`` executes them one after another with the
reference's crash-continue semantics (experiment.py:247-279
``continue_with_errors``). The JAX package's parallel fan-out
(``experiment/parallel.py``) is not ported.
"""

from __future__ import annotations

import pathlib
import traceback
from typing import Any, Dict, List, Union

import torch

from ..utils.config import expand_experiment, load_yaml
from ..utils.logging import get_logger
from .run import Run

logger = get_logger(__name__)


class Experimenter:
    def __init__(self, config: Dict[str, Any], out_dir: str = "runs",
                 device: Union[str, torch.device] = "cuda"):
        self.settings = config.get("experiment", {})
        self.config = config
        self.out_dir = pathlib.Path(out_dir)
        self.device = device
        self.runs: List[dict] = expand_experiment(config)

    def execute_runs(self, start_from_run: int = 0):
        continue_with_errors = self.settings.get("continue_with_errors", False)
        start = max(start_from_run, self.settings.get("start_from_run", 0))
        results = []
        for i, run_params in enumerate(self.runs):
            if i < start:
                continue
            run_dir = self.out_dir / f"run{i}"
            logger.info("=== run %d/%d -> %s", i, len(self.runs) - 1, run_dir)
            try:
                run = Run().init(run_params, run_dir=str(run_dir),
                                 device=self.device)
                best = run.launch()
                results.append({"run": i, "best": best})
            except Exception as exc:  # noqa: BLE001 - crash-continue semantics
                logger.error("run %d failed: %s", i, exc)
                traceback.print_exc()
                if not continue_with_errors:
                    raise
                results.append({"run": i, "error": str(exc)})
        return results


def experiment(param_path: str, out_dir: str = "runs",
               device: Union[str, torch.device] = "cuda"):
    """(reference: experiment.py:343-377)."""
    return Experimenter(load_yaml(param_path), out_dir=out_dir,
                        device=device).execute_runs()


def run(param_path: str, out_dir: str = "runs",
        device: Union[str, torch.device] = "cuda"):
    """Execute the first grid point of a parameter file (reference:
    experiment.py:380-386)."""
    config = load_yaml(param_path)
    params = config.get("parameters", config)
    flat = expand_experiment({"parameters": params})[0]
    return Run().init(flat, run_dir=out_dir, device=device).launch()
