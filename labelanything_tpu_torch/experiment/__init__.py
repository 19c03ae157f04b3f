"""Training runs and grid experiments."""

from .run import Run
from .experiment import Experimenter, experiment, run as run_single

__all__ = ["Run", "Experimenter", "experiment", "run_single"]
