"""Episode-deterministic, thread-safe RNG for the data engine (a copy of
``labelanything_tpu/data/rng.py``).

The reference gets per-run reproducibility from torch DataLoader's
process-per-worker model: each worker owns a sequentially-consumed RNG
stream, so a run is deterministic given the worker assignment. Our loader
executes episode assembly on a thread pool (or process pool) whose
scheduling order is NOT deterministic — a single shared
``np.random.Generator`` would make reruns irreproducible (and its state is
mutated racily across threads).

``EpisodeRng`` makes every random draw a pure function of
``(base_seed, epoch, episode_index)``: the owning dataset calls
``begin_episode((epoch, idx))`` at the top of ``__getitem__`` (in whichever
worker thread runs it), which installs a thread-local Generator seeded by
the tuple. Example generators and prompts processors that were handed this
object keep working unchanged — attribute access (``integers``, ``choice``,
``permutation``, ...) delegates to the thread-local Generator.

This is stricter than the reference (episode content is reproducible even
under a different worker count / scheduling), which is what the seeded
validation rerun protocol needs (reference: experiment/run.py:618-641).
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import numpy as np


class EpisodeRng:
    """Thread-local numpy Generator facade keyed by (seed, episode)."""

    def __init__(self, seed: Optional[int] = None):
        self._base = seed
        self._local = threading.local()

    # -- lifecycle ------------------------------------------------------ #

    def reseed(self, seed: Optional[int]) -> None:
        """Restart the stream family (validation rerun protocol); clears any
        Generator already installed on the calling thread."""
        self._base = seed
        self._local.__dict__.clear()

    def begin_episode(self, key: Tuple[int, ...]) -> None:
        """Install this thread's Generator for one episode: seeded by
        (base, *key) when a base seed is set, fresh entropy otherwise."""
        if self._base is None:
            self._local.gen = np.random.default_rng()
        else:
            self._local.gen = np.random.default_rng((self._base,) + tuple(key))

    # -- delegation ----------------------------------------------------- #

    def _generator(self) -> np.random.Generator:
        gen = getattr(self._local, "gen", None)
        if gen is None:
            # outside episode scope (e.g. test-set prompt extraction on the
            # main thread): one lazily-created base-seeded stream
            gen = np.random.default_rng(self._base)
            self._local.gen = gen
        return gen

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._generator(), name)

    # -- pickling (process-pool workers) -------------------------------- #

    def __getstate__(self):
        return {"_base": self._base}

    def __setstate__(self, state):
        self._base = state["_base"]
        self._local = threading.local()
