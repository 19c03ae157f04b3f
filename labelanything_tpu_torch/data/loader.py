"""Host episode loader with background prefetch, a copy of
``labelanything_tpu/data/loader.py`` (reference: data/__init__.py
get_dataloaders, dataloader.num_workers).

* thread mode (default): a thread pool assembles items;
* process mode (``use_processes=True``): episode assembly and collation run
  in spawned worker processes, which receive the pickled dataset once and
  return numpy batches; they never touch CUDA (the train loop moves each
  batch to the card).

Episode randomness is keyed by (seed, epoch, episode index)
(``data/rng.py``), so both modes give the same batches.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import queue
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Iterator, Optional

from .dataset import LabelAnythingDataset, VariableBatchSampler

_WORKER_DATASET = None


def _proc_init(pickled_dataset: bytes, worker_counter, base_seed) -> None:
    global _WORKER_DATASET
    _WORKER_DATASET = pickle.loads(pickled_dataset)
    # all workers share the SAME base seed: episode randomness is keyed by
    # (seed, epoch, episode_index) via EpisodeRng (data/rng.py), so draws
    # are identical no matter which worker assembles an episode — stricter
    # than the reference's per-worker streams, and what seeded validation
    # reruns need. The counter stays for workers to know their id.
    with worker_counter.get_lock():
        worker_counter.value += 1
    if base_seed is not None and hasattr(_WORKER_DATASET, "reseed"):
        _WORKER_DATASET.reseed(int(base_seed))


def _proc_collate(indices, epoch: int = 0) -> bytes:
    """Assemble + collate one batch inside the worker; returns the collated
    pytree (pickled implicitly by the executor)."""
    ds = _WORKER_DATASET
    if hasattr(ds, "set_epoch"):
        ds.set_epoch(epoch)
    return ds.collate_fn([ds[i] for i in indices])


class EpisodeLoader:
    def __init__(
        self,
        dataset: LabelAnythingDataset,
        batch_sampler: VariableBatchSampler,
        num_workers: int = 8,
        prefetch_batches: int = 2,
        use_processes: bool = False,
        seed: Optional[int] = None,
    ):
        """One collated batch for each batch of ``batch_sampler``, in its
        order. The JAX loader's options for batches of several ranks and
        hosts wait for the port's data parallelism (ROADMAP A12)."""
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.num_workers = max(1, num_workers)
        self.prefetch_batches = prefetch_batches
        self.use_processes = use_processes
        self.seed = seed
        self._epoch = 0
        self._pool: Optional[ProcessPoolExecutor] = None
        if seed is not None and hasattr(dataset, "reseed"):
            # thread mode draws from the dataset's own EpisodeRng: seed it
            # as the process workers are seeded, so that both modes give the
            # same episodes (the JAX loader leaves it unseeded in thread
            # mode, and a dataset without ``seed`` then draws from entropy)
            dataset.reseed(int(seed))

    def __len__(self):
        return len(self.batch_sampler)

    def updates_per_epoch(self, substitute: bool = True,
                          accumulate: bool = False) -> int:
        """Exact optimizer updates one epoch produces — the divisor for
        ``step_moment: epoch`` schedules (reference steps the scheduler once
        per epoch, experiment/utils.py:77-100). With substitution and no
        accumulation every pass updates (num_examples + 1 per batch); with
        accumulation (or substitute off) each batch updates once.
        Shuffling permutes but never changes the epoch's shape multiset, so
        this is constant across epochs."""
        n_batches = len(self)
        if accumulate or not substitute:
            return max(1, n_batches)
        from ..typing import BatchMetadataKeys as K

        examples = self.batch_sampler.batch_metadata.get(K.NUM_EXAMPLES)
        if not isinstance(examples, list):
            return max(1, n_batches)
        return max(1, sum((m or 1) + 1 for m in examples[:n_batches]))

    # ------------------------------------------------------------------ #

    def _process_pool(self) -> ProcessPoolExecutor:
        """Lazily started, reused across epochs (spawn cost ~seconds)."""
        if self._pool is None:
            ctx = multiprocessing.get_context("spawn")
            counter = ctx.Value("i", 0)
            # With seed=None every spawned worker would unpickle byte-identical
            # dataset RNG state and draw duplicate episode randomness; derive a
            # one-shot fallback so base+worker_id decorrelation always applies.
            seed = self.seed
            if seed is None:
                seed = int.from_bytes(os.urandom(4), "little")
            self._pool = ProcessPoolExecutor(
                self.num_workers,
                mp_context=ctx,
                initializer=_proc_init,
                initargs=(pickle.dumps(self.dataset), counter, seed),
            )
        return self._pool

    def reseed(self, seed: int) -> None:
        """Reseed the dataset for the seeded rerun protocol (reference:
        experiment/run.py:618-641 seed = base + run). In process mode the
        workers hold their own dataset copies, so the pool is torn down and
        respawned from the reseeded pickle on the next iteration."""
        self.seed = seed
        if hasattr(self.dataset, "reseed"):
            self.dataset.reseed(seed)
        if self._pool is not None:
            self.close()

    def set_epoch(self, epoch: int) -> None:
        """Propagate the epoch into episode seeding (data/rng.py). Process
        workers receive it with each submitted batch, so no respawn."""
        self._epoch = int(epoch)
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(cancel_futures=True)
            self._pool = None

    def __del__(self):  # best-effort; Run/Experimenter also close explicitly
        try:
            self.close()
        except Exception:
            pass

    def _iter_processes(self) -> Iterator:
        pool = self._process_pool()
        pending = []
        window = self.num_workers + self.prefetch_batches
        for batch in self.batch_sampler:
            pending.append(pool.submit(_proc_collate, batch, self._epoch))
            while len(pending) >= window:
                yield pending.pop(0).result()
        for fut in pending:
            yield fut.result()

    def _iter_threads(self) -> Iterator:
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_batches)
        stop = threading.Event()

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for batch in self.batch_sampler:
                        if stop.is_set():
                            return
                        items = list(pool.map(self.dataset.__getitem__, batch))
                        out_q.put(("item", self.dataset.collate_fn(items)))
            except BaseException as exc:  # propagate to consumer
                out_q.put(("error", exc))
                return
            out_q.put(("done", None))

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                kind, value = out_q.get()
                if kind == "done":
                    return
                if kind == "error":
                    raise value
                yield value
        finally:
            stop.set()
            # drain so the producer can exit
            while thread.is_alive():
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    break

    def __iter__(self) -> Iterator:
        if self.use_processes:
            yield from self._iter_processes()
        else:
            yield from self._iter_threads()
