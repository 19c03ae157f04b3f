"""Multi-dataset union, batch collate and the variable episode sampler, a
copy of ``labelanything_tpu/data/dataset.py`` (reference:
label_anything/data/dataset.py). Of the datasets, COCO / LVIS, COCO-20i and
PASCAL VOC / PASCAL-5i are ported; of the test protocol's, COCO / LVIS
(``data/test.py``): the cross-domain sets raise until the port decodes
their images (ROADMAP A10, A11).

The collate pads the class and annotation axes to *bucketed* sizes (next
multiple of ``annotation_bucket``), as the JAX package does, so both
packages see the same batches; validity flags carry the raggedness.

Note: the reference's ``collate_example_flags`` (data/utils.py:404-410)
contains a latent shape bug (squeeze(dim=1) of a 1-D row); the behavioural
intent — zero-pad (M, C_old) example flags to (M, C) — is what is
implemented here.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..typing import BatchKeys, BatchMetadataKeys, PromptType
from .coco import CocoLVISDataset


def _round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


class _NotPorted:
    """Registry entry of a dataset the port does not have yet."""

    def __init__(self, name: str, missing: str):
        self.name = name
        self.missing = missing

    def __call__(self, *args, **kwargs):
        raise NotImplementedError(
            f"dataset {self.name!r} is not ported yet: {self.missing}")


def _registry():
    from .coco20i import Coco20iDataset
    from .pascal import Pascal5iDataset, PascalDataset

    return {
        "coco": CocoLVISDataset,
        "val_coco": CocoLVISDataset,
        "lvis": CocoLVISDataset,
        "val_lvis": CocoLVISDataset,
        "coco20i": Coco20iDataset,
        "val_coco20i": Coco20iDataset,
        "pascal": PascalDataset,
        "pascal5i": Pascal5iDataset,
        "val_pascal5i": Pascal5iDataset,
        **_EXTRA_DATASETS,
    }


# the cross-domain sets (JAX data/crossdomain.py) read JPEG, TIFF and RGB
# PNG images, which the port cannot decode yet
_CROSSDOMAIN_MISSING = ("data/crossdomain.py reads JPEG / TIFF / RGB PNG "
                        "images, and the port has no decoder for them "
                        "(ROADMAP A10, A11)")


def test_registry():
    """The test protocol's datasets by name (JAX ``Run.test``'s table;
    ``test_kvaris`` is the reference's typo, kept)."""
    from .test import CocoLVISTestDataset

    return {
        "test_coco": CocoLVISTestDataset,
        "test_lvis": CocoLVISTestDataset,
        **{name: _NotPorted(name, _CROSSDOMAIN_MISSING)
           for name in ("test_kvasir", "test_kvaris", "test_weedmap",
                        "test_brain", "test_dram")},
    }


_EXTRA_DATASETS: Dict[str, type] = {}


def register_dataset(name: str, cls) -> None:
    _EXTRA_DATASETS[name] = cls


def resolve_dataset(name: str):
    """Name resolution as in the reference dataloader factory
    (data/__init__.py:115-121): 'val_coco20i_N1K1' -> 'val_coco20i'."""
    registry = _registry()
    if name in registry:
        return registry[name]
    parts = name.split("_")
    for i in range(len(parts), 0, -1):
        candidate = "_".join(parts[:i])
        if candidate in registry:
            return registry[candidate]
    raise KeyError(f"Unknown dataset {name!r}; known: {sorted(registry)}")


class LabelAnythingDataset:
    """Union of episodic datasets (reference: dataset.py:31-235)."""

    def __init__(self, datasets_params: Dict[str, dict], common_params: dict,
                 annotation_bucket: int = 8):
        self.datasets = {
            name: resolve_dataset(name)(**{**common_params, **params})
            for name, params in datasets_params.items()
        }
        self.categories = {
            name: ds.categories for name, ds in self.datasets.items()
        }
        index = [
            (name, i)
            for name, ds in self.datasets.items()
            for i in range(len(ds))
        ]
        self.index = dict(enumerate(index))
        self.annotation_bucket = annotation_bucket

    def __len__(self):
        return sum(len(ds) for ds in self.datasets.values())

    def reseed(self, seed: int):
        """Reset every sub-dataset's episode rng (validation reruns)."""
        for ds in self.datasets.values():
            if hasattr(ds, "reseed"):
                ds.reseed(seed)
            elif hasattr(ds, "rng"):
                ds.rng = np.random.default_rng(seed)

    def set_epoch(self, epoch: int):
        """Mix the epoch into episode randomness so each training epoch
        re-draws prompts/examples (the reference gets this from stateful
        worker RNG streams; episode-keyed seeding needs the epoch
        explicitly)."""
        self._epoch = int(epoch)

    def __getitem__(self, idx_metadata):
        idx, batch_metadata = idx_metadata
        name, dataset_index = self.index[idx]
        ds = self.datasets[name]
        rng = getattr(ds, "rng", None)
        if hasattr(rng, "begin_episode"):
            # every draw for this episode becomes a pure function of
            # (seed, epoch, idx) — deterministic under any worker
            # scheduling (see data/rng.py)
            rng.begin_episode((getattr(self, "_epoch", 0), idx))
        return ds[(dataset_index, batch_metadata)], name

    def collate_fn(self, batched_input: List[Tuple[dict, str]]):
        """Pad episode items into one fixed-shape batch. Returns
        ((data_dict, ground_truths), dataset_names)."""
        items, dataset_names = zip(*batched_input)
        b = len(items)
        bucket = self.annotation_bucket

        max_classes = max(x[BatchKeys.PROMPT_MASKS].shape[1] for x in items)
        n_points = _round_up(
            max(x[BatchKeys.PROMPT_POINTS].shape[2] for x in items), bucket)
        n_boxes = _round_up(
            max(x[BatchKeys.PROMPT_BBOXES].shape[2] for x in items), bucket)

        def pad_stack(key, shape):
            """Write each item's (possibly smaller) array straight into a
            preallocated (B,)+shape buffer — the old pad_to-then-np.stack
            made TWO copies (+ an allocation) per item. Buffer assembly is
            ~33% of the single-worker loader profile (PERF.md round-5
            breakdown); this trims the prompt-tensor share of it
            (measured ~67 -> ~70 eps/s on the canonical microbench)."""
            out = np.zeros((b,) + shape, items[0][key].dtype)
            for i, x in enumerate(items):
                v = x[key]
                out[(i,) + tuple(slice(0, s) for s in v.shape)] = v
            return out

        n_imgs = items[0][BatchKeys.PROMPT_MASKS].shape[0]
        msl = items[0][BatchKeys.PROMPT_MASKS].shape[-1]

        batch: Dict[str, Any] = {}
        batch[BatchKeys.PROMPT_MASKS] = pad_stack(
            BatchKeys.PROMPT_MASKS, (n_imgs, max_classes, msl, msl))
        batch[BatchKeys.FLAG_MASKS] = pad_stack(
            BatchKeys.FLAG_MASKS, (n_imgs, max_classes))
        batch[BatchKeys.PROMPT_BBOXES] = pad_stack(
            BatchKeys.PROMPT_BBOXES, (n_imgs, max_classes, n_boxes, 4))
        batch[BatchKeys.FLAG_BBOXES] = pad_stack(
            BatchKeys.FLAG_BBOXES, (n_imgs, max_classes, n_boxes))
        batch[BatchKeys.PROMPT_POINTS] = pad_stack(
            BatchKeys.PROMPT_POINTS, (n_imgs, max_classes, n_points, 2))
        batch[BatchKeys.FLAG_POINTS] = pad_stack(
            BatchKeys.FLAG_POINTS, (n_imgs, max_classes, n_points))
        batch[BatchKeys.FLAG_EXAMPLES] = pad_stack(
            BatchKeys.FLAG_EXAMPLES, (n_imgs, max_classes))
        batch[BatchKeys.DIMS] = np.stack([x[BatchKeys.DIMS] for x in items])

        image_key = (BatchKeys.EMBEDDINGS if BatchKeys.EMBEDDINGS in items[0]
                     else BatchKeys.IMAGES)
        vals = [x[image_key] for x in items]
        if isinstance(vals[0], dict):  # pyramid caches stack per stage
            batch[image_key] = {k: np.stack([v[k] for v in vals])
                                for k in vals[0]}
        else:
            batch[image_key] = np.stack(vals)

        classes = [x[BatchKeys.CLASSES] for x in items]
        flag_gts = np.zeros((b, max_classes), bool)
        for i, x in enumerate(classes):
            flag_gts[i, : len(set(itertools.chain(*x))) + 1] = True
        batch[BatchKeys.FLAG_GTS] = flag_gts
        batch[BatchKeys.CLASSES] = classes
        batch[BatchKeys.IMAGE_IDS] = [x[BatchKeys.IMAGE_IDS] for x in items]

        ground_truths = np.stack([x[BatchKeys.GROUND_TRUTHS] for x in items])
        batch[BatchKeys.GROUND_TRUTHS] = ground_truths
        return (batch, ground_truths), dataset_names


def get_batch_metadata(
    dataset_len: int,
    possible_batch_example_nums: Sequence[Sequence[int]],
    possible_prompts: Sequence[PromptType],
    prompt_choice_level: str = "batch",
    num_processes: int = 1,
    rng: Optional[np.random.Generator] = None,
):
    """Sample the epoch's (batch_size, [num_classes], num_examples) schedule
    (reference: dataset.py:238-306). Each tuple is replicated
    ``num_processes`` times so every data-parallel rank sees the same shape."""
    rng = rng or np.random.default_rng()
    combs = [c for i in range(1, len(possible_prompts) + 1)
             for c in itertools.combinations(possible_prompts, i)]
    batch_sizes, examples_nums, prompt_types, num_classes = [], [], [], []
    # rank-replicated schedule: each rank consumes dataset_len/num_processes
    # episodes. A dataset smaller than the rank count must still schedule at
    # least ONE batch group — otherwise validation silently runs zero
    # episodes and reports all-zero metrics (episodes are then padded by
    # repetition in VariableBatchSampler.__iter__, torch DistributedSampler
    # semantics).
    remaining = dataset_len // num_processes
    if dataset_len > 0:
        remaining = max(remaining, 1)
    while remaining > 0:
        res = possible_batch_example_nums[
            int(rng.integers(len(possible_batch_example_nums)))]
        num_class = None
        if len(res) == 1:
            cur_bs, examples_num = res[0], None
        elif len(res) == 2:
            cur_bs, examples_num = res
        elif len(res) == 3:
            cur_bs, num_class, examples_num = res
        else:
            raise ValueError("Invalid batch metadata tuple")
        cur_bs = min(cur_bs, remaining)
        prompt_types.append(combs[int(rng.integers(len(combs)))])
        examples_nums.append(examples_num)
        batch_sizes.append(cur_bs)
        if num_class is not None:
            num_classes.append(num_class)
        remaining -= cur_bs

    rep = lambda lst: [v for tup in zip(*[lst] * num_processes) for v in tup]
    batch_sizes = rep(batch_sizes)
    metadata = {
        BatchMetadataKeys.NUM_EXAMPLES: rep(examples_nums),
        BatchMetadataKeys.PROMPT_TYPES: (
            combs if prompt_choice_level == "episode" else rep(prompt_types)),
    }
    if num_classes:
        metadata[BatchMetadataKeys.NUM_CLASSES] = rep(num_classes)
    return batch_sizes, metadata


class VariableBatchSampler:
    """Epoch scheduler over (batch_size, n_ways, n_shots) buckets
    (reference: dataset.py:309-439)."""

    def __init__(
        self,
        data_source,
        possible_batch_example_nums: Sequence[Sequence[int]],
        prompt_types: Optional[Sequence[PromptType]] = None,
        prompt_choice_level: str = "batch",
        shuffle: bool = False,
        num_processes: int = 1,
        num_steps: Optional[int] = None,
        seed: Optional[int] = None,
    ):
        self.data_source = data_source
        self.rng = np.random.default_rng(seed)
        prompt_types = list(prompt_types or
                            [PromptType.BBOX, PromptType.MASK, PromptType.POINT])
        self.prompt_choice_level = prompt_choice_level
        self.num_processes = num_processes
        self.batch_sizes, self.batch_metadata = get_batch_metadata(
            len(data_source), possible_batch_example_nums,
            possible_prompts=prompt_types,
            prompt_choice_level=prompt_choice_level,
            num_processes=num_processes, rng=self.rng,
        )
        if num_steps is not None:
            num_steps -= num_steps % num_processes
            self.batch_sizes = self.batch_sizes[:num_steps]
            self.batch_metadata = {
                k: (v[:num_steps] if self._per_batch(k, v) else v)
                for k, v in self.batch_metadata.items()
            }
        self.do_shuffle = shuffle

    def _per_batch(self, key, value) -> bool:
        """Whether a metadata entry holds one value per batch. At the
        "episode" level the prompt types are the one list of combinations
        every episode draws from: the JAX sampler truncates and permutes it
        like a per-batch list, which drops combinations and raises
        IndexError once an epoch has more batches than combinations."""
        return isinstance(value, list) and not (
            key == BatchMetadataKeys.PROMPT_TYPES
            and self.prompt_choice_level == "episode")

    def __len__(self):
        return len(self.batch_sizes)

    def reseed(self, seed: int):
        """Restart the schedule rng — validation reruns use seed = base + run
        (reference: experiment/run.py:618-641)."""
        self.rng = np.random.default_rng(seed)

    def shuffle(self):
        p = self.num_processes
        batches = self.batch_sizes[::p]
        meta = {k: (v[::p] if self._per_batch(k, v) else v)
                for k, v in self.batch_metadata.items()}
        order = self.rng.permutation(len(batches))
        rep = lambda lst: [v for tup in zip(*[lst] * p) for v in tup]
        self.batch_sizes = rep([batches[i] for i in order])
        self.batch_metadata = {
            k: (rep([v[i] for i in order]) if self._per_batch(k, v) else v)
            for k, v in meta.items()
        }

    def __iter__(self) -> Iterator[List[Tuple[int, dict]]]:
        if self.do_shuffle:
            self.shuffle()
            order = self.rng.permutation(len(self.data_source)).tolist()
        else:
            order = list(range(len(self.data_source)))
        # the rank-replicated schedule can need more episodes than the
        # dataset holds (dataset_len < num_processes): pad by repetition so
        # every rank still receives a full static-shape batch
        total_needed = sum(self.batch_sizes)
        if order and total_needed > len(order):
            reps = -(-total_needed // len(order))
            order = (order * reps)[:total_needed]
        indices = iter(order)
        for i, batch_size in enumerate(self.batch_sizes):
            if self.prompt_choice_level == "episode":
                metadata = {k: v[i] for k, v in self.batch_metadata.items()
                            if k != BatchMetadataKeys.PROMPT_TYPES}
                metadata[BatchMetadataKeys.PROMPT_TYPES] = self.batch_metadata[
                    BatchMetadataKeys.PROMPT_TYPES]
            else:
                metadata = {k: v[i] for k, v in self.batch_metadata.items()}
            metadata[BatchMetadataKeys.PROMPT_CHOICE_LEVEL] = self.prompt_choice_level
            batch = []
            try:
                while len(batch) < batch_size:
                    batch.append((next(indices), metadata))
            except StopIteration:
                if not batch:
                    return
            yield batch
