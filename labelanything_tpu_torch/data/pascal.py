"""PASCAL VOC episodic datasets on embedding caches, a copy of
``labelanything_tpu/data/pascal.py`` (reference: label_anything/data/pascal.py
and pascal5i.py).

VOC has a class mask a pixel (no instances), so a class's prompt is its
binary mask, or a box or points taken from it. The ground truth is the
segmentation PNG (255 on borders -> IGNORE_INDEX). The masks are read by
``data/png.py`` (the JAX package reads them with PIL) and the caches by
``utils/safetensors.py``; the draws are the JAX package's, draw for draw,
from the same seed. Only the embeddings path is ported: without
``emb_dir`` an episode raises (the images path needs a JPEG decoder,
ROADMAP A10).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from ..typing import BatchKeys, BatchMetadataKeys, IGNORE_INDEX, PromptType
from ..utils.safetensors import load_file
from .coco import annotations_to_tensor
from .embeddings import embedding_from_file
from .examples import build_example_generator
from .png import read_png
from .rng import EpisodeRng
from .schema import flags_merge
from .transforms import PromptsProcessor, gt_to_input_frame

PASCAL_CATEGORIES = {
    i + 1: {"name": n} for i, n in enumerate([
        "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
        "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
        "pottedplant", "sheep", "sofa", "train", "tvmonitor",
    ])
}
PASCAL_IGNORE = 255


class PascalDataset:
    """(reference: pascal.py:34-534)."""

    def __init__(
        self,
        name: str = "pascal",
        data_dir: str = None,
        split: str = "train",
        emb_dir: Optional[str] = None,
        n_ways="max",
        image_size: int = 1024,
        load_embeddings: Optional[bool] = None,
        load_gts: bool = False,
        do_subsample: bool = True,
        remove_small_annotations: bool = False,
        all_example_categories: bool = True,
        num_samples: Optional[int] = None,
        sample_function: str = "power_law",
        custom_preprocess: bool = True,
        load_annotation_dicts: bool = True,
        seed: Optional[int] = None,
        **kwargs,
    ):
        if data_dir is None:
            # the JAX package joins None into its paths here (TypeError):
            # parameters/validation/Pascal/*.yaml give the reference's
            # instances_path / img_dir and no data_dir (ROADMAP C12)
            raise ValueError(
                f"dataset {name!r}: PascalDataset needs data_dir, the VOC "
                "root holding ImageSets/Segmentation and SegmentationClass "
                f"(got none; other keys: {sorted(kwargs)})")
        if load_embeddings is None:
            load_embeddings = emb_dir is not None
        self.name = name
        self.split = split
        self.data_dir = data_dir
        self.img_dir = os.path.join(data_dir, "JPEGImages")
        self.masks_dir = os.path.join(data_dir, "SegmentationClass")
        self.emb_dir = emb_dir
        self.n_ways = n_ways
        self.n_examples = None
        self.image_size = image_size
        self.load_embeddings = load_embeddings
        self.load_gts = load_gts
        self.do_subsample = do_subsample
        self.remove_small_annotations = remove_small_annotations
        self.all_example_categories = all_example_categories
        self.num_samples = num_samples
        self.sample_function = sample_function
        self.custom_preprocess = custom_preprocess
        self.rng = EpisodeRng(seed)
        self.categories = dict(PASCAL_CATEGORIES)

        split_file = os.path.join(data_dir, "ImageSets", "Segmentation",
                                  f"{split}.txt")
        self.image_names: List[str] = []
        with open(split_file) as f:
            for line in f:
                parts = line.strip().split()
                if not parts:
                    continue
                self.image_names.append(
                    os.path.splitext(os.path.basename(parts[0]))[0])
        self.image_names = list(dict.fromkeys(self.image_names))

        self.prompts_processor = PromptsProcessor(
            long_side_length=image_size, masks_side_length=256,
            custom_preprocess=custom_preprocess, rng=self.rng)

        if load_annotation_dicts:
            self.img2cat, self.cat2img = self._load_annotation_dicts()
            self._build_generator()
        else:
            self.img2cat = self.cat2img = None

    def _build_generator(self):
        self.example_generator = build_example_generator(
            n_ways=self.n_ways, n_shots=None,
            images_to_categories=self.img2cat,
            categories_to_imgs=self.cat2img,
            sample_function=self.sample_function, rng=self.rng)

    def reseed(self, seed: int) -> None:
        """Restart episode randomness (rerun protocol); the generator and
        the prompts processor share this EpisodeRng."""
        self.rng.reseed(seed)

    def _get_seg(self, image_name: str,
                 memo: Optional[Dict[str, np.ndarray]] = None) -> np.ndarray:
        """The class mask of an image, (H, W) int64; ``memo`` (one
        episode's, never stored on the dataset: episodes run on several
        threads) keeps each image decoded once an episode."""
        if memo is not None and image_name in memo:
            return memo[image_name]
        seg = read_png(os.path.join(self.masks_dir,
                                    image_name + ".png")).astype(np.int64)
        if self.remove_small_annotations:
            for cat_id in np.unique(seg):
                mask = seg == cat_id
                if mask.sum() < 2 * 32 * 32:
                    seg[mask] = 0
        if memo is not None:
            memo[image_name] = seg
        return seg

    def _load_annotation_dicts(self):
        img2cat: Dict[str, set] = {}
        cat2img: Dict[int, set] = {}
        for name in self.image_names:
            try:
                seg = self._get_seg(name)
            except FileNotFoundError:
                continue
            cats = [int(c) for c in np.unique(seg)
                    if c not in (0, PASCAL_IGNORE) and int(c) in self.categories]
            img2cat[name] = set(cats)
            for c in cats:
                cat2img.setdefault(c, set()).add(name)
        return img2cat, cat2img

    def _get_images_or_embeddings(self, image_names):
        """(embeddings (N, h, w, C) or stage dict, key, the caches'
        ``{name}_gt`` when ``load_gts``)."""
        if not self.load_embeddings:
            raise NotImplementedError(
                f"image {os.path.join(self.img_dir, image_names[0] + '.jpg')}"
                ": the port's episode engine reads embedding caches only "
                "(set emb_dir); the images path needs a JPEG decoder, which "
                "the port does not have yet (ROADMAP A10)")
        embs, gts = [], []
        for n in image_names:
            f = load_file(f"{self.emb_dir}/{n}.safetensors")
            e = embedding_from_file(f)
            embs.append({k: v.numpy() for k, v in e.items()}
                        if isinstance(e, dict) else e.numpy())
            gt = f.get(f"{self.name}_gt")
            gts.append(None if gt is None else gt.numpy())
        stacked = ({k: np.stack([e[k] for e in embs]) for k in embs[0]}
                   if isinstance(embs[0], dict) else np.stack(embs))
        return stacked, BatchKeys.EMBEDDINGS, gts if self.load_gts else None

    def _get_prompts(self, image_names, cat_ids, possible_prompt_types,
                     memo=None):
        """A class's prompt from its mask: the mask itself, its box, or 3
        points drawn in it, by the episode's prompt type."""
        if isinstance(possible_prompt_types, PromptType):
            possible_prompt_types = [possible_prompt_types]
        bboxes = [{c: [] for c in cat_ids} for _ in image_names]
        masks = [{c: [] for c in cat_ids} for _ in image_names]
        points = [{c: [] for c in cat_ids} for _ in image_names]
        classes: List[List[int]] = [[] for _ in image_names]
        img_sizes = []
        segs = [self._get_seg(n, memo) for n in image_names]
        for i, (name, seg) in enumerate(zip(image_names, segs)):
            img_sizes.append(seg.shape)
            for cat_id in cat_ids:
                if cat_id not in self.img2cat.get(name, ()):
                    continue
                classes[i].append(cat_id)
                class_mask = (seg == cat_id).astype(np.uint8)
                ptype = possible_prompt_types[
                    int(self.rng.integers(len(possible_prompt_types)))]
                if ptype == PromptType.MASK:
                    masks[i][cat_id].append(class_mask)
                elif ptype == PromptType.BBOX:
                    ys, xs = np.nonzero(class_mask)
                    bboxes[i][cat_id].append(
                        [float(xs.min()), float(ys.min()),
                         float(xs.max()) + 1, float(ys.max()) + 1])
                else:
                    for _ in range(3):
                        points[i][cat_id].append(
                            self.prompts_processor.sample_points(
                                class_mask, 1)[0])
        for i in range(len(image_names)):
            for c in cat_ids:
                bboxes[i][c] = np.asarray(bboxes[i][c], np.float64)
                masks[i][c] = np.asarray(masks[i][c])
                points[i][c] = np.asarray(points[i][c], np.float64)
        return bboxes, masks, points, classes, img_sizes

    def compute_ground_truths(self, image_names, cat_ids, memo=None):
        gts = []
        for name in image_names:
            seg = self._get_seg(name, memo)
            gt = np.zeros_like(seg, np.int32)
            for i, cat_id in enumerate(cat_ids):
                if cat_id == -1:
                    continue
                gt[seg == cat_id] = i
            gt[seg == PASCAL_IGNORE] = IGNORE_INDEX
            gts.append(gt)
        return gts

    def gt_to_input_frame(self, gt: np.ndarray) -> np.ndarray:
        return gt_to_input_frame(gt, self.image_size, self.custom_preprocess)

    def _extract_examples(self, image_name, num_examples, num_classes):
        img_cats = sorted(self.img2cat[image_name])
        sampled = (self.example_generator.sample_classes_from_query(img_cats)
                   if self.do_subsample else img_cats)
        if num_classes == "max":
            num_classes = None
        return self.example_generator.generate_examples(
            query_image_id=image_name, image_classes=img_cats,
            sampled_classes=sampled, num_examples=num_examples,
            num_classes=num_classes)

    def _episode(self, image_names, cat_ids, metadata) -> dict:
        """The episode dict of ``image_names`` (index 0 the query) over
        ``cat_ids`` (-1, the background, first)."""
        prompt_types = metadata[BatchMetadataKeys.PROMPT_TYPES]
        if metadata.get(BatchMetadataKeys.PROMPT_CHOICE_LEVEL) == "episode":
            prompt_types = prompt_types[int(self.rng.integers(len(prompt_types)))]
        images, image_key, _ = self._get_images_or_embeddings(image_names)
        memo: Dict[str, np.ndarray] = {}
        bboxes, masks, points, classes, img_sizes = self._get_prompts(
            image_names, cat_ids, prompt_types, memo)
        pad_n = metadata.get("pad_annotations_to")
        bboxes, flag_bboxes = annotations_to_tensor(
            self.prompts_processor, bboxes, img_sizes, PromptType.BBOX, pad_n)
        masks, flag_masks = annotations_to_tensor(
            self.prompts_processor, masks, img_sizes, PromptType.MASK)
        points, flag_points = annotations_to_tensor(
            self.prompts_processor, points, img_sizes, PromptType.POINT, pad_n)
        gts = self.compute_ground_truths(image_names, cat_ids, memo)
        ground_truths = np.stack([self.gt_to_input_frame(g) for g in gts])
        flag_examples = flags_merge(flag_masks, flag_points, flag_bboxes)
        return {
            image_key: images,
            BatchKeys.PROMPT_MASKS: masks,
            BatchKeys.FLAG_MASKS: flag_masks,
            BatchKeys.PROMPT_POINTS: points,
            BatchKeys.FLAG_POINTS: flag_points,
            BatchKeys.PROMPT_BBOXES: bboxes,
            BatchKeys.FLAG_BBOXES: flag_bboxes,
            BatchKeys.FLAG_EXAMPLES: flag_examples,
            BatchKeys.DIMS: np.asarray(img_sizes, np.int32),
            BatchKeys.CLASSES: classes,
            BatchKeys.IMAGE_IDS: image_names,
            BatchKeys.GROUND_TRUTHS: ground_truths,
        }

    def __getitem__(self, idx_metadata):
        idx, metadata = idx_metadata
        # the JAX package draws the episode-level prompt type first
        num_shots = metadata.get(BatchMetadataKeys.NUM_EXAMPLES) or 1
        prompt_types = metadata[BatchMetadataKeys.PROMPT_TYPES]
        if metadata.get(BatchMetadataKeys.PROMPT_CHOICE_LEVEL) == "episode":
            prompt_types = prompt_types[int(self.rng.integers(len(prompt_types)))]
        num_classes = metadata.get(BatchMetadataKeys.NUM_CLASSES, self.n_ways)

        query = self.image_names[idx % len(self.image_names)]
        while query not in self.img2cat:
            idx += 1
            query = self.image_names[idx % len(self.image_names)]
        image_names, aux_cats = self._extract_examples(query, num_shots,
                                                       num_classes)
        if self.all_example_categories:
            aux_cats = [aux_cats[0]] + [set(self.img2cat[n])
                                        for n in image_names[1:]]
        cat_ids = sorted(set().union(*aux_cats))
        cat_ids.insert(0, -1)
        metadata = {**metadata, BatchMetadataKeys.PROMPT_TYPES: prompt_types,
                    BatchMetadataKeys.PROMPT_CHOICE_LEVEL: "batch"}
        return self._episode(image_names, cat_ids, metadata)

    def __len__(self):
        return self.num_samples or len(self.image_names)


class Pascal5iDataset(PascalDataset):
    """PASCAL-5i folds (reference: pascal5i.py:14-180). A fold's categories
    are a contiguous block of 5: ``val_fold_idx * 5 + i``."""

    def __init__(self, val_fold_idx: int = 0, n_folds: int = 4, n_shots=None,
                 val_num_samples: int = 1000, *args, **kwargs):
        super().__init__(*args, load_annotation_dicts=False, **kwargs)
        assert self.split in ("train", "val")
        assert val_fold_idx < n_folds
        self.val_fold_idx = val_fold_idx
        self.n_folds = n_folds
        self.n_shots = n_shots
        self.val_num_samples = val_num_samples
        self._prepare_benchmark()

    def _prepare_benchmark(self):
        n_cat = len(self.categories)
        per_fold = n_cat // self.n_folds
        idxs_val = [self.val_fold_idx * per_fold + i for i in range(per_fold)]
        idxs = (idxs_val if self.split == "val"
                else [i for i in range(n_cat) if i not in idxs_val])
        self.categories = {
            k: v for i, (k, v) in enumerate(self.categories.items()) if i in idxs
        }
        self.img2cat, self.cat2img = self._load_annotation_dicts()
        self.img2cat = {k: {c for c in v if c in self.categories}
                        for k, v in self.img2cat.items()}
        self.img2cat = {k: v for k, v in self.img2cat.items() if v}
        self.cat2img = {c: v for c, v in self.cat2img.items()
                        if c in self.categories}
        # fold categories without an image in this split go
        self.categories = {k: v for k, v in self.categories.items()
                           if k in self.cat2img}
        self.image_names = sorted(self.img2cat.keys())
        self._build_generator()

    def __getitem__(self, idx_metadata):
        if self.split == "train" or self.n_shots == "min":
            return super().__getitem__(idx_metadata)
        _idx, metadata = idx_metadata
        n_ways = self.n_ways if isinstance(self.n_ways, int) else 1
        if n_ways == 1:
            cat = int(self.rng.choice(sorted(self.categories.keys())))
            cat_ids = [-1, cat]
            pool = sorted(self.cat2img[cat])
            sel = self.rng.choice(len(pool), self.n_shots + 1, replace=False)
            image_names = [pool[i] for i in sel]
        else:
            cats = [int(c) for c in self.rng.choice(
                sorted(self.categories.keys()), n_ways, replace=False)]
            pool0 = sorted(self.cat2img[cats[0]])
            image_names = [pool0[int(self.rng.integers(len(pool0)))]]
            for cat_id in cats:
                pool = sorted(self.cat2img[cat_id])
                sel = self.rng.choice(len(pool), self.n_shots, replace=False)
                image_names += [pool[i] for i in sel]
            cat_ids = [-1] + sorted(cats)
        return self._episode(image_names, cat_ids, metadata)

    def __len__(self):
        if self.split == "val":
            return self.val_num_samples
        return super().__len__()
