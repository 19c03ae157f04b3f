"""COCO-20i few-shot benchmark dataset, a copy of
``labelanything_tpu/data/coco20i.py`` over the port's ``CocoLVISDataset``
(reference: label_anything/data/coco20i.py).

Fold split: validation categories are those at indices
``val_fold_idx + i * n_folds``; train keeps the rest. Validation episodes are
random N-way K-shot samples (1000 by default) with per-class support images.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..typing import AnnFileKeys, BatchKeys, BatchMetadataKeys, PromptType
from .coco import CocoLVISDataset, annotations_to_tensor, load_instances
from .examples import build_example_generator
from .schema import flags_merge


class Coco20iDataset(CocoLVISDataset):
    def __init__(self, split: str = "train", val_fold_idx: int = 0,
                 n_folds: int = 4, n_shots=None, val_num_samples: int = 1000,
                 *args, **kwargs):
        super().__init__(*args, **kwargs)
        assert split in ("train", "val")
        assert val_fold_idx < n_folds
        assert split == "train" or n_shots is not None or self.n_examples is not None
        assert n_shots != "min" or self.n_ways == "max"
        self.split = split
        self.val_fold_idx = val_fold_idx
        self.n_folds = n_folds
        self.n_shots = n_shots
        self.val_num_samples = val_num_samples
        self._prepare_benchmark()

    def _prepare_benchmark(self):
        """(reference: coco20i.py:63-109)."""
        n_categories = len(self.categories)
        idxs_val = [self.val_fold_idx + i * self.n_folds
                    for i in range(n_categories // self.n_folds)]
        idxs = (idxs_val if self.split == "val"
                else [i for i in range(n_categories) if i not in idxs_val])
        self.categories = {
            k: v for i, (k, v) in enumerate(self.categories.items()) if i in idxs
        }
        (self.img_annotations, self.img2cat, self.img2cat_annotations,
         self.cat2img, self.cat2img_annotations) = self._load_annotation_dicts()
        instances = load_instances(self.instances_path)
        img2cat_keys = set(self.img2cat.keys())
        self.images = {x[AnnFileKeys.ID]: x for x in instances[AnnFileKeys.IMAGES]
                       if x[AnnFileKeys.ID] in img2cat_keys}
        self.image_ids = list(self.images.keys())
        self.example_generator = build_example_generator(
            n_ways=self.n_ways, n_shots=self.n_shots,
            categories_to_imgs=self.cat2img,
            images_to_categories=self.img2cat, rng=self.rng,
        )

    def __getitem__(self, idx_metadata):
        """Train split keeps the episodic COCO protocol; val split samples
        N-way K-shot episodes (reference: coco20i.py:111-214)."""
        if (self.split == "train" or self.n_shots == "min"
                or self.n_examples is not None):
            return super().__getitem__(idx_metadata)

        idx, metadata = idx_metadata
        n_imgs = self.n_ways * self.n_shots + 1
        intended_classes = [[] for _ in range(n_imgs)]
        if self.n_ways == 1:
            cat = int(self.rng.choice(sorted(self.categories.keys())))
            cat_ids = [-1, cat]
            pool = sorted(self.cat2img[cat])
            sel = self.rng.choice(len(pool), self.n_shots + 1, replace=False)
            image_ids = [pool[i] for i in sel]
            for i in range(self.n_shots + 1):
                intended_classes[i].append(cat)
        else:
            cats = [int(c) for c in self.rng.choice(
                sorted(self.categories.keys()), self.n_ways, replace=False)]
            query_pool = sorted(self.cat2img[cats[0]])
            query_image_id = query_pool[int(self.rng.integers(len(query_pool)))]
            intended_classes[0].append(cats[0])
            image_ids = [query_image_id]
            for cat_id in cats:
                pool = sorted(self.cat2img[cat_id])
                sel = self.rng.choice(len(pool), self.n_shots, replace=False)
                for i in range(len(image_ids), len(image_ids) + self.n_shots):
                    intended_classes[i].append(cat_id)
                image_ids += [pool[i] for i in sel]
            cat_ids = [-1] + sorted(cats)

        images, image_key, precomputed_gts = self._get_images_or_embeddings(image_ids)
        prompt_types = metadata[BatchMetadataKeys.PROMPT_TYPES]
        if metadata.get(BatchMetadataKeys.PROMPT_CHOICE_LEVEL) == "episode":
            prompt_types = prompt_types[int(self.rng.integers(len(prompt_types)))]
        bboxes, masks, points, classes, img_sizes = self._get_prompts(
            image_ids, cat_ids, prompt_types)

        pad_n = metadata.get("pad_annotations_to")
        bboxes, flag_bboxes = annotations_to_tensor(
            self.prompts_processor, bboxes, img_sizes, PromptType.BBOX, pad_n)
        masks, flag_masks = annotations_to_tensor(
            self.prompts_processor, masks, img_sizes, PromptType.MASK)
        points, flag_points = annotations_to_tensor(
            self.prompts_processor, points, img_sizes, PromptType.POINT, pad_n)

        if precomputed_gts is not None:
            gts = []
            for g in precomputed_gts:
                out = np.zeros_like(np.asarray(g, np.int32))
                for i, cat_id in enumerate(cat_ids):
                    if cat_id == -1:
                        continue
                    out[np.asarray(g) == cat_id] = i
                gts.append(out)
        else:
            gts = self.compute_ground_truths(image_ids, cat_ids)
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
            BatchKeys.INTENDED_CLASSES: intended_classes,
            BatchKeys.IMAGE_IDS: image_ids,
            BatchKeys.GROUND_TRUTHS: ground_truths,
        }

    def __len__(self):
        if self.split == "val":
            return self.val_num_samples
        return super().__len__()
