"""Test-protocol datasets on embedding caches (counterpart of
``labelanything_tpu/data/test.py``; reference: label_anything/data/test.py and
data/coco.py:650-870 CocoLVISTestDataset).

A test dataset yields one query image a item (its embedding and its ground
truth in the input frame) and gives, through ``extract_prompts()``, one
support batch that covers every category: ``generate_class_embeddings``
takes it once, then ``predict`` runs over the queries.

The class columns of the support batch are the background and then
``sorted(categories)``; the ground truth indexes the same columns, and
``num_classes`` counts them all, the background included, as the
cross-domain test sets count theirs. The JAX ``CocoLVISTestDataset``
indexes the ground truth by the categories that have an image and counts
its ``num_classes`` over those alone, the background not included
(ROADMAP C12).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..typing import BatchKeys, PromptType
from .coco import CocoLVISDataset, annotations_to_tensor
from .schema import flags_merge


class LabelAnythingTestDataset:
    """(reference: data/test.py:4-15)."""

    num_classes: int = 0

    def __getitem__(self, item):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def extract_prompts(self) -> Dict[str, np.ndarray]:
        raise NotImplementedError


class CocoLVISTestDataset(CocoLVISDataset, LabelAnythingTestDataset):
    """The whole-dataset test protocol: one support image a category
    (reference: coco.py:650-870)."""

    def __init__(self, name="coco", instances_path=None, img_dir=None,
                 emb_dir=None, load_embeddings=None, load_gts=False,
                 add_box_noise=False, support_params: Optional[dict] = None,
                 **kwargs):
        CocoLVISDataset.__init__(
            self, name=name, instances_path=instances_path, img_dir=img_dir,
            emb_dir=emb_dir, load_embeddings=load_embeddings, load_gts=load_gts,
            add_box_noise=add_box_noise, **kwargs)
        self.num_classes = len(self.categories) + 1
        self.class_ids = [-1] + sorted(self.categories)
        self.support_dataset = (
            CocoLVISDataset(**support_params) if support_params else self
        )

    def _extract_support_examples(self, cat2img, img2cat) -> List[int]:
        """One support image a category: the one with the most categories
        (reference: coco.py:683-694)."""
        prompt_images = set()
        categories = sorted(self.categories.keys())
        perm = self.rng.permutation(len(categories))
        for idx in perm:
            cat_id = categories[idx]
            if cat_id not in cat2img:
                continue
            _, img = max((len(img2cat[x]), x) for x in cat2img[cat_id])
            prompt_images.add(img)
        return sorted(prompt_images)

    def extract_prompts(self) -> Dict[str, np.ndarray]:
        """(reference: coco.py:710-760). The support batch (B = 1), its
        class axis the background and then ``sorted(categories)``."""
        sup = self.support_dataset
        image_ids = self._extract_support_examples(sup.cat2img, sup.img2cat)
        images, image_key, _ = sup._get_images_or_embeddings(image_ids)

        all_types = [PromptType.POINT, PromptType.BBOX, PromptType.MASK]
        bboxes, masks, points, _, img_sizes = sup._get_prompts(
            image_ids, self.class_ids[1:], all_types)
        bboxes, flag_bboxes = annotations_to_tensor(
            sup.prompts_processor, bboxes, img_sizes, PromptType.BBOX)
        masks, flag_masks = annotations_to_tensor(
            sup.prompts_processor, masks, img_sizes, PromptType.MASK)
        points, flag_points = annotations_to_tensor(
            sup.prompts_processor, points, img_sizes, PromptType.POINT)

        def with_bg(x, axis=1):
            pad = [(0, 0)] * x.ndim
            pad[axis] = (1, 0)
            return np.pad(x, pad)

        masks, flag_masks = with_bg(masks), with_bg(flag_masks)
        bboxes, flag_bboxes = with_bg(bboxes), with_bg(flag_bboxes)
        points, flag_points = with_bg(points), with_bg(flag_points)
        flag_examples = flags_merge(flag_masks, flag_points, flag_bboxes)
        return {
            image_key: images[None],
            BatchKeys.PROMPT_MASKS: masks[None],
            BatchKeys.FLAG_MASKS: flag_masks[None],
            BatchKeys.PROMPT_POINTS: points[None],
            BatchKeys.FLAG_POINTS: flag_points[None],
            BatchKeys.PROMPT_BBOXES: bboxes[None],
            BatchKeys.FLAG_BBOXES: flag_bboxes[None],
            BatchKeys.FLAG_EXAMPLES: flag_examples[None],
            BatchKeys.DIMS: np.asarray(img_sizes, np.int32)[None],
        }

    def __getitem__(self, item):
        """(reference: coco.py:820-846). One query image and its ground
        truth over the support batch's class columns."""
        image_id = self.image_ids[item]
        data, data_key, gts = self._get_images_or_embeddings([image_id])
        if gts is None:
            gt = self.compute_ground_truths([image_id], self.class_ids)[0]
        else:
            g = np.asarray(gts[0], np.int32)
            gt = np.zeros_like(g)
            for i, cat_id in enumerate(self.class_ids):
                if cat_id == -1:
                    continue
                gt[g == cat_id] = i
        dims = np.asarray(gt.shape, np.int32)
        return {data_key: data, "dims": dims,
                "gt": self.gt_to_input_frame(gt)}

    def collate_fn(self, batched_input):
        data_key = (BatchKeys.IMAGES if BatchKeys.IMAGES in batched_input[0]
                    else BatchKeys.EMBEDDINGS)
        images = np.stack([x[data_key] for x in batched_input])
        dims = np.stack([x["dims"] for x in batched_input])
        gt = np.stack([x["gt"] for x in batched_input])
        return {data_key: images, BatchKeys.DIMS: dims[:, None, :]}, gt

    def __len__(self):
        return len(self.image_ids)
