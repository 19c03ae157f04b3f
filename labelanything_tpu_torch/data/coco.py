"""COCO / LVIS episodic datasets on embedding caches or image folders
(counterpart of ``labelanything_tpu/data/coco.py``; reference:
label_anything/data/coco.py).

The JAX package's episode assembly in numpy, draw for draw: the example
generators choose support images and classes, a prompt modality is sampled
per annotation, annotations become padded prompt tensors, ground truths are
rasterized and nearest-resized into the ``image_size`` input frame with
IGNORE_INDEX fill. Three parts differ: polygons are filled by
``data/rle.py`` (Pillow's fill in numpy), the caches are read by
``utils/safetensors.py`` and images (``img_dir`` without ``emb_dir``) are
decoded by ``data/image_io.py``. An image episode carries its pixels as
the JAX uint8 ingest does (``device_normalize=True`` there): resized and
padded (S, S, 3) uint8 with ``DIMS`` and ``RESIZED_DIMS``, normalized on
the card by the model (``ops/image_norm.py``).
"""

from __future__ import annotations

import itertools
import json
import random
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..typing import AnnFileKeys, BatchKeys, BatchMetadataKeys, IGNORE_INDEX, PromptType
from ..utils.safetensors import load_file
from .embeddings import embedding_from_file
from .examples import build_example_generator
from .rng import EpisodeRng
from .schema import flags_merge
from .transforms import (PromptsProcessor, get_preprocess_shape,
                         gt_to_input_frame as gt_to_input_frame_np,
                         image_frames, nearest_index_map, resized_dims)


def load_instances(path: str) -> dict:
    """(reference: data/utils.py:155-171)."""
    import glob as globlib

    if "*" in str(path):
        instances: dict = {}
        for file in globlib.glob(str(path)):
            with open(file) as f:
                part = json.load(f)
            for k, v in part.items():
                if isinstance(v, list) and k in instances:
                    instances[k].extend(v)
                else:
                    instances[k] = v
        return instances
    with open(path) as f:
        return json.load(f)


def get_max_annotations(annotations: List[Dict[int, np.ndarray]]) -> int:
    return max(
        (ann[cat].shape[0] for ann in annotations for cat in ann if ann[cat].size),
        default=1,
    )


def annotations_to_tensor(
    prompts_processor: PromptsProcessor,
    annotations: List[Dict[int, np.ndarray]],
    img_sizes: List[Tuple[int, int]],
    prompt_type: PromptType,
    pad_annotations_to: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pad per-(image, class) prompt lists into dense arrays
    (reference: data/utils.py:185-245). ``pad_annotations_to`` lets the
    collate bucket the annotation axis for shape-stable compilation."""
    n = len(annotations)
    c = len(annotations[0])
    if prompt_type == PromptType.MASK:
        msl = prompts_processor.masks_side_length
        # uint8, not the reference's float32: prompt masks are binary by
        # construction (apply_masks nearest-resizes 0/1 masks), the model
        # casts to its compute dtype on device, and the fp32 convention
        # cost 4x the bytes in collate-stack + host->device transfer
        # (measured 19 -> 5 ms/batch of collate on the profile box)
        tensor = np.zeros((n, c, msl, msl), np.uint8)
        flag = np.zeros((n, c), np.int32)
        for i, annotation in enumerate(annotations):
            for j, cat_id in enumerate(annotation):
                mask = prompts_processor.apply_masks(list(annotation[cat_id]))
                tensor[i, j] = mask
                flag[i, j] = 1 if mask.any() else 0
        return tensor, flag

    max_ann = get_max_annotations(annotations)
    if pad_annotations_to:
        max_ann = max(max_ann, pad_annotations_to)
    last = 4 if prompt_type == PromptType.BBOX else 2
    tensor = np.zeros((n, c, max_ann, last), np.float32)
    flag = np.zeros((n, c, max_ann), np.int32)
    for i, (annotation, img_size) in enumerate(zip(annotations, img_sizes)):
        for j, cat_id in enumerate(annotation):
            if annotation[cat_id].size == 0:
                continue
            m = annotation[cat_id].shape[0]
            if prompt_type == PromptType.BBOX:
                tensor[i, j, :m] = prompts_processor.apply_boxes(
                    annotation[cat_id], img_size)
            else:
                tensor[i, j, :m] = prompts_processor.apply_coords(
                    np.asarray(annotation[cat_id], np.float64), img_size)
            flag[i, j, :m] = 1
    return tensor, flag


class CocoLVISDataset:
    """Episodic dataset (reference: data/coco.py:41-647)."""

    def __init__(
        self,
        name: str = "coco",
        instances_path: str = None,
        img_dir: Optional[str] = None,
        emb_dir: Optional[str] = None,
        max_points_per_annotation: int = 10,
        max_points_annotations: int = 50,
        n_ways="max",
        n_shots: Optional[int] = None,
        n_examples: Optional[int] = None,
        num_samples: Optional[int] = None,
        class_based_sampling: bool = False,
        image_size: int = 1024,
        load_embeddings: Optional[bool] = None,
        load_gts: bool = False,
        do_subsample: bool = True,
        add_box_noise: bool = True,
        remove_small_annotations: bool = False,
        all_example_categories: bool = True,
        sample_function: str = "power_law",
        custom_preprocess: bool = True,
        seed: Optional[int] = None,
    ):
        if load_embeddings is None:
            load_embeddings = emb_dir is not None
        assert not load_gts or emb_dir is not None
        assert n_examples is None or n_shots is None

        self.name = name
        # read again by Coco20iDataset._prepare_benchmark; the JAX package
        # does not keep it, so its COCO-20i datasets raise AttributeError
        self.instances_path = instances_path
        self.img_dir = img_dir
        self.emb_dir = emb_dir
        self.load_embeddings = load_embeddings
        self.load_gts = load_gts
        self.max_points_per_annotation = max_points_per_annotation
        self.max_points_annotations = max_points_annotations
        self.do_subsample = do_subsample
        self.add_box_noise = add_box_noise
        self.n_ways = n_ways
        self.n_shots = n_shots
        self.n_examples = n_examples
        self.num_samples = num_samples
        self.class_based_sampling = class_based_sampling
        self.image_size = image_size
        self.remove_small_annotations = remove_small_annotations
        self.all_example_categories = all_example_categories
        self.sample_function = sample_function
        self.custom_preprocess = custom_preprocess
        self.rng = EpisodeRng(seed)

        instances = load_instances(instances_path)
        self.annotations = {x[AnnFileKeys.ID]: x
                            for x in instances[AnnFileKeys.ANNOTATIONS]}
        self.categories = {x[AnnFileKeys.ID]: x
                           for x in instances[AnnFileKeys.CATEGORIES]}

        (self.img_annotations, self.img2cat, self.img2cat_annotations,
         self.cat2img, self.cat2img_annotations) = self._load_annotation_dicts()

        img2cat_keys = set(self.img2cat.keys())
        self.images = {x[AnnFileKeys.ID]: x for x in instances[AnnFileKeys.IMAGES]
                       if x[AnnFileKeys.ID] in img2cat_keys}
        self.image_ids = list(self.images.keys())

        self.example_generator = build_example_generator(
            n_ways=self.n_ways,
            n_shots=None,
            images_to_categories=self.img2cat,
            categories_to_imgs=self.cat2img,
            sample_function=self.sample_function,
            rng=self.rng,
        )
        self.prompts_processor = PromptsProcessor(
            long_side_length=self.image_size,
            masks_side_length=256,
            custom_preprocess=custom_preprocess,
            rng=self.rng,
        )

    def reseed(self, seed: int) -> None:
        """Restart episode randomness from ``seed`` (validation rerun
        protocol, reference: experiment/run.py:618-641). The example
        generator and prompts processor share the same EpisodeRng object,
        so reseeding in place reaches every consumer."""
        self.rng.reseed(seed)

    # -- indexes --------------------------------------------------------- #

    def _keep_annotation(self, ann) -> bool:
        if self.remove_small_annotations and ann.get("area", 1e9) < 2 * 32 * 32:
            return False
        if ann.get(AnnFileKeys.ISCROWD, 0) == 1:
            return False
        return ann[AnnFileKeys.CATEGORY_ID] in self.categories

    def _load_annotation_dicts(self):
        """(reference: coco.py:179-254)."""
        img_annotations: Dict = {}
        img2cat: Dict[int, Set[int]] = {}
        img2cat_annotations: Dict = {}
        cat2img: Dict[int, Set[int]] = {}
        cat2img_annotations: Dict = {}
        for ann in self.annotations.values():
            if not self._keep_annotation(ann):
                continue
            img_id = ann[AnnFileKeys.IMAGE_ID]
            cat_id = ann[AnnFileKeys.CATEGORY_ID]
            img_annotations.setdefault(img_id, []).append(ann)
            img2cat_annotations.setdefault(img_id, {}).setdefault(cat_id, []).append(ann)
            img2cat.setdefault(img_id, set()).add(cat_id)
            cat2img_annotations.setdefault(cat_id, {}).setdefault(img_id, []).append(ann)
            cat2img.setdefault(cat_id, set()).add(img_id)
        return (img_annotations, img2cat, img2cat_annotations, cat2img,
                cat2img_annotations)

    # -- IO --------------------------------------------------------------- #

    def _load_safe(self, img_data: dict):
        """Load a per-image embedding cache (``{id:012d}.safetensors``, as
        ``preprocess`` writes it), returned channels-last as numpy arrays
        (reference: coco.py:251-276 stores CxHxW). Pyramid caches come back
        as stage dicts."""
        f = load_file(
            f"{self.emb_dir}/{str(img_data[AnnFileKeys.ID]).zfill(12)}.safetensors"
        )
        embedding = embedding_from_file(f)
        if isinstance(embedding, dict):
            embedding = {k: v.numpy() for k, v in embedding.items()}
        else:
            embedding = embedding.numpy()
        gt = f.get(f"{self.name}_gt") if self.load_gts else None
        return embedding, None if gt is None else gt.numpy()

    def _image_path(self, img_data: dict) -> str:
        """The image file of ``img_data`` (JAX ``_load_image`` opens it)."""
        if self.img_dir is None:
            raise FileNotFoundError(
                "img_dir not provided (images are not downloaded)")
        return f"{self.img_dir}/{img_data['file_name']}"

    def _get_images_or_embeddings(self, image_ids):
        if not self.load_embeddings:
            paths = [self._image_path(self.images[i]) for i in image_ids]
            return (image_frames(paths, self.image_size,
                                 self.custom_preprocess),
                    BatchKeys.IMAGES, None)
        pairs = [self._load_safe(self.images[i]) for i in image_ids]
        embeddings, gts = zip(*pairs)
        if isinstance(embeddings[0], dict):
            stacked = {k: np.stack([e[k] for e in embeddings])
                       for k in embeddings[0]}
        else:
            stacked = np.stack(embeddings)
        return (stacked, BatchKeys.EMBEDDINGS,
                None if not self.load_gts else gts)

    # -- episode assembly -------------------------------------------------- #

    def _extract_examples(self, img_data, num_shots, num_examples, num_classes,
                          img_cats=None):
        """(reference: coco.py:316-362)."""
        if img_cats is None:
            img_cats = list(self.img2cat[img_data[AnnFileKeys.ID]])
        if num_classes == "max":
            # "max" n_ways means unconstrained class count -> the
            # frequency-sampling path (the reference would crash here if a
            # 2-tuple batch config met n_ways="max"; normalized explicitly)
            num_classes = None
        if num_examples is None:
            sampled_classes = (
                self.example_generator.sample_classes_from_query(img_cats)
                if self.do_subsample else img_cats
            )
            num_examples = num_shots
        else:
            perm = self.rng.permutation(len(img_cats))[:num_classes]
            sampled_classes = [img_cats[i] for i in perm]
            if len(sampled_classes) < (num_classes or 0):
                pool = sorted(set(self.categories.keys()) - set(sampled_classes))
                extra = self.rng.choice(len(pool),
                                        num_classes - len(sampled_classes),
                                        replace=False)
                sampled_classes += [pool[i] for i in extra]
            num_classes = None
        return self.example_generator.generate_examples(
            query_image_id=img_data[AnnFileKeys.ID],
            image_classes=img_cats,
            sampled_classes=sampled_classes,
            num_examples=num_examples,
            num_classes=num_classes,
        )

    def _sample_num_points(self, image_id: int, ann: dict) -> int:
        """Area-proportional Poisson point count (reference: coco.py:364-382)."""
        image_area = self.images[image_id]["height"] * self.images[image_id]["width"]
        annotation_area = ann["area"] / image_area
        poisson_mean = self.max_points_per_annotation * np.sqrt(annotation_area)
        return int(np.clip(self.rng.poisson(poisson_mean) + 1, 1,
                           self.max_points_per_annotation))

    def _ann_mask(self, ann, h: int, w: int,
                  memo: Optional[Dict[int, np.ndarray]] = None) -> np.ndarray:
        """convert_mask with a per-episode memo: the same annotation is
        rasterized by BOTH the prompt path (_get_prompts, mask/point types)
        and the GT path (compute_ground_truths), so without the memo most
        segmentations were decoded twice per episode. The memo dict is
        created in __getitem__ and threaded through explicitly (NOT stored
        on self — __getitem__ runs concurrently on loader threads); callers
        never mutate the returned mask, and a mask is a pure function of
        the annotation, so sharing is exact."""
        if memo is None:
            return self.prompts_processor.convert_mask(
                ann[AnnFileKeys.SEGMENTATION], h, w)
        key = ann[AnnFileKeys.ID]
        m = memo.get(key)
        if m is None:
            m = self.prompts_processor.convert_mask(
                ann[AnnFileKeys.SEGMENTATION], h, w)
            memo[key] = m
        return m

    def _get_prompts(self, image_ids, cat_ids, possible_prompt_types,
                     memo=None):
        """(reference: coco.py:398-474)."""
        if isinstance(possible_prompt_types, PromptType):
            possible_prompt_types = [possible_prompt_types]
        bboxes = [{c: [] for c in cat_ids} for _ in image_ids]
        masks = [{c: [] for c in cat_ids} for _ in image_ids]
        points = [{c: [] for c in cat_ids} for _ in image_ids]
        classes: List[List[int]] = [[] for _ in image_ids]
        img_sizes = [(self.images[i]["height"], self.images[i]["width"])
                     for i in image_ids]

        for i, (img_id, img_size) in enumerate(zip(image_ids, img_sizes)):
            for cat_id in cat_ids:
                if cat_id not in self.img2cat_annotations.get(img_id, {}):
                    continue
                classes[i].append(cat_id)
                anns = self.img2cat_annotations[img_id][cat_id]
                if len(anns) > self.max_points_annotations:
                    prompt_types = [PromptType.MASK] * len(anns)
                else:
                    prompt_types = [
                        possible_prompt_types[
                            int(self.rng.integers(len(possible_prompt_types)))]
                        for _ in anns
                    ]
                for ann, ptype in zip(anns, prompt_types):
                    if ptype == PromptType.BBOX:
                        bboxes[i][cat_id].append(self.prompts_processor.convert_bbox(
                            ann["bbox"], *img_size, noise=self.add_box_noise))
                    elif ptype == PromptType.MASK:
                        masks[i][cat_id].append(
                            self._ann_mask(ann, *img_size, memo=memo))
                    else:
                        mask = self._ann_mask(ann, *img_size, memo=memo)
                        points[i][cat_id].extend(
                            self.prompts_processor.sample_points(
                                mask, self._sample_num_points(img_id, ann)))

        for i in range(len(image_ids)):
            for cat_id in cat_ids:
                bboxes[i][cat_id] = np.asarray(bboxes[i][cat_id], np.float64)
                # masks stay a LIST of full-res instance masks: stacking
                # them here copied every mask once, and apply_masks gathers
                # each instance at msl**2 without ever needing the stack
                points[i][cat_id] = np.asarray(points[i][cat_id], np.float64)
        return bboxes, masks, points, classes, img_sizes

    def compute_ground_truths(self, image_ids, cat_ids,
                              memo=None) -> List[np.ndarray]:
        """(reference: coco.py:514-543)."""
        gts = []
        cat_index = {c: i for i, c in enumerate(cat_ids)}
        for image_id in image_ids:
            img_size = (self.images[image_id]["height"],
                        self.images[image_id]["width"])
            gt = np.zeros(img_size, np.int32)
            for ann in self.img_annotations[image_id]:
                cat = ann[AnnFileKeys.CATEGORY_ID]
                if cat not in cat_index:
                    continue
                mask = self._ann_mask(ann, *img_size, memo=memo)
                gt[mask != 0] = cat_index[cat]
            gts.append(gt)
        return gts

    def compute_ground_truths_input_frame(self, image_ids, cat_ids,
                                          memo=None) -> np.ndarray:
        """compute_ground_truths + gt_to_input_frame in one pass per image,
        into one (N, S, S) int32 buffer."""
        s = self.image_size
        cat_index = {c: i for i, c in enumerate(cat_ids)}
        out = np.full((len(image_ids), s, s), IGNORE_INDEX, np.int32)
        for j, image_id in enumerate(image_ids):
            h = self.images[image_id]["height"]
            w = self.images[image_id]["width"]
            if self.custom_preprocess:
                nh, nw = get_preprocess_shape(h, w, s)
            else:
                nh, nw = s, s
            gt = np.zeros((h, w), np.int32)
            for ann in self.img_annotations[image_id]:
                cat = ann[AnnFileKeys.CATEGORY_ID]
                if cat not in cat_index:
                    continue
                mask = self._ann_mask(ann, h, w, memo=memo)
                gt[mask != 0] = cat_index[cat]
            if (nh, nw) == (h, w):
                # identity resize (long side already == frame): the gather
                # maps are arange, so skip the fancy-index pass
                out[j, :nh, :nw] = gt
            else:
                out[j, :nh, :nw] = gt[np.ix_(nearest_index_map(h, nh),
                                             nearest_index_map(w, nw))]
        return out

    def gt_to_input_frame(self, gt: np.ndarray) -> np.ndarray:
        """Nearest-resize GT into the padded input frame, IGNORE_INDEX fill
        (the shared gather transform, transforms.gt_to_input_frame)."""
        return gt_to_input_frame_np(gt, self.image_size,
                                    self.custom_preprocess)

    def __getitem__(self, idx_metadata) -> dict:
        """(reference: coco.py:546-644). Returns the episode dict with the
        full N-image axis (index 0 = query) on all prompt tensors."""
        idx, batch_metadata = idx_metadata
        num_shots = batch_metadata.get(BatchMetadataKeys.NUM_EXAMPLES) or self.n_shots
        num_examples = self.n_examples
        possible_prompt_types = batch_metadata[BatchMetadataKeys.PROMPT_TYPES]
        if batch_metadata.get(BatchMetadataKeys.PROMPT_CHOICE_LEVEL) == "episode":
            possible_prompt_types = possible_prompt_types[
                int(self.rng.integers(len(possible_prompt_types)))]
        num_classes = batch_metadata.get(BatchMetadataKeys.NUM_CLASSES, self.n_ways)

        if self.class_based_sampling:
            init_cat_ids = [int(c) for c in self.rng.choice(
                list(self.categories.keys()), num_classes, replace=False)]
            query_image_id = random.choice(sorted(self.cat2img[init_cat_ids[0]]))
            base_image_data = self.images[query_image_id]
        else:
            base_image_data = self.images[self.image_ids[idx]]
            init_cat_ids = None

        image_ids, aux_cat_ids = self._extract_examples(
            base_image_data, num_shots, num_examples, num_classes,
            img_cats=init_cat_ids)
        if self.all_example_categories:
            aux_cat_ids = [aux_cat_ids[0]] + [set(self.img2cat[i])
                                              for i in image_ids[1:]]
        cat_ids = sorted(set(itertools.chain(*aux_cat_ids)))
        cat_ids.insert(0, -1)  # background

        images, image_key, precomputed_gts = self._get_images_or_embeddings(image_ids)
        mask_memo: Dict[int, np.ndarray] = {}
        bboxes, masks, points, classes, img_sizes = self._get_prompts(
            image_ids, cat_ids, possible_prompt_types, memo=mask_memo)

        pad_n = batch_metadata.get("pad_annotations_to")
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
            ground_truths = np.stack(
                [self.gt_to_input_frame(g) for g in gts])
        else:
            ground_truths = self.compute_ground_truths_input_frame(
                image_ids, cat_ids, memo=mask_memo)

        flag_examples = flags_merge(flag_masks, flag_points, flag_bboxes)
        dims = np.asarray(img_sizes, np.int32)

        extra = {}
        if image_key == BatchKeys.IMAGES:
            extra[BatchKeys.RESIZED_DIMS] = resized_dims(
                img_sizes, self.image_size, self.custom_preprocess)

        return {
            **extra,
            image_key: images,
            BatchKeys.PROMPT_MASKS: masks,
            BatchKeys.FLAG_MASKS: flag_masks,
            BatchKeys.PROMPT_POINTS: points,
            BatchKeys.FLAG_POINTS: flag_points,
            BatchKeys.PROMPT_BBOXES: bboxes,
            BatchKeys.FLAG_BBOXES: flag_bboxes,
            BatchKeys.FLAG_EXAMPLES: flag_examples,
            BatchKeys.DIMS: dims,
            BatchKeys.CLASSES: classes,
            BatchKeys.IMAGE_IDS: image_ids,
            BatchKeys.GROUND_TRUTHS: ground_truths,
        }

    def __len__(self):
        return self.num_samples or len(self.images)
