"""Cross-domain test datasets, a copy of
``labelanything_tpu/data/crossdomain.py`` (reference: label_anything/data/
{kvasir,weedmap,brain_mri,dram}.py).

All four share one protocol: a folder of query images with dense masks plus a
small fixed support set whose GT masks become the (mask-type) visual prompts.
``MaskFolderTestDataset`` implements the shared machinery; the concrete
classes bind folder layouts, class maps and mask decoding rules.

Where the JAX package opens files with PIL, the port decodes them with
``data/image_io.py`` (JPEG, PNG, TIFF) and resizes them as PIL does: the
images by ``data/transforms.preprocess_image``, the masks' NEAREST resizes
by ``data/transforms.nearest_index_map``. An item's image is the
normalized float32 frame, as in the JAX package.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from ..typing import BatchKeys
from .image_io import open_image, read_gray, read_rgb
from .schema import flags_merge
from .test import LabelAnythingTestDataset
from .transforms import (get_preprocess_shape, nearest_index_map,
                         preprocess_image)


def _nearest(mask: np.ndarray, h: int, w: int) -> np.ndarray:
    """PIL's NEAREST resize of an (H, W) uint8 mask to (h, w)."""
    return mask[np.ix_(nearest_index_map(mask.shape[0], h),
                       nearest_index_map(mask.shape[1], w))]


def _resize_mask_256(mask: np.ndarray) -> np.ndarray:
    return _nearest(mask.astype(np.uint8), 256, 256).astype(np.int64)


class MaskFolderTestDataset(LabelAnythingTestDataset):
    """Shared support/query machinery for folder-structured test sets."""

    id2class: Dict[int, str] = {}
    num_classes: int = 0

    def __init__(self, image_size: int = 1024, custom_preprocess: bool = True):
        self.image_size = image_size
        self.custom_preprocess = custom_preprocess

    # concrete classes implement these -------------------------------- #
    def query_files(self) -> List[str]:
        raise NotImplementedError

    def support_files(self) -> List[str]:
        raise NotImplementedError

    def load_image(self, fname: str, split: str) -> np.ndarray:
        """The image as (H, W, 3) uint8 RGB."""
        raise NotImplementedError

    def load_gt(self, fname: str, split: str) -> np.ndarray:
        raise NotImplementedError

    # shared ------------------------------------------------------------ #
    def __len__(self):
        return len(self.query_files())

    def gt_to_input_frame(self, gt: np.ndarray) -> np.ndarray:
        from .transforms import gt_to_input_frame

        return gt_to_input_frame(gt, self.image_size, self.custom_preprocess)

    def __getitem__(self, idx):
        fname = self.query_files()[idx]
        image = self.load_image(fname, "test")
        arr, (h, w) = preprocess_image(image, self.image_size,
                                       self.custom_preprocess)
        gt = self.load_gt(fname, "test")
        return {
            BatchKeys.IMAGES: arr[None],
            "dims": np.asarray([h, w], np.int32),
            "gt": self.gt_to_input_frame(gt),
        }

    def collate_fn(self, batched_input):
        images = np.stack([x[BatchKeys.IMAGES] for x in batched_input])
        dims = np.stack([x["dims"] for x in batched_input])
        gt = np.stack([x["gt"] for x in batched_input])
        return {BatchKeys.IMAGES: images, BatchKeys.DIMS: dims[:, None, :]}, gt

    def extract_prompts(self) -> Dict[str, np.ndarray]:
        """Support GT masks -> one-hot mask prompts (reference:
        kvasir.py:96-141, weedmap.py:74-120, brain_mri.py:83-118)."""
        files = self.support_files()
        images, sizes, masks = [], [], []
        for fname in files:
            image = self.load_image(fname, "train")
            arr, (h, w) = preprocess_image(image, self.image_size,
                                           self.custom_preprocess)
            images.append(arr)
            sizes.append((h, w))
            gt = self.load_gt(fname, "train")
            # rasterize the mask into the padded input frame, then 256x256
            s = self.image_size
            if self.custom_preprocess:
                nh, nw = get_preprocess_shape(h, w, s)
                frame = np.zeros((s, s), np.uint8)
                frame[:nh, :nw] = _nearest(gt.astype(np.uint8), nh, nw)
            else:
                frame = _nearest(gt.astype(np.uint8), s, s)
            masks.append(_resize_mask_256(frame))

        masks = np.stack(masks)                      # (M, 256, 256)
        c = self.num_classes
        onehot = np.eye(c, dtype=np.float32)[masks]  # (M, 256, 256, C)
        prompt_masks = onehot.transpose(0, 3, 1, 2)  # (M, C, 256, 256)
        flag_masks = (prompt_masks.sum(axis=(2, 3)) > 0).astype(np.int32)
        flag_masks[:, 0] = 0  # bg channel is not a prompt

        m = len(files)
        prompt_bboxes = np.zeros((m, c, 1, 4), np.float32)
        flag_bboxes = np.zeros((m, c, 1), np.int32)
        prompt_points = np.zeros((m, c, 1, 2), np.float32)
        flag_points = np.zeros((m, c, 1), np.int32)
        flag_examples = flags_merge(flag_masks, flag_points, flag_bboxes)

        return {
            BatchKeys.IMAGES: np.stack(images)[None],
            BatchKeys.PROMPT_MASKS: prompt_masks[None],
            BatchKeys.FLAG_MASKS: flag_masks[None],
            BatchKeys.PROMPT_BBOXES: prompt_bboxes[None],
            BatchKeys.FLAG_BBOXES: flag_bboxes[None],
            BatchKeys.PROMPT_POINTS: prompt_points[None],
            BatchKeys.FLAG_POINTS: flag_points[None],
            BatchKeys.FLAG_EXAMPLES: flag_examples[None],
            BatchKeys.DIMS: np.asarray(sizes, np.int32)[None],
        }


class KvasirTestDataset(MaskFolderTestDataset):
    """Kvasir-SEG polyps (reference: data/kvasir.py:21-151)."""

    id2class = {0: "background", 1: "polyp"}
    num_classes = 2
    DEFAULT_PROMPTS = ["cju1euuc65wm00799m4sjdnnn.jpg"]

    def __init__(self, root: str, prompt_images: Optional[List[str]] = None,
                 **kwargs):
        super().__init__(**kwargs)
        self.root = root
        self.test_root = os.path.join(root, "test")
        self.train_root = os.path.join(root, "train")
        self.prompt_images = prompt_images or self.DEFAULT_PROMPTS
        self._query = sorted(os.listdir(os.path.join(self.test_root, "images")))

    def query_files(self):
        return self._query

    def support_files(self):
        return self.prompt_images

    def load_image(self, fname, split):
        root = self.test_root if split == "test" else self.train_root
        return read_rgb(os.path.join(root, "images", fname))

    def load_gt(self, fname, split):
        root = self.test_root if split == "test" else self.train_root
        mask = read_gray(os.path.join(root, "masks", fname))
        return (mask >= 245).astype(np.int64)


class WeedMapTestDataset(MaskFolderTestDataset):
    """WeedMap crop/weed tiles (reference: data/weedmap.py:12-146)."""

    id2class = {0: "background", 1: "crop", 2: "weed"}
    num_classes = 3
    DEFAULT_PROMPTS = ["frame0009_2.png", "frame0021_2.png", "frame0033_3.png",
                       "frame0034_1.png", "frame0048_0.png"]

    def __init__(self, train_root: str, test_root: str,
                 prompt_images: Optional[List[str]] = None, **kwargs):
        super().__init__(**kwargs)
        self.train_root = train_root
        self.test_root = test_root
        self.prompt_images = prompt_images or self.DEFAULT_PROMPTS
        self.channels = ["R", "G", "B"]
        self._query = sorted(os.listdir(
            os.path.join(test_root, "tile", self.channels[0])))

    def query_files(self):
        return self._query

    def support_files(self):
        return self.prompt_images

    def load_image(self, fname, split):
        root = self.test_root if split == "test" else self.train_root
        chans = [read_gray(os.path.join(root, "tile", ch, fname))
                 for ch in self.channels]
        return np.stack(chans, axis=-1)

    def load_gt(self, fname, split):
        root = self.test_root if split == "test" else self.train_root
        gt_dir = os.path.join(root, "groundtruth")
        candidates = [f for f in os.listdir(gt_dir) if fname.split(".")[0] in f]
        mask = open_image(
            os.path.join(gt_dir, candidates[0] if candidates else fname)).array
        if mask.ndim == 3:  # color-coded: G=crop, R=weed
            out = np.zeros(mask.shape[:2], np.int64)
            out[mask[..., 1] > 127] = 1
            out[mask[..., 0] > 127] = 2
            return out
        return mask.astype(np.int64)


class BrainMriTestDataset(MaskFolderTestDataset):
    """LGG brain-MRI tumor segmentation (reference: data/brain_mri.py:15-229)."""

    id2class = {0: "background", 1: "tumor"}
    num_classes = 2

    def __init__(self, root: str, num_prompts: int = 5, **kwargs):
        super().__init__(**kwargs)
        self.root = root
        files = []
        for dirpath, _, fnames in os.walk(root):
            for f in sorted(fnames):
                if f.endswith(".tif") and "_mask" not in f:
                    files.append(os.path.join(dirpath, f))
        self._files = files
        # supports: first images whose mask is non-empty
        support = []
        for f in files:
            if self._mask_path(f) and open_image(
                    self._mask_path(f)).array.max() > 0:
                support.append(f)
            if len(support) >= num_prompts:
                break
        self._support = support
        self._query = [f for f in files if f not in support]

    @staticmethod
    def _mask_path(image_path: str) -> str:
        base, ext = os.path.splitext(image_path)
        return base + "_mask" + ext

    def query_files(self):
        return self._query

    def support_files(self):
        return self._support

    def load_image(self, fname, split):
        return read_rgb(fname)

    def load_gt(self, fname, split):
        mask = read_gray(self._mask_path(fname))
        return (mask > 127).astype(np.int64)


class DramTestDataset(MaskFolderTestDataset):
    """DRAM art-domain segmentation (reference: data/dram.py:33-290).

    Layout: <root>/{test,train}/<painting-dirs>/ with parallel
    labels directories; Pascal-class palette GT pngs.
    """

    num_classes = 12

    def __init__(self, root: str, split_file: Optional[str] = None,
                 num_prompts: int = 12, **kwargs):
        super().__init__(**kwargs)
        self.root = root
        test_dir = os.path.join(root, "test")
        self._query = []
        for dirpath, _, fnames in os.walk(test_dir):
            if "labels" in dirpath:
                continue
            for f in sorted(fnames):
                if f.endswith((".jpg", ".png")) :
                    self._query.append(os.path.join(dirpath, f))
        train_dir = os.path.join(root, "train")
        support = []
        for dirpath, _, fnames in os.walk(train_dir):
            if "labels" in dirpath:
                continue
            for f in sorted(fnames):
                if f.endswith((".jpg", ".png")):
                    support.append(os.path.join(dirpath, f))
                if len(support) >= num_prompts:
                    break
            if len(support) >= num_prompts:
                break
        self._support = support
        self.id2class = {0: "background", **{i: f"class_{i}"
                                             for i in range(1, self.num_classes)}}

    def query_files(self):
        return self._query

    def support_files(self):
        return self._support

    def _label_path(self, image_path: str) -> str:
        base, _ = os.path.splitext(image_path)
        return base.replace(os.sep + "test" + os.sep,
                            os.sep + "test" + os.sep + "labels" + os.sep) + ".png"

    def load_image(self, fname, split):
        return read_rgb(fname)

    def load_gt(self, fname, split):
        label = self._label_path(fname)
        if not os.path.exists(label):
            parts = fname.rsplit(os.sep, 2)
            label = os.path.join(parts[0], "labels", parts[1],
                                 os.path.splitext(parts[2])[0] + ".png")
        return open_image(label).array.astype(np.int64)
