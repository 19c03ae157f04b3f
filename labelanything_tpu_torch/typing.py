"""Batch and result keys (counterpart of ``labelanything_tpu/typing.py``).

The same names and string values as the JAX package's enums, so one
episode dict serves both packages; copied rather than imported so that the
port runs where the JAX package is absent.
"""

from __future__ import annotations

import enum


class StrEnum(str, enum.Enum):
    def __str__(self) -> str:
        return str(self.value)


class PromptType(StrEnum):
    """Visual prompt modalities (reference: data/utils.py:19-22)."""

    BBOX = "bbox"
    MASK = "mask"
    POINT = "point"


class Label(enum.IntEnum):
    """Prompt flags: a real positive prompt, a real negative point, or
    padding (reference: data/utils.py:25-28)."""

    POSITIVE = 1
    NULL = 0
    NEGATIVE = -1


class BatchKeys(StrEnum):
    """Episode batch keys (reference: data/utils.py:43-58); channels-last
    layouts, index 0 along the image axis is the query."""

    IMAGES = "images"                      # (B, N, S, S, 3)
    EMBEDDINGS = "embeddings"              # (B, N, h, w, D)
    PROMPT_MASKS = "prompt_masks"          # (B, M, C, Hm, Wm)
    FLAG_MASKS = "flag_masks"              # (B, M, C)
    PROMPT_POINTS = "prompt_points"        # (B, M, C, N, 2) xy
    FLAG_POINTS = "flag_points"            # (B, M, C, N) in {-1, 0, 1}
    PROMPT_BBOXES = "prompt_bboxes"        # (B, M, C, N, 4) xyxy
    FLAG_BBOXES = "flag_bboxes"            # (B, M, C, N) in {0, 1}
    FLAG_EXAMPLES = "flag_examples"        # (B, M, C) in {0, 1}
    DIMS = "dims"                          # (B, N, 2) original (H, W)
    RESIZED_DIMS = "resized_dims"          # (B, N, 2) content (h, w)
    CLASSES = "classes"                    # host metadata (lists)
    INTENDED_CLASSES = "intended_classes"
    IMAGE_IDS = "image_ids"
    GROUND_TRUTHS = "ground_truths"        # (B, H, W), IGNORE_INDEX = pad
    FLAG_GTS = "flag_gts"                  # (B, C) classes present


class BatchMetadataKeys(StrEnum):
    """Keys of the sampler-to-dataset metadata dict (reference:
    data/utils.py:61-65)."""

    PROMPT_TYPES = "prompt_types"
    NUM_EXAMPLES = "num_examples"
    NUM_CLASSES = "num_classes"
    PROMPT_CHOICE_LEVEL = "prompt_choice_level"


class AnnFileKeys(StrEnum):
    """COCO-style annotation file keys (reference: data/utils.py:31-40)."""

    IMAGES = "images"
    ANNOTATIONS = "annotations"
    CATEGORIES = "categories"
    ID = "id"
    IMAGE_ID = "image_id"
    CATEGORY_ID = "category_id"
    IMAGE = "image"
    ISCROWD = "iscrowd"
    SEGMENTATION = "segmentation"


class ResultDict(StrEnum):
    """Forward-result keys (reference: label_anything/utils/utils.py)."""

    LOGITS = "logits"
    CLASS_EMBS = "class_embeddings"
    EXAMPLES_CLASS_EMBS = "examples_class_embeddings"
    EXAMPLES_CLASS_SRC = "examples_class_src"


class LossDict(StrEnum):
    """Keys of the loss module's result."""

    VALUE = "value"
    COMPONENTS = "components"


#: ground-truth padding (reference: data/utils.py collate_gts)
IGNORE_INDEX = -100
