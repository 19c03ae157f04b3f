"""The two full-size golden fixtures replayed through the PyTorch port.

``canonical_full_forward`` (``lam_no_vit`` at the 480-px configuration of
parameters/trainval/coco20i/mae.yaml) and ``sam_released_full_forward``
(``lam_b``: SAM ViT-B at 1024 px, embed 512) hold the original PyTorch
LabelAnything's outputs for reference-layout weights made from a seed
(``tests/golden.py``). This module imports torch, numpy and
``tests.golden`` only, so the replays run where JAX is absent too:
``tests/test_torch_lam.py`` runs them on the CPU (marked ``slow``) and
``chip_smoke.py`` on the card.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from labelanything_tpu_torch.models.build_lam import (build_lam_no_vit,
                                                      build_lam_vit_b)
from labelanything_tpu_torch.typing import BatchKeys, ResultDict
from tests.golden import C_BANK, C_EMBED, C_IMG, C_IMG_EMBED, CASES, \
    load_fixture, make_weights


def _batch(case, embeddings_key: str) -> Dict[str, np.ndarray]:
    """The case's inputs in the port's channels-last batch layout."""
    (pixels, coords, labels, boxes, bflags, masks, mflags, flag_examples,
     dims) = case._inputs()
    return {embeddings_key: pixels.transpose(0, 1, 3, 4, 2),
            BatchKeys.PROMPT_POINTS: coords, BatchKeys.FLAG_POINTS: labels,
            BatchKeys.PROMPT_BBOXES: boxes, BatchKeys.FLAG_BBOXES: bflags,
            BatchKeys.PROMPT_MASKS: masks, BatchKeys.FLAG_MASKS: mflags,
            BatchKeys.FLAG_EXAMPLES: flag_examples, BatchKeys.DIMS: dims}


def _build(name: str, **options) -> Tuple[torch.nn.Module, str, tuple]:
    """The model of a case, as the JAX package's ``our_forward`` builds it:
    (model on the meta device, the batch key of its pixels, the crop of
    the logits' frame the reference returned)."""
    encoder = {"name": "RandomMatrixEncoder", "bank_size": C_BANK}
    if name == "canonical_full_forward":
        model = build_lam_no_vit(
            image_embed_dim=C_IMG_EMBED, embed_dim=C_EMBED, image_size=C_IMG,
            spatial_convs=3, example_class_attention=True,
            class_encoder=encoder, **options)
        return model, BatchKeys.EMBEDDINGS, (C_IMG, C_IMG)
    case = CASES[name]
    model = build_lam_vit_b(embed_dim=512, image_size=case.S,
                            class_encoder=encoder, **options)
    # the reference's postprocess returns the original size, which the
    # case's dims make the content extent of the fixed frame
    return model, BatchKeys.IMAGES, (768, 1024)


@torch.no_grad()
def replay(name: str, device="cpu", **options
           ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """(the port's summarized outputs, the fixture's) for
    ``canonical_full_forward`` or ``sam_released_full_forward``, in fp32 on
    ``device``; ``options`` go to the builder (``fused_window`` for the SAM
    case). Compare them with ``CASES[name].compare``."""
    case = CASES[name]
    shapes, outputs = load_fixture(name)
    with torch.device("meta"):
        model, key, (h, w) = _build(name, **options)
    model = model.to_empty(device=torch.device(device)).eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           make_weights(case, shapes).items()}, strict=True)
    batch = {k: torch.as_tensor(v, device=device)
             for k, v in _batch(case, key).items()}
    logits = model(batch)[ResultDict.LOGITS][:, :, :h, :w]
    return case._summarize(logits.float().cpu().numpy()), outputs
