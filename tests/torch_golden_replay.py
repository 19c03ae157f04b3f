"""Golden fixtures replayed through the PyTorch port.

``canonical_full_forward`` (``lam_no_vit`` at the 480-px configuration of
parameters/trainval/coco20i/mae.yaml) and ``sam_released_full_forward``
(``lam_b``: SAM ViT-B at 1024 px, embed 512) hold the original PyTorch
LabelAnything's outputs for reference-layout weights made from a seed
(``tests/golden.py``); ``ppnet_full``, ``denet_2way_2shot``, ``bam_1shot``
and ``hdmnet_1shot`` the original baselines'
(``tests/golden_baselines.py``: PPNet on a (1, 1, 1, 2) ResNet, DENet on
an 8 x 8 stride-8 conv for a backbone, BAM and HDMNet on the full
ResNet-50, all at 64 or 65 px), and ``swin_features``,
``dcama_head_2shot`` and ``fptrans_1shot`` those of a small Swin (64 px,
window 4, widths 16 to 128), DCAMA's head on features of those widths and
a two-block FPTrans 32 wide (its FPS seeded at the first valid pixel).
This module imports torch, numpy and ``tests.golden`` only, so the replays
run where JAX is absent too: ``tests/test_torch_lam.py``,
``tests/test_torch_baselines.py``, ``test_torch_dcama.py`` and
``test_torch_fptrans.py`` run them on the CPU and ``chip_smoke.py`` on the
card.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from labelanything_tpu_torch.models.build_lam import (build_lam_no_vit,
                                                      build_lam_vit_b)
from labelanything_tpu_torch.models.bam import BAM
from labelanything_tpu_torch.models.dcama import DCAMAModel
from labelanything_tpu_torch.models.denet import DENet
from labelanything_tpu_torch.models.fptrans import FPTrans
from labelanything_tpu_torch.models.hdmnet import HDMNet
from labelanything_tpu_torch.models.ppnet import PPNet
from labelanything_tpu_torch.models.swin import SwinTransformer
from labelanything_tpu_torch.typing import BatchKeys, ResultDict
from labelanything_tpu_torch.utils.weights import reference_baseline_state_dict
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


BASELINE_CASES = ("ppnet_full", "denet_2way_2shot", "bam_1shot",
                  "hdmnet_1shot")
TRANSFORMER_CASES = ("swin_features", "dcama_head_2shot", "fptrans_1shot")


class _TinyBackbone(torch.nn.Module):
    """The DENet case's backbone: one 8 x 8 conv of stride 8 to layer3's
    1024 channels (``tests/test_denet.py``'s ``_TorchTinyBackbone``)."""

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 1024, 8, 8)

    def forward(self, x):
        return self.conv(x)


def _baseline(name: str):
    """(the bare module of a baseline case, its state-dict kind, the case's
    inputs in the module's argument order: NCHW arrays for the ResNet /
    VGG models, channels-last for Swin, DCAMA and FPTrans)."""
    case = CASES[name]
    if name == "ppnet_full":
        sup, qry, fore = case._inputs()
        model = PPNet(num_centers=case.CENTERS, kmeans_iters=1,
                      resnet_layers=case.LAYERS)
        # (Wa, Sh, B, ...) -> (B, Wa, Sh, ...)
        fore = fore.transpose(2, 0, 1, 3, 4)
        return model, "ppnet", (sup.transpose(2, 0, 1, 3, 4, 5), fore,
                                1.0 - fore, qry)
    if name == "denet_2way_2shot":
        model = DENet(maximum_num_classes=case.NUM_CLASSES,
                      backbone=_TinyBackbone())
        return model, "denet", case._inputs()
    if name == "bam_1shot":
        return BAM(shot=case.shot, base_classes=60), "bam", case._inputs()
    if name == "hdmnet_1shot":
        return (HDMNet(shot=case.shot, base_classes=60), "hdmnet",
                case._inputs())
    if name == "swin_features":
        model = SwinTransformer(img_size=64, patch_size=4, window_size=4,
                                embed_dim=16, depths=(1, 2, 2, 1),
                                num_heads=(1, 2, 2, 4))
        return model, "dcama", (case._inputs().transpose(0, 2, 3, 1),)
    if name == "dcama_head_2shot":
        qf, sf, mask = case._inputs()
        nhwc = lambda a: a.transpose(0, 2, 3, 1)
        support = [np.stack([nhwc(shot[i]) for shot in sf], axis=1)
                   for i in range(len(qf))]
        return (DCAMAModel(in_channels=case.in_ch, stack_ids=case.stack_ids),
                "dcama", ([nhwc(q) for q in qf], support, mask))
    model = FPTrans(image_size=64, embed_dim=32, depth=2, num_heads=2,
                    bg_num=2, num_prompt=12, ncls=5, shot=case.shot,
                    drop_rate=0.0, fps_first="first_valid")
    return model, "fptrans", case._inputs()


def _on(device, value):
    if isinstance(value, list):
        return [_on(device, v) for v in value]
    return torch.as_tensor(np.asarray(value), device=device)


@torch.no_grad()
def replay_baseline(name: str, device="cpu"
                    ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """(the port's outputs, the fixture's) for a baseline case, in fp32 on
    ``device``: the weights made from the fixture's shapes, the keys no
    eval path holds dropped (``reference_baseline_state_dict``), loaded
    with ``strict=True``. Compare them with ``CASES[name].compare``."""
    case = CASES[name]
    shapes, outputs = load_fixture(name)
    with torch.device("meta"):
        model, kind, inputs = _baseline(name)
    model = model.to_empty(device=torch.device(device)).eval()
    model.load_state_dict(reference_baseline_state_dict(
        kind, make_weights(case, shapes)), strict=True)
    out = model(*[_on(device, a) for a in inputs])
    if name == "denet_2way_2shot":
        return {"full": out[0].cpu().numpy(),
                "binary": out[1].cpu().numpy()}, outputs
    if name == "swin_features":
        return {f"feat{i}": f.reshape(f.shape[0], -1, f.shape[-1]).cpu()
                .numpy() for i, f in enumerate(out)}, outputs
    if name == "fptrans_1shot":
        out = out["out"]
    return {"out": out.float().cpu().numpy()}, outputs
