"""Drive the PyTorch port's LAM ViT-B serving path once on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

0. card: a CUDA device must be present; prints its name and power limit;
1. build: compiles the rel-pos attention kernels (``labelanything_tpu_torch/
   csrc``) with nvcc for sm_90a;
2. kernels: each kernel against its plain PyTorch twin at the slice's
   shapes, fp32 (rtol = atol = 1e-4) and bf16 (|kernel - plain| <= 4 x
   |plain_bf16 - plain_fp32| + 1e-6, worst element), and both timed;
3. slice parity: a 1-way 1-shot episode at 1024 px through the full fp32
   slice on the GPU (kernels) and on the CPU (plain twins), logits within
   rtol 1e-3 / atol 5e-4 and argmax agreement > 0.999;
4. serving: ``LabelAnything`` in bf16, ``generate_class_embeddings`` on a
   1-way 5-shot support set, then 3 ``predict`` requests; checks shapes,
   finite logits, the 0 / -inf pad fill and the kernels' launch counts.

The last two lines are a JSON summary of the kernels and
``{"ok": true, "device": {...}}``. The model is the repo's ViT-B LAM
configuration (parameters/trainval/other/COCO_vit.yaml) at full width and
depth, with random weights from a seed (``utils.weights.init_weights``).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np
import torch

from labelanything_tpu_torch.api import LabelAnything
from labelanything_tpu_torch.data.synthetic import random_batch
from labelanything_tpu_torch.ops import _build
from labelanything_tpu_torch.ops import flash_attention as fa
from labelanything_tpu_torch.typing import BatchKeys, ResultDict

# the model block of parameters/trainval/other/COCO_vit.yaml
CONFIG = dict(name="lam_b", spatial_convs=3, class_attention=False,
              example_attention=True, example_class_attention=False,
              fusion_transformer="TwoWayTransformer", image_embed_dim=768,
              embed_dim=512, image_size=1024, use_vit_sam_neck=False,
              class_encoder={"name": "RandomMatrixEncoder", "bank_size": 100,
                             "embed_dim": 512})
SEED = 0
ENCODER_LAUNCHES = {"relpos_global": 4, "relpos_window": 8}
KERNELS = [
    dict(name="relpos_global", fn=fa.flash_attention_relpos_lanes, b=1,
         grid=(64, 64), source="labelanything_tpu_torch/csrc/relpos_global.cu",
         replaces="labelanything_tpu/ops/flash_attention.py:1318"),
    dict(name="relpos_window", fn=fa.flash_attention_relpos_lanes_batched,
         b=25, grid=(14, 14),
         source="labelanything_tpu_torch/csrc/relpos_window.cu",
         replaces="labelanything_tpu/ops/flash_attention.py:881"),
]
HEADS = 12


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def median_ms(fn, iters: int = 20) -> float:
    """Median of per-call CUDA-event times after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_card() -> str:
    check(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.cuda.get_device_name(0)


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds:.2f} s)")
    print(_build.build_log.strip())


def phase_kernels() -> dict:
    results = {}
    scale = 64 ** -0.5
    for k in KERNELS:
        kh, kw = k["grid"]
        n, c = kh * kw, HEADS * 64
        rng = np.random.default_rng(1)
        qkv = torch.from_numpy(rng.standard_normal((k["b"], n, 3 * c),
                                                   np.float32)).cuda()
        r = torch.from_numpy((0.5 * rng.standard_normal(
            (k["b"], n, HEADS * (kh + kw)))).astype(np.float32)).cuda()
        args = (scale, k["grid"], HEADS)

        out = k["fn"](qkv, r, *args)
        ref = fa.relpos_attention_plain(qkv, r, *args)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
        err32 = (out - ref).abs().max().item()

        qb, rb = qkv.bfloat16(), r.bfloat16()
        out_b = k["fn"](qb, rb, *args)
        ref_b = fa.relpos_attention_plain(qb, rb, *args)
        ref_b32 = fa.relpos_attention_plain(qb.float(), rb.float(), *args)
        err16 = (out_b.float() - ref_b.float()).abs().max().item()
        floor = (ref_b.float() - ref_b32).abs().max().item()
        check(out_b.dtype == torch.bfloat16 and err16 <= 4 * floor + 1e-6,
              f"{k['name']} bf16 error {err16} > 4 x floor {floor}")

        times = {
            "ms": median_ms(lambda: k["fn"](qb, rb, *args)),
            "plain_ms": median_ms(
                lambda: fa.relpos_attention_plain(qb, rb, *args)),
            "ms_fp32": median_ms(lambda: k["fn"](qkv, r, *args)),
            "plain_ms_fp32": median_ms(
                lambda: fa.relpos_attention_plain(qkv, r, *args)),
        }
        results[k["name"]] = dict(max_abs_err=err32, max_abs_err_bf16=err16,
                                  bf16_floor=floor, **times)
        print(f"kernel {k['name']} qkv {tuple(qkv.shape)}: fp32 err {err32:.3g}"
              f", bf16 err {err16:.3g} (floor {floor:.3g}); bf16 "
              f"{times['ms']:.4f} ms vs plain {times['plain_ms']:.4f} ms; "
              f"fp32 {times['ms_fp32']:.4f} ms vs plain "
              f"{times['plain_ms_fp32']:.4f} ms")
    return results


def phase_parity() -> None:
    batch = random_batch(batch_size=1, num_examples=1, num_classes=2,
                         with_images=True, image_size=1024, seed=0)
    logits = {}
    for device in ("cuda", "cpu"):
        la = LabelAnything(dict(CONFIG, dtype="float32"), device, SEED)
        t0 = time.perf_counter()
        out = la.predict(batch)
        if device == "cuda":
            torch.cuda.synchronize()
        logits[device] = out.float().cpu().numpy()
        print(f"parity: fp32 forward on {device} "
              f"{time.perf_counter() - t0:.2f} s")
        del la
    gpu, cpu = logits["cuda"], logits["cpu"]
    finite = np.isfinite(cpu)
    check(np.array_equal(np.isfinite(gpu), finite), "finite masks differ")
    check(finite.any(), "no finite logits")
    err = np.abs(gpu[finite] - cpu[finite])
    safe = lambda x: np.where(finite, x, -1e30)
    agree = (safe(gpu).argmax(1) == safe(cpu).argmax(1)).mean()
    print(f"parity: max |gpu - cpu| {err.max():.3g} (logit scale "
          f"{np.abs(cpu[finite]).max():.3g}), argmax agreement {agree:.6f}")
    np.testing.assert_allclose(gpu[finite], cpu[finite], rtol=1e-3, atol=5e-4)
    check(agree > 0.999, f"argmax agreement {agree}")


def phase_serve() -> dict:
    la = LabelAnything(dict(CONFIG, dtype="bf16"), "cuda", SEED)
    episode = random_batch(batch_size=1, num_examples=5, num_classes=2,
                           with_images=True, image_size=1024, seed=1)
    support = {k: v[:, 1:] if k in (BatchKeys.IMAGES, BatchKeys.DIMS) else v
               for k, v in episode.items()}
    query = {BatchKeys.IMAGES: episode[BatchKeys.IMAGES][:, :1],
             BatchKeys.DIMS: episode[BatchKeys.DIMS][:, :1]}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    fa.reset_launches()
    t0 = time.perf_counter()
    embs = la.generate_class_embeddings(support)
    torch.cuda.synchronize()
    support_s = time.perf_counter() - t0
    latencies, outs = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        outs.append(la.predict(query, embs))
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t0)
    launches = dict(fa.LAUNCHES)

    calls = 1 + len(outs)   # encoder calls: the support set, each request
    for name, per_call in ENCODER_LAUNCHES.items():
        check(launches[name] == per_call * calls,
              f"{name} launched {launches[name]} times, expected "
              f"{per_call * calls}")
    check(embs[ResultDict.CLASS_EMBS].shape == (1, 2, 512), "class embs shape")
    s = CONFIG["image_size"]
    h, w = (int(x) for x in episode[BatchKeys.DIMS][0, 0])
    valid_w = int(np.floor(w * (s / max(h, w)) + 0.5))
    for out in outs:
        check(tuple(out.shape) == (1, 2, s, s), f"logits shape {out.shape}")
        check(bool(torch.isfinite(out[..., :valid_w]).all()),
              "non-finite logits in the valid region")
        check(bool((out[:, 0, :, valid_w:] == 0).all()), "bg pad fill")
        check(bool(torch.isneginf(out[:, 1:, :, valid_w:]).all()),
              "fg pad fill")
    check(all(torch.equal(outs[0], o) for o in outs[1:]),
          "repeated requests differ")
    peak = torch.cuda.max_memory_allocated()
    print(f"serve: support set (5 images) {support_s * 1e3:.1f} ms; request "
          f"latency median {statistics.median(latencies) * 1e3:.1f} ms "
          f"(all {[round(x * 1e3, 1) for x in latencies]}); peak memory "
          f"{peak / 2**30:.2f} GiB; launches {launches}")
    return launches


def main() -> None:
    kind = phase_card()
    phase_build()
    kernel_stats = phase_kernels()
    phase_parity()
    launches = phase_serve()
    summary = [dict(name=k["name"], route="cuda", source=k["source"],
                    replaces=k["replaces"], launches=launches[k["name"]],
                    **kernel_stats[k["name"]]) for k in KERNELS]
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
