"""Drive the PyTorch port's LAM ViT-B paths once on one NVIDIA GPU: serving,
then a fine-tune training step.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

0. card: a CUDA device must be present; prints its name and power limit;
1. build: compiles the rel-pos attention kernels (``labelanything_tpu_torch/
   csrc``) with nvcc for sm_90a, one compiler per source;
2. kernels: each kernel against its plain PyTorch twin at the shapes its
   path gives it (forward: serving, 1 image / 25 windows; backward: the
   training step, 6 images / 150 windows, where the forward kernels, which
   then also write the log-sum-exp, are held against their twins again),
   fp32 (rtol = atol = 1e-4: the sums run in another order) and bf16
   (|kernel - plain| <= 4 x |plain_bf16 - plain_fp32| + 1e-6, worst
   element, per output); kernel, plain twin and one library call
   (``scaled_dot_product_attention`` on the expanded bias; forward +
   backward for a backward kernel) are timed, and the least time the card
   could take is reckoned from the shapes. The global kernels take a
   shorter bias path when a row of the key grid is 64 wide, as at 1024 px;
   their general path is held against the twins on a 48 x 48 grid;
3. slice parity: a 1-way 1-shot episode at 1024 px through the full fp32
   slice on the GPU (kernels) and on the CPU (plain twins), logits within
   rtol 1e-3 / atol 5e-4 and argmax agreement > 0.999;
4. serving: ``LabelAnything`` in bf16, ``generate_class_embeddings`` on a
   1-way 5-shot support set, then 3 ``predict`` requests; checks shapes,
   finite logits, the 0 / -inf pad fill and the kernels' launch counts;
5. step parity: one fp32 training pass (forward, focal loss, backward) of
   a 1-way 1-shot episode on the card twice from the same weights and
   class rows, through the kernels and through the plain twins
   (``plain_attention()``): loss within 1e-5 relative, every parameter's
   gradient within a relative L2 distance of GRAD_REL_L2 (gradients below
   GRAD_FLOOR of the whole gradient's norm are held to that floor); the
   same pass in bf16, whose whole gradient must point where the fp32 one
   does (cosine >= BF16_GRAD_COSINE); then five fp32 AdamW steps through
   the kernels on that episode: the loss falls on the first update and is
   lower after step 5 than at step 1;
6. training: the fine-tune configuration of the JAX package's
   ``bench_finetune`` in bf16 (2 episodes of 1-way 2-shot, 6 images a
   step, masks, focal loss with class weighting, AdamW 5e-5, encoder
   trainable) through ``init_train_state`` / ``make_train_step``: 1 warm-up
   and 4 timed steps on one batch; every loss finite, every parameter
   with a gradient moved, launch counts per step; this batch's fp32 and
   bf16 gradient norms are reported (the fp32 one is below bf16's rounding
   noise with these weights, so these losses cannot show the fall); a
   profiler pass over two more steps (kernel time by name, the device's
   busy share); then one step with the backbone frozen: no
   backward kernel, encoder unchanged.

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
import torch.nn.functional as F

from labelanything_tpu_torch.api import LabelAnything
from labelanything_tpu_torch.data.synthetic import (random_batch,
                                                    random_full_batch)
from labelanything_tpu_torch.ops import _build
from labelanything_tpu_torch.ops import flash_attention as fa
from labelanything_tpu_torch.parallel.train_step import (init_train_state,
                                                         make_train_step)
from labelanything_tpu_torch.train.losses import LabelAnythingLoss
from labelanything_tpu_torch.train.substitutor import Substitutor
from labelanything_tpu_torch.typing import BatchKeys, ResultDict

# the model block of parameters/trainval/other/COCO_vit.yaml
CONFIG = dict(name="lam_b", spatial_convs=3, class_attention=False,
              example_attention=True, example_class_attention=False,
              fusion_transformer="TwoWayTransformer", image_embed_dim=768,
              embed_dim=512, image_size=1024, use_vit_sam_neck=False,
              class_encoder={"name": "RandomMatrixEncoder", "bank_size": 100,
                             "embed_dim": 512})
SEED = 0
HEADS = 12
SCALE = 64 ** -0.5
# kernel launches of one encoder call: 4 global and 8 windowed blocks
ENCODER_LAUNCHES = {"relpos_global": 4, "relpos_window": 8}
TRAIN_LAUNCHES = {"relpos_global": 4, "relpos_window": 8,
                  "relpos_global_bwd": 4, "relpos_window_bwd": 8}
TRAIN_STEPS = 4
FP32_STEPS = 5
LEARNING_RATE = 5e-5
# phase 5: |g_kernel - g_plain|_2 <= GRAD_REL_L2 * |g_plain|_2 per parameter
# (fp32 on both sides; the kernels and the plain twins sum in other orders)
GRAD_REL_L2 = 2e-4
GRAD_FLOOR = 1e-4
# phase 5, the bf16 pass against the fp32 one on the same episode: bf16
# rounds every activation of 12 blocks and two transformers, so the loss
# agrees to a few 1e-3 and the whole gradient's direction to a cosine of
# about 0.93 with these weights
BF16_LOSS_RTOL = 5e-3
BF16_GRAD_COSINE = 0.85
# published peaks of the H100 SXM: dense bf16 tensor-core rate, memory rate
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
_SRC = "labelanything_tpu_torch/csrc/"
_JAX = "labelanything_tpu/ops/flash_attention.py:"
KERNELS = [
    dict(name="relpos_global", fn=fa.flash_attention_relpos_lanes, b=1,
         grid=(64, 64), backward=False, source=_SRC + "relpos_global.cu",
         replaces=_JAX + "1318"),
    dict(name="relpos_window", fn=fa.flash_attention_relpos_lanes_batched,
         b=25, grid=(14, 14), backward=False,
         source=_SRC + "relpos_window.cu", replaces=_JAX + "881"),
    dict(name="relpos_global_bwd", fn=fa.flash_attention_relpos_lanes, b=6,
         grid=(64, 64), backward=True, source=_SRC + "relpos_global_bwd.cu",
         replaces=_JAX + "1343"),
    dict(name="relpos_window_bwd", fn=fa.flash_attention_relpos_lanes_batched,
         b=150, grid=(14, 14), backward=True,
         source=_SRC + "relpos_window_bwd.cu", replaces=_JAX + "901"),
]
# The global kernels' general bias path: a key grid whose rows are not 64
# wide (a 768-px image) at the training step's batch. Held against the
# plain twins, not timed; the main path at 1024 px does not take it.
GENERAL_PATH = [dict(KERNELS[0], b=6, grid=(48, 48)),
                dict(KERNELS[2], grid=(48, 48))]
# parameters that the step's episodes give no gradient: negative points,
# the no-mask / no-sparse stand-ins, and the prompt transformer's final
# token-to-image attention, whose output (the queries) the encoder drops
NO_GRADIENT = ("prompt_encoder.point_embeddings.0.",
               "prompt_encoder.no_mask_embed.",
               "prompt_encoder.no_sparse_embedding.",
               "prompt_encoder.transformer.final_attn_token_to_image.",
               "prompt_encoder.transformer.norm_final_attn.")
# a bias added to every key shifts all scores of a query alike, which the
# softmax ignores: its gradient is zero up to rounding and may not move it
ZERO_GRADIENT = "k_proj.bias"


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
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds:.2f} s)")
    print(_build.build_log.strip())


def bound(k: dict) -> dict:
    """Least time the card could take for one call of kernel ``k`` in bf16:
    the larger of operations / peak rate and bytes / memory rate, every
    input read once and every output written once. Forward: the q.k^T and
    P.v products, 4 N^2 dh flops per head; inputs qkv, r; output out.
    Backward: five such products (dP, dQ, dK, dV and the recomputed
    scores), 10 N^2 dh; inputs qkv, r, out, dout and the forward's
    log-sum-exp (fp32); outputs dqkv, dr."""
    kh, kw = k["grid"]
    b, n, c = k["b"], kh * kw, HEADS * 64
    r_width = HEADS * (kh + kw)
    if k["backward"]:
        flops = 10 * b * HEADS * n * n * 64
        nbytes = 2 * b * n * (2 * 3 * c + 2 * r_width + 2 * c) \
            + 4 * b * HEADS * n
    else:
        flops = 4 * b * HEADS * n * n * 64
        nbytes = 2 * b * n * (3 * c + r_width + c)
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                flops=flops, bytes=nbytes)


def library_attention(qkv, r, grid_hw):
    """The same function through one library call: the factored bias
    expanded to (B, H, N, N), then ``scaled_dot_product_attention``."""
    b, n, c3 = qkv.shape
    kh, kw = grid_hw
    c = c3 // 3
    q, k, v = (x.reshape(b, n, HEADS, 64).transpose(1, 2)
               for x in qkv.split(c, dim=-1))
    rb = r.reshape(b, n, HEADS, kh + kw).transpose(1, 2) / fa.LOG2E
    bias = (rb[..., :kh, None] + rb[..., None, kh:]).reshape(b, HEADS, n, n)
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=SCALE)
    return out.transpose(1, 2).reshape(b, n, c)


def kernel_inputs(k: dict):
    kh, kw = k["grid"]
    n, c = kh * kw, HEADS * 64
    rng = np.random.default_rng(1)
    qkv = torch.from_numpy(rng.standard_normal((k["b"], n, 3 * c),
                                               np.float32)).cuda()
    r = torch.from_numpy((0.5 * rng.standard_normal(
        (k["b"], n, HEADS * (kh + kw)))).astype(np.float32)).cuda()
    ct = torch.from_numpy(rng.standard_normal((k["b"], n, c),
                                              np.float32)).cuda()
    return qkv, r, ct


@torch.no_grad()
def forward_error(k: dict, out, qkv, r) -> tuple:
    """Holds a forward kernel's ``out`` against the plain twin on the same
    inputs: (worst error, bf16 floor or None)."""
    args = (SCALE, k["grid"], HEADS)
    ref = fa.relpos_attention_plain(qkv, r, *args)
    torch.cuda.synchronize()
    check(out.dtype == qkv.dtype, f"{k['name']}: output is {out.dtype}")
    if qkv.dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
        return (out - ref).abs().max().item(), None
    ref32 = fa.relpos_attention_plain(qkv.float(), r.float(), *args)
    err = (out.float() - ref.float()).abs().max().item()
    floor = (ref.float() - ref32).abs().max().item()
    check(err <= 4 * floor + 1e-6,
          f"{k['name']} b {k['b']} bf16 forward error {err} > 4 x floor "
          f"{floor}")
    return err, floor


def check_forward(k: dict, timed: bool = True) -> dict:
    qkv, r, _ = kernel_inputs(k)
    args = (SCALE, k["grid"], HEADS)
    err32, _ = forward_error(k, k["fn"](qkv, r, *args), qkv, r)
    qb, rb = qkv.bfloat16(), r.bfloat16()
    err16, floor = forward_error(k, k["fn"](qb, rb, *args), qb, rb)
    stats = dict(max_abs_err=err32, max_abs_err_bf16=err16, bf16_floor=floor)
    if not timed:
        return stats
    ref_b32 = fa.relpos_attention_plain(qb.float(), rb.float(), *args)
    lib = library_attention(qb, rb, k["grid"])
    check((lib.float() - ref_b32).abs().max().item() <= 4 * floor + 1e-6,
          f"{k['name']}: the library call computes another function")
    del ref_b32, lib
    return dict(
        stats,
        ms=median_ms(lambda: k["fn"](qb, rb, *args)),
        plain_ms=median_ms(lambda: fa.relpos_attention_plain(qb, rb, *args)),
        library_ms=median_ms(lambda: library_attention(qb, rb, k["grid"])),
        ms_fp32=median_ms(lambda: k["fn"](qkv, r, *args)),
        plain_ms_fp32=median_ms(
            lambda: fa.relpos_attention_plain(qkv, r, *args)))


def check_backward(k: dict, timed: bool = True) -> dict:
    args = (SCALE, k["grid"], HEADS)
    stats = {}
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        qkv, r, ct = (x.to(dtype) for x in kernel_inputs(k))
        qkv.requires_grad_()
        r.requires_grad_()
        # the forward kernel as training runs it: at this batch, writing
        # the log-sum-exp; its result feeds both backwards below, so it is
        # held against the plain forward first
        out = k["fn"](qkv, r, *args)
        err, _ = forward_error(k, out.detach(), qkv.detach(), r.detach())
        stats["fwd_max_abs_err" + ("" if dtype == torch.float32
                                   else "_bf16")] = err

        def kernel():
            return torch.autograd.grad(out, (qkv, r), ct, retain_graph=True)

        def plain():
            with torch.no_grad():
                return fa.relpos_attention_bwd_plain(qkv, r, out, ct, *args)

        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        if dtype == torch.float32:
            for g, x in zip(got, ref):
                torch.testing.assert_close(g, x, rtol=1e-4, atol=1e-4)
            stats["max_abs_err"] = max((g - x).abs().max().item()
                                       for g, x in zip(got, ref))
            if timed:
                stats["ms_fp32"] = median_ms(kernel, iters=5)
                stats["plain_ms_fp32"] = median_ms(plain, iters=5)
        else:
            with torch.no_grad():
                ref32 = fa.relpos_attention_bwd_plain(
                    qkv.float(), r.float(), out.float(), ct.float(), *args)
            for name, g, x, x32 in zip(("dqkv", "dr"), got, ref, ref32):
                err = (g.float() - x.float()).abs().max().item()
                floor = (x.float() - x32).abs().max().item()
                check(g.dtype == torch.bfloat16 and err <= 4 * floor + 1e-6,
                      f"{k['name']} bf16 {name} error {err} > 4 x floor "
                      f"{floor}")
                worst[name] = (err, floor)
            del ref32
            stats["max_abs_err_bf16"] = max(e for e, _ in worst.values())
            stats["bf16_floor"] = max(f for _, f in worst.values())
            del got, ref
            if timed:
                stats["ms"] = median_ms(kernel, iters=10)
                stats["plain_ms"] = median_ms(plain, iters=5)

                def library():
                    a = qkv.detach().requires_grad_()
                    c = r.detach().requires_grad_()
                    y = library_attention(a, c, k["grid"])
                    return y, torch.autograd.grad(y, (a, c), ct)

                y, lib = library()
                check((y - out).abs().max().item() <= 0.05
                      and all(torch.isfinite(g).all() for g in lib),
                      f"{k['name']}: the library call computes another "
                      f"function")
                del y, lib
                stats["library_ms"] = median_ms(library, iters=5)
                stats["library_fwd_ms"] = median_ms(
                    lambda: library_attention(qkv.detach(), r.detach(),
                                              k["grid"]), iters=5)
        del qkv, r, ct, out
        torch.cuda.empty_cache()
    stats["bf16_by_output"] = {n: dict(err=e, floor=f)
                               for n, (e, f) in worst.items()}
    return stats


def phase_kernels() -> dict:
    results = {}
    for k in KERNELS:
        stats = check_backward(k) if k["backward"] else check_forward(k)
        results[k["name"]] = dict(stats, **bound(k))
        s = results[k["name"]]
        print(f"kernel {k['name']} b {k['b']} grid {k['grid']}: fp32 err "
              f"{s['max_abs_err']:.3g}, bf16 err {s['max_abs_err_bf16']:.3g} "
              f"(floor {s['bf16_floor']:.3g}); bf16 {s['ms']:.4f} ms vs "
              f"plain {s['plain_ms']:.4f} ms, library {s['library_ms']:.4f} "
              f"ms, bound {s['bound_ms']:.4f} ms by {s['bound_by']}; fp32 "
              f"{s['ms_fp32']:.4f} ms vs plain {s['plain_ms_fp32']:.4f} ms"
              + (f"; its forward kernel at these shapes: fp32 err "
                 f"{s['fwd_max_abs_err']:.3g}, bf16 err "
                 f"{s['fwd_max_abs_err_bf16']:.3g}" if k["backward"] else ""))
    for k in GENERAL_PATH:
        s = (check_backward if k["backward"] else check_forward)(k, False)
        print(f"kernel {k['name']}, general bias path, b {k['b']} grid "
              f"{k['grid']}: fp32 err {s['max_abs_err']:.3g}, bf16 err "
              f"{s['max_abs_err_bf16']:.3g} (floor {s['bf16_floor']:.3g})")
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
    la = LabelAnything(dict(CONFIG, dtype="bf16"), seed=SEED)   # on the card
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


def train_state(dtype: str, **optimizer_args):
    """The full-width model with the seeded weights, the focal loss and
    AdamW, on the card (``init_train_state``'s default device)."""
    loss = LabelAnythingLoss({"focal": {"weight": 1.0}}, class_weighting=True)
    return init_train_state(dict(CONFIG, dtype=dtype), loss, seed=SEED,
                            name="AdamW", learning_rate=LEARNING_RATE,
                            **optimizer_args)


def training_batch(batch_size: int, shots: int):
    full = random_full_batch(batch_size=batch_size, num_examples=shots,
                             num_classes=2, image_size=1024, with_images=True,
                             include_masks=True, seed=2)
    sub = Substitutor(num_points=1, substitute=False)
    sub.reset({k: torch.as_tensor(v) for k, v in full.items()})
    batch, gt = next(sub)
    return {k: v.cuda() for k, v in batch.items()}, gt.cuda()


def gradient_pass(dtype: str, batch, gt, plain: bool = False):
    """One training pass (forward, loss, backward, no update) of a fresh
    train state with pinned class rows: (state, loss, gradients by name)."""
    state = train_state(dtype)
    check(next(state.model.parameters()).is_cuda,
          "the train state is not on the card")
    state.model.prompt_encoder.class_encoder.rows = (0, 7)
    step = make_train_step()
    if plain:
        with fa.plain_attention():
            _, aux = step(state, batch, gt, None, 1.0, apply_update=False)
    else:
        _, aux = step(state, batch, gt, None, 1.0, apply_update=False)
    torch.cuda.synchronize()
    return state, float(aux["loss"]), {
        n: p.grad for n, p in state.model.named_parameters()}


def direction(grads: dict, ref: dict) -> tuple:
    """(cosine, norm of ``grads``, norm of ``ref``) over all parameters."""
    dot = sq = sq_ref = 0.0
    for name, g in ref.items():
        if g is not None:
            dot += float((grads[name] * g).sum())
            sq += float(grads[name].norm()) ** 2
            sq_ref += float(g.norm()) ** 2
    return dot / (sq * sq_ref) ** 0.5, sq ** 0.5, sq_ref ** 0.5


def phase_step_parity() -> None:
    batch, gt = training_batch(batch_size=1, shots=1)
    runs = {}
    for mode in ("kernels", "plain"):
        fa.reset_launches()
        t0 = time.perf_counter()
        runs[mode] = gradient_pass("float32", batch, gt, mode == "plain")
        launches = dict(fa.LAUNCHES)
        # 2 images in one encoder call, forward and backward
        expected = TRAIN_LAUNCHES if mode == "kernels" else {}
        for name, count in launches.items():
            check(count == expected.get(name, 0),
                  f"step parity ({mode}): {name} launched {count} times")
        print(f"step parity: fp32 pass through the {mode} "
              f"{time.perf_counter() - t0:.2f} s, loss {runs[mode][1]:.6f}, "
              f"launches {launches}")
    (state, loss_k, grads_k), (_, loss_p, grads_p) = (runs.pop("kernels"),
                                                      runs.pop("plain"))
    check(np.isfinite(loss_k) and abs(loss_k - loss_p) <= 1e-5 * abs(loss_p),
          f"step parity: loss {loss_k} vs {loss_p}")
    total = sum(float(g.norm()) ** 2 for g in grads_p.values()
                if g is not None) ** 0.5
    rows, rel_pos = [], {}
    for name, ref in grads_p.items():
        got = grads_k[name]
        check((got is None) == (ref is None), f"{name}: gradient present in "
              f"one run only")
        if ref is None:
            continue
        check(bool(torch.isfinite(got).all()), f"{name}: gradient not finite")
        norm = ref.norm().item()
        # a gradient below GRAD_FLOOR of the whole gradient's norm is
        # rounding noise of its own sums; it is held to that floor instead
        diff = (got - ref).norm().item()
        if name.endswith(("rel_pos_h", "rel_pos_w")):
            # fed by the kernels' dr alone: held to its own norm, no floor
            check(norm > 0, f"{name}: zero gradient")
            rel_pos[name] = diff / norm
            rows.append((diff / norm, name, norm))
        else:
            rows.append((diff / max(norm, GRAD_FLOOR * total), name, norm))
    rows.sort(reverse=True)
    for rel, name, norm in rows[:5]:
        print(f"step parity: relative L2 {rel:.3g} (norm {norm:.3g}) {name}")
    print(f"step parity: loss kernels {loss_k:.8f} plain {loss_p:.8f}; "
          f"gradients of {len(rows)} parameters, norm {total:.4g}; "
          f"rel_pos_h / rel_pos_w worst {max(rel_pos.values()):.3g}")
    check(len(rel_pos) == 24, f"{len(rel_pos)} rel-pos tables")
    check(rows[0][0] <= GRAD_REL_L2,
          f"step parity: {rows[0][1]} relative L2 {rows[0][0]}")
    del grads_p

    # the same pass in bf16, as phase 6 trains: its whole gradient must
    # point where the fp32 one does
    _, loss_b, grads_b = gradient_pass("bf16", batch, gt)
    cosine, norm_b, norm_k = direction(grads_b, grads_k)
    print(f"step parity: bf16 pass loss {loss_b:.6f} (fp32 {loss_k:.6f}), "
          f"gradient norm {norm_b:.4g} (fp32 {norm_k:.4g}), cosine with "
          f"the fp32 gradient {cosine:.4f}")
    check(abs(loss_b - loss_k) <= BF16_LOSS_RTOL * abs(loss_k),
          f"bf16 loss {loss_b} vs fp32 {loss_k}")
    check(cosine >= BF16_GRAD_COSINE, f"bf16 gradient cosine {cosine}")
    del grads_b, grads_k

    # training proper, where rounding cannot hide it: five fp32 AdamW steps
    # through the kernels on this episode; the loss falls on the first
    # update and stands lower after the fifth step than before the first
    step, losses = make_train_step(), []
    for _ in range(FP32_STEPS):
        state, aux = step(state, batch, gt, None, 1.0, apply_update=True,
                          use_accum=False)
        losses.append(float(aux["loss"]))
    print(f"step parity: {FP32_STEPS} fp32 steps at lr {LEARNING_RATE}, "
          f"losses {[round(x, 8) for x in losses]}")
    check(abs(losses[0] - loss_k) <= 1e-6 * abs(loss_k),
          f"the first step's loss {losses[0]} is not the pass's {loss_k}")
    check(losses[1] < losses[0] and losses[-1] < losses[0],
          f"the fp32 loss did not fall: {losses}")


def profile_steps(run_step, steps: int = 2) -> None:
    """Kernel time by name and the device's busy share over a few training
    steps (``torch.profiler``; its own host cost stretches the window, so
    the busy share is a lower bound)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.self_device_time_total / 1e3, e.count, e.key)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               # kernels, not the optimizer's annotation ranges
               and not e.key.startswith("Optimizer.")]
    busy_ms = sum(t for t, _, _ in kernels)
    print(f"profile: {steps} steps, {wall_ms / steps:.1f} ms a step under the "
          f"profiler, kernel time {busy_ms / steps:.1f} ms a step in "
          f"{sum(n for _, n, _ in kernels) // steps} kernels, device busy "
          f"{busy_ms / wall_ms:.3f} of the window")
    for t, n, key in sorted(kernels, reverse=True)[:12]:
        print(f"profile:   {t / steps:8.3f} ms a step, {n // steps:5d} "
              f"launches  {key[:90]}")


def encoder_digest(model) -> float:
    return sum(p.double().abs().sum().item()
               for p in model.image_encoder.parameters())


def report_batch_gradient(batch, gt) -> None:
    """With the seeded weights the training batch's two class logits differ
    by about 0.005 and its fp32 gradient is some 400 times smaller than the
    phase-5 episode's, below the rounding noise of a bf16 gradient: the
    losses of phase 6's steps move by noise, and the falling loss is
    checked in phase 5. Reported, not checked."""
    _, loss32, grads32 = gradient_pass("float32", batch, gt)
    _, loss16, grads16 = gradient_pass("bf16", batch, gt)
    cosine, norm16, norm32 = direction(grads16, grads32)
    print(f"train: this batch's gradient norm fp32 {norm32:.4g} (loss "
          f"{loss32:.6f}), bf16 {norm16:.4g} (loss {loss16:.6f}), cosine "
          f"{cosine:.4f}")


def phase_train() -> dict:
    batch, gt = training_batch(batch_size=2, shots=2)
    images = batch[BatchKeys.IMAGES].shape[0] * batch[BatchKeys.IMAGES].shape[1]
    report_batch_gradient(batch, gt)
    state = train_state("bf16")
    model = state.model
    step = make_train_step()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    generator = torch.Generator()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    losses, times, per_step = [], [], []
    for _ in range(1 + TRAIN_STEPS):
        # the same class rows on every step, as the JAX bench's fixed key
        generator.manual_seed(SEED)
        fa.reset_launches()
        t0 = time.perf_counter()
        state, aux = step(state, batch, gt, generator, 1.0,
                          apply_update=True, use_accum=False)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(aux["loss"]))
        per_step.append(dict(fa.LAUNCHES))
    peak = torch.cuda.max_memory_allocated()

    check(all(np.isfinite(x) for x in losses), f"losses {losses}")
    for launches in per_step:
        check(launches == TRAIN_LAUNCHES, f"launches of a step: {launches}")
    check(state.step == 1 + TRAIN_STEPS, f"{state.step} updates")
    unchanged = []
    for name, p in model.named_parameters():
        check(bool(torch.isfinite(p).all()), f"{name} is not finite")
        if torch.equal(p, before[name]):
            unchanged.append(name)
    check(all(n.startswith(NO_GRADIENT) or n.endswith(ZERO_GRADIENT)
              for n in unchanged),
          f"parameters that did not move: {unchanged}")
    timed = times[1:]
    ms = statistics.median(timed) * 1e3
    print(f"train: {images} images a step, bf16, losses "
          f"{[round(x, 6) for x in losses]}; warm-up {times[0] * 1e3:.1f} ms, "
          f"steps {[round(x * 1e3, 1) for x in timed]} ms, median {ms:.1f} ms"
          f" = {images / ms * 1e3:.2f} images/s; peak memory "
          f"{peak / 2**30:.2f} GiB; launches per step {per_step[-1]}; "
          f"{len(unchanged)} of {len(before)} parameters did not move")
    total = {name: sum(x[name] for x in per_step) for name in TRAIN_LAUNCHES}
    del before

    def one_more_step():
        generator.manual_seed(SEED)
        step(state, batch, gt, generator, 1.0, apply_update=True,
             use_accum=False)

    profile_steps(one_more_step)

    # the configuration's own variant: the backbone frozen
    state = init_train_state(model, state.loss, name="AdamW",
                             learning_rate=LEARNING_RATE, freeze_backbone=True)
    digest = encoder_digest(model)
    generator.manual_seed(SEED)
    fa.reset_launches()
    t0 = time.perf_counter()
    state, aux = step(state, batch, gt, generator, 1.0, apply_update=True,
                      use_accum=False)
    torch.cuda.synchronize()
    frozen_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(fa.LAUNCHES)
    check(np.isfinite(float(aux["loss"])), "frozen step: loss not finite")
    check(launches == dict(ENCODER_LAUNCHES, relpos_global_bwd=0,
                           relpos_window_bwd=0),
          f"frozen step: launches {launches}")
    check(encoder_digest(model) == digest, "frozen step: the encoder moved")
    print(f"train, backbone frozen: loss {float(aux['loss']):.6f}, "
          f"{frozen_ms:.1f} ms (first such step), launches {launches}")
    return total


def main() -> None:
    card = phase_card()
    kind = torch.cuda.get_device_name(0)
    phase_build()
    kernel_stats = phase_kernels()
    phase_parity()
    serve_launches = phase_serve()
    phase_step_parity()
    train_launches = phase_train()
    summary = []
    for k in KERNELS:
        # launches over both main paths: the serving requests (4 encoder
        # calls) and the timed training steps
        summary.append(dict(
            name=k["name"], route="cuda", source=k["source"],
            replaces=k["replaces"],
            launches=serve_launches[k["name"]] + train_launches[k["name"]],
            **kernel_stats[k["name"]]))
    print(card)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
