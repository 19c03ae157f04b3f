"""Device time of the forward kernels at their main paths' shapes (ViT-B's
lanes kernels, the global one also at the embedding batch of 8 images with
ViT-B's 12 and ViT-L's 16 heads and at the training step's 6 images with
its log-sum-exp written, with 12 and 16 heads, the windowed one also at
200 windows and at ViT-L's 16 heads; ViT-H's packed kernels, the windowed
one also at 200 windows and the global one also at the embedding batch of
8 images; the backward kernels at the training step's 6 images, with each
kernel of a backward call by name; the fused TwoWayTransformer at the
episode-decode path's two call sites: 96 prompt-encoder instances and 16
mask-decoder instances of 900 image tokens against 6 tokens, bf16; the
plain flash kernel at the affinity decoder's call: 6 x 8 heads of 4096
queries against 8192 keys, 32 wide, bf16 and fp32; the global kernel with
int8 scores beside it at ViT-B's global block; the fused windowed block at
one 1024-px image's windowed block of ViT-B, ViT-L and ViT-H, beside the
unfused kernel path that it replaces), for comparing two checkouts on one
card.

    python labelanything_tpu_torch/ops/time_kernels.py [--root DIR] [--label X]

``--root`` names the checkout whose ``labelanything_tpu_torch`` is timed
(default: the current directory). Each kernel is launched ``--launches``
times back to back between two CUDA events, queued behind a spin of the
card, so the figure is the device's time per launch and not the host's time
per call; the per-call median (an
event pair around every call, host time included) is printed beside it.
One JSON line per kernel. To compare two trees, run them alternately in one
job: A, B, B, A.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys

import numpy as np
import torch

# the backward kernels at the training step's shapes: K3 on 6 images and K4
# on their 150 windows, 12 heads of 64
BWD_SHAPES = {"relpos_global": (6, (64, 64), 12, 64),
              "relpos_window": (150, (14, 14), 12, 64)}

# kernel: (batch, key grid, heads, head width); ViT-B's lanes kernels (the
# global one also as the training step launches it, on its 6 images with
# the log-sum-exp written for the backward, with ViT-B's and ViT-L's
# heads; the windowed one also at the embedding batch's 200 windows and at
# ViT-L's 16 heads), then ViT-H's packed kernels on the token-major view
# the encoder hands them
SHAPES = {"relpos_global": (1, (64, 64), 12, 64),
          "relpos_global_b8": (8, (64, 64), 12, 64),
          "relpos_global_b8_heads16": (8, (64, 64), 16, 64),
          "relpos_global_lse": BWD_SHAPES["relpos_global"],
          "relpos_global_b6_heads16_lse": (6, (64, 64), 16, 64),
          "relpos_window": (25, (14, 14), 12, 64),
          "relpos_window_b200": (200, (14, 14), 12, 64),
          "relpos_window_heads16": (25, (14, 14), 16, 64),
          "relpos_packed_global": (1, (64, 64), 16, 80),
          "relpos_packed_global_b8": (8, (64, 64), 16, 80),
          "relpos_packed_window": (25, (14, 14), 16, 80),
          "relpos_packed_window_b200": (200, (14, 14), 16, 80)}


# fused TwoWayTransformer: instances, image tokens, tokens (width 256)
# the two call sites of the decode path; then one instance alone, and 96
# instances of 16 image tokens, where the image side is nearly nothing and
# the time left is the token side's (self-attention, MLP, small projections)
TWOWAY_SHAPES = {"prompt_encoder": (96, 900, 6), "mask_decoder": (16, 900, 6),
                 "one_instance": (1, 900, 6), "token_side": (96, 16, 6)}


# cycles of the card's spin kernel that the timed launches queue behind: some
# 100 ms at 1.98 GHz, longer than the host takes to enqueue them
SPIN_CYCLES = 2 * 10 ** 8


def device_and_call_ms(call, launches: int, repeats: int):
    """(device ms per launch: median and least over ``repeats`` runs of
    ``launches`` back-to-back calls, per-call median over 50 single calls).
    The back-to-back calls are enqueued while the card spins ahead of the
    first event, so the host's time a call cannot set the device's."""
    def events(count, queued):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(count):
            call()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / count

    with torch.no_grad():
        events(10, False)
        device_ms = [events(launches, True) for _ in range(repeats)]
        call_ms = [events(1, False) for _ in range(50)]
    return (statistics.median(device_ms), min(device_ms),
            statistics.median(call_ms))


def time_fused_twoway(opts) -> None:
    """The fused TwoWayTransformer: the kernel alone on a packed parameter
    buffer, the call as the model makes it (the wrapper looks the packed
    buffer up first) and the module path on the same operands."""
    from labelanything_tpu_torch.models.transformer import TwoWayTransformer
    from labelanything_tpu_torch.ops import flash_attention as fa
    from labelanything_tpu_torch.ops import fused_twoway as ft
    from labelanything_tpu_torch.utils.weights import init_weights

    tr = TwoWayTransformer(2, 256, 8, 2048, dtype=torch.bfloat16).cuda()
    init_weights(tr, 0)
    params = ft.twoway_params(tr)
    flat = ft.pack_params(params, torch.bfloat16)
    rng = np.random.default_rng(1)
    for site, (g, s, n) in TWOWAY_SHAPES.items():
        keys, queries, pe = (
            torch.from_numpy(rng.standard_normal(shape, np.float32))
            .cuda().bfloat16() for shape in ((g, s, 256), (g, n, 256),
                                             (s, 256)))
        module_args = (keys.view(g, 1, s, 256), pe.view(1, 1, s, 256),
                       queries)

        def module_path():
            with fa.plain_attention():
                return tr(*module_args)

        rows = {"fused_twoway_kernel": lambda: ft.fused_twoway_packed(
                    keys, queries, pe, flat, 2, 8, 2048, 2),
                "fused_twoway": lambda: ft.fused_twoway_transformer(
                    keys, queries, pe, params, 2, 8),
                "fused_twoway_module_path": module_path}
        for name, call in rows.items():
            median, least, per_call = device_and_call_ms(
                call, opts.launches, opts.repeats)
            print(json.dumps(dict(
                label=opts.label, kernel=name, site=site, instances=g,
                image_tokens=s, tokens=n, device_ms_per_launch=median,
                device_ms_min=least, call_ms_median=per_call,
                card=torch.cuda.get_device_name(0))))


# plain flash attention: batch (episodes x classes), heads, queries, keys,
# head width; the affinity decoder's call on 2 episodes of 2-way 1-shot
FLASH_SHAPE = (6, 8, 4096, 8192, 32)


def time_flash(opts) -> None:
    """The flash kernel on the head-split views of token-major projections,
    as the affinity decoder's attention hands them over."""
    from labelanything_tpu_torch.ops import flash_attention as fa

    b, heads, nq, nk, dh = FLASH_SHAPE
    rng = np.random.default_rng(1)
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (b, n, heads * dh), np.float32)).cuda().to(dtype).view(
                b, n, heads, dh).transpose(1, 2) for n in (nq, nk, nk))
        median, least, per_call = device_and_call_ms(
            lambda: fa.flash_attention(q, k, v, dh ** -0.5), opts.launches,
            opts.repeats)
        print(json.dumps(dict(
            label=opts.label, kernel="flash", dtype=str(dtype), batch=b,
            heads=heads, queries=nq, keys=nk, head_dim=dh,
            device_ms_per_launch=median, device_ms_min=least,
            call_ms_median=per_call, card=torch.cuda.get_device_name(0))))


# the fused windowed block: heads, head width (one 1024-px image: 64 x 64
# padded to 70 x 70, 25 windows of 14 x 14)
FUSED_WINDOW_SHAPES = {"vit_b": (12, 64), "vit_l": (16, 64), "vit_h": (16, 80)}


def unfused_window_call(x, qkv, r, w, bias, heads: int, ws: int):
    """A call of the path that K8 replaces, on K8's operands (x, qkv, r as
    ``fused_window_attention`` takes them, map sides multiples of ``ws``):
    the window partition of a map of x's width, the windowed attention
    kernel (K2 for 64-wide heads, the packed K5 otherwise), the output
    projection, the unpartition and the residual add. The qkv projection
    and the bias einsums are common to both paths; qkv and r are
    partitioned once here, outside the call."""
    import torch.nn.functional as F

    from labelanything_tpu_torch.models.image_encoder import (
        window_partition, window_unpartition)
    from labelanything_tpu_torch.ops import flash_attention as fa

    b, hp, wp, c = x.shape
    dh, t = c // heads, ws * ws
    qkv_w = window_partition(qkv, ws)[0].reshape(-1, t, 3 * c)
    r_w = window_partition(r.permute(0, 2, 3, 1, 4).reshape(
        b, hp, wp, heads * 2 * ws), ws)[0].reshape(-1, t, heads * 2 * ws)
    g = qkv_w.shape[0]

    def call():
        window_partition(x, ws)      # the normed map's partition copy
        if dh == fa.KERNEL_HEAD_DIM:
            out = fa.flash_attention_relpos_lanes_batched(
                qkv_w, r_w, dh ** -0.5, (ws, ws), heads)
        else:
            out = fa.flash_attention_relpos_packed(
                qkv_w.view(g, t, 3 * heads, dh).permute(0, 2, 1, 3),
                r_w.view(g, t, heads, 2 * ws).permute(0, 2, 1, 3),
                dh ** -0.5, (ws, ws), heads).permute(0, 2, 1, 3)
        out = F.linear(out.reshape(g, ws, ws, c), w, bias)
        return x + window_unpartition(out, ws, (hp, wp), (hp, wp))

    return call


def time_fused_window(opts) -> None:
    """K8 on one image's windowed block (bf16) beside the path it replaces
    (:func:`unfused_window_call`) on the same operands."""
    from labelanything_tpu_torch.ops import fused_window as fw

    ws, hp = 14, 70
    rng = np.random.default_rng(1)
    for model, (heads, dh) in FUSED_WINDOW_SHAPES.items():
        c = heads * dh
        f = lambda *s: torch.from_numpy(rng.standard_normal(
            s, np.float32)).cuda().bfloat16()
        x, qkv = f(1, hp, hp, c), f(1, hp, hp, 3 * c)
        r = (0.5 * f(1, hp, hp, heads, 2 * ws)).permute(0, 3, 1, 2, 4)
        w, bias = f(c, c) / c ** 0.5, f(c)
        rows = {"fused_window": lambda: fw.fused_window_attention(
                    x, qkv, r, w, bias, dh ** -0.5, heads, ws),
                "fused_window_unfused_path": unfused_window_call(
                    x, qkv, r, w, bias, heads, ws)}
        for name, call in rows.items():
            median, least, per_call = device_and_call_ms(
                call, opts.launches, opts.repeats)
            print(json.dumps(dict(
                label=opts.label, kernel=name, model=model, heads=heads,
                head_dim=dh, windows=25, device_ms_per_launch=median,
                device_ms_min=least, call_ms_median=per_call,
                card=torch.cuda.get_device_name(0))))


def _sentinels(count: int) -> None:
    """``count`` short kernels (``spin_kernel``, a few hundred cycles each)
    that are not the port's."""
    for _ in range(count):
        torch.cuda._sleep(100)


# the profiler drops the records of the first kernels of a pass (mostly one
# or two, at times dozens, on the H100: PERF.md section 7); a pass opens
# with GUARD_SENTINELS sentinel kernels, so that those are the dropped ones
GUARD_SENTINELS = 256
# passes made again because they lost their whole guard
guard_overruns = 0


class GuardOverrun(RuntimeError):
    """A profiler pass kept no record of its guard's sentinels: it may have
    dropped the block's first kernels too, so its counts are not read."""


def _cuda_records(prof) -> list:
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def sentinels_seen(prof) -> int:
    """Records of sentinel kernels that a pass kept."""
    return sum(e.count for e in _cuda_records(prof)
               if "spin_kernel" in e.key)


@contextlib.contextmanager
def profiled():
    """A profiler pass over the CUDA kernels launched inside the block,
    GUARD_SENTINELS sentinels and a synchronize first, a synchronize and
    one sentinel last. Raises :class:`GuardOverrun` after the block if no
    leading sentinel's record was kept."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _sentinels(GUARD_SENTINELS)
        torch.cuda.synchronize()
        yield prof
        torch.cuda.synchronize()
        _sentinels(1)
        torch.cuda.synchronize()
    # the drop is of a pass's first records: a leading sentinel kept
    # (besides the last one) means every later record was kept
    if sentinels_seen(prof) < 2:
        raise GuardOverrun(f"the profiler kept {sentinels_seen(prof)} of "
                           f"{GUARD_SENTINELS + 1} sentinel records")


def profile_pass(body) -> tuple:
    """``body()`` in a :func:`profiled` pass: (the profiler, its result). A
    pass that lost its guard is made again, three passes at most."""
    global guard_overruns
    for attempt in range(3):
        try:
            with profiled() as prof:
                result = body()
            return prof, result
        except GuardOverrun:
            if attempt == 2:
                raise
            guard_overruns += 1


def kernel_events(call, calls: int = 20) -> list:
    """The profiler's CUDA kernel records, one a kernel name, over
    ``calls`` calls of ``call`` (after a warm-up call) in a
    :func:`profile_pass`: ``key`` the name, ``count`` the launches seen,
    ``self_device_time_total`` their device time in us (the sentinels'
    records left out)."""
    call()
    torch.cuda.synchronize()

    def body():
        for _ in range(calls):
            call()

    prof, _ = profile_pass(body)
    return [e for e in _cuda_records(prof) if "spin_kernel" not in e.key]


def kernel_names(call, calls: int = 20) -> dict:
    """Launches seen of each CUDA kernel that ``call`` launches, by name."""
    return {e.key: e.count for e in kernel_events(call, calls)}


def audit_launches(inputs: list, call, twin, counter: str, kernel: str,
                   out_like, tol, passes: int = 3) -> dict:
    """Launches of one kernel over ``len(inputs)`` calls on distinct inputs,
    counted three ways. Before each call a NaN tensor of the output's size
    (``out_like``: shape, dtype) is made and freed, so the caching
    allocator hands the call's output that NaN block (checked by address);
    each output is held against ``twin`` on its own inputs (``tol(out,
    ref)`` is the largest error allowed): a launch that never ran leaves
    NaN. Counted: ``LAUNCHES[counter]``, a CUDA event pair around each call
    (its device time), and the records named ``kernel`` that ``passes``
    :func:`profile_pass` passes over the same calls see. Returns the counts
    and times."""
    from labelanything_tpu_torch.ops import flash_attention as fa

    def calls():
        pairs, outs, landed = [], [], 0
        before = fa.LAUNCHES[counter]
        for x in inputs:
            block = torch.full(out_like[0], float("nan"), dtype=out_like[1],
                               device="cuda")
            address = block.data_ptr()
            del block
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = call(x)
            end.record()
            landed += int(out.data_ptr() == address)
            pairs.append((start, end))
            outs.append(out)
        return pairs, outs, landed, fa.LAUNCHES[counter] - before

    def run(profile: bool):
        seen = sentinels = None
        if profile:
            prof, (pairs, outs, landed, launches) = profile_pass(calls)
            seen = sum(e.count for e in _cuda_records(prof)
                       if kernel in e.key)
            sentinels = sentinels_seen(prof)
        else:
            pairs, outs, landed, launches = calls()
        torch.cuda.synchronize()
        worst = 0.0
        for x, out in zip(inputs, outs):
            ref = twin(x)
            err = (out.float() - ref.float()).abs().max().item()
            if not err <= tol(out, ref):      # NaN fails here
                raise RuntimeError(f"{kernel}: a call's output is off the "
                                   f"twin by {err}")
            worst = max(worst, err)
        return dict(launches=launches, nan_prefilled=landed,
                    event_ms=[s.elapsed_time(e) for s, e in pairs],
                    profiler_seen=seen, sentinels_seen=sentinels,
                    max_abs_err=worst)

    with torch.no_grad():
        call(inputs[0])
        torch.cuda.synchronize()
        return {"events": run(False),
                "profiler": [run(True) for _ in range(passes)]}


def audit_global_kernels(calls: int = 20, passes: int = 3) -> dict:
    """:func:`audit_launches` for the two wgmma forward kernels, K1 (ViT-B's
    global block, bf16, one image) and K5 global (ViT-H's, heads 80 wide),
    and the records of K3's three kernels by name in ``passes``
    :func:`profile_pass` passes at the training step's shape. Returns the
    records by kernel."""
    from labelanything_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(5)
    records = {}
    for name, (b, (kh, kw), heads, dh) in (
            ("relpos_global", SHAPES["relpos_global"]),
            ("relpos_packed_global", SHAPES["relpos_packed_global"])):
        n, c = kh * kw, heads * dh
        inputs = []
        for _ in range(calls):
            qkv = torch.from_numpy(rng.standard_normal(
                (b, n, 3 * c), np.float32)).cuda().bfloat16()
            r = torch.from_numpy(0.5 * rng.standard_normal(
                (b, n, heads * (kh + kw)), np.float32)).cuda().bfloat16()
            if name == "relpos_packed_global":
                qkv = qkv.view(b, n, 3 * heads, dh).permute(0, 2, 1, 3)
                r = r.view(b, n, heads, kh + kw).permute(0, 2, 1, 3)
            inputs.append((qkv, r))
        args = (dh ** -0.5, (kh, kw), heads)
        if name == "relpos_global":
            call = lambda x: fa.flash_attention_relpos_lanes(*x, *args)
            twin = lambda x: fa.relpos_attention_plain(*x, *args)
            kernel = fa.global_kernel(torch.bfloat16, (kh, kw))
        else:
            call = lambda x: fa.flash_attention_relpos_packed(*x, *args)
            twin = lambda x: fa.relpos_packed_plain(*x, *args)
            kernel = fa.packed_global_kernel(torch.bfloat16, dh, (kh, kw))
        # a stale or unwritten output is off by the outputs' own scale
        tol = lambda out, ref: 0.05 * (1 + ref.float().abs().max().item())
        records[name] = dict(kernel=kernel, calls=calls, **audit_launches(
            inputs, call, twin, name, kernel, ((b, n, c), torch.bfloat16),
            tol, passes))
        del inputs
    b, (kh, kw), heads, dh = BWD_SHAPES["relpos_global"]
    n = kh * kw
    f = lambda *s: torch.from_numpy(rng.standard_normal(
        s, np.float32)).cuda().bfloat16()
    qkv, r = f(b, n, 3 * heads * dh), 0.5 * f(b, n, heads * (kh + kw))
    dout = f(b, n, heads * dh)
    args = (dh ** -0.5, (kh, kw), heads)
    out, lse = fa._launch("relpos_global", qkv, r, *args, want_lse=True)
    bwd = lambda: fa._launch_bwd("relpos_global", qkv, r, out, dout, lse,
                                 *args)
    runs = []
    for _ in range(passes):
        bwd()
        torch.cuda.synchronize()
        prof, _ = profile_pass(lambda: [bwd() for _ in range(calls)])
        runs.append(dict(
            counts={e.key.split("(")[0].replace("void ", ""): e.count
                    for e in _cuda_records(prof)
                    if "spin_kernel" not in e.key},
            sentinels=sentinels_seen(prof)))
    records["relpos_global_bwd"] = dict(calls=calls, passes=runs)
    return records


def kernel_ms(call, calls: int = 20) -> dict:
    """Device ms a launch of each CUDA kernel that ``call`` launches, by
    name (the signature cut at its argument list), averaged over the
    launches a profiler pass over ``calls`` calls saw."""
    return {e.key.split("(")[0].replace("void ", ""):
            e.self_device_time_total / 1e3 / e.count
            for e in kernel_events(call, calls)}


def time_backward(opts) -> None:
    """K3 and K4 at the training step's shapes: the forward kernel with its
    log-sum-exp once, then backward launches back to back (20 a run), and
    each of the backward's kernels by name from a profiler pass."""
    from labelanything_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(1)
    for kernel, (b, (kh, kw), heads, dh) in BWD_SHAPES.items():
        n = kh * kw
        f = lambda *s: torch.from_numpy(rng.standard_normal(
            s, np.float32)).cuda().bfloat16()
        qkv, r = f(b, n, 3 * heads * dh), 0.5 * f(b, n, heads * (kh + kw))
        dout = f(b, n, heads * dh)
        args = (dh ** -0.5, (kh, kw), heads)
        out, lse = fa._launch(kernel, qkv, r, *args, want_lse=True)
        call = lambda: fa._launch_bwd(kernel, qkv, r, out, dout, lse, *args)
        median, least, per_call = device_and_call_ms(call, 20, opts.repeats)
        print(json.dumps(dict(
            label=opts.label, kernel=kernel + "_bwd", batch=b,
            grid=[kh, kw], heads=heads, device_ms_per_launch=median,
            device_ms_min=least, call_ms_median=per_call,
            parts_ms=kernel_ms(call), card=torch.cuda.get_device_name(0))))


def time_int8(opts) -> None:
    """The global kernel with int8 scores beside the bf16 one, at ViT-B's
    global block (one image, 12 heads, 64 x 64 tokens)."""
    from labelanything_tpu_torch.ops import flash_attention as fa

    b, (kh, kw), heads, dh = SHAPES["relpos_global"]
    rng = np.random.default_rng(1)
    qkv = torch.from_numpy(rng.standard_normal(
        (b, kh * kw, 3 * heads * dh), np.float32)).cuda().bfloat16()
    r = torch.from_numpy(0.5 * rng.standard_normal(
        (b, kh * kw, heads * (kh + kw)), np.float32)).cuda().bfloat16()
    for name, int8 in (("relpos_global_int8", True),
                       ("relpos_global", False)):
        median, least, per_call = device_and_call_ms(
            lambda: fa.flash_attention_relpos_lanes(
                qkv, r, dh ** -0.5, (kh, kw), heads, int8_scores=int8),
            opts.launches, opts.repeats)
        print(json.dumps(dict(
            label=opts.label, kernel=name, batch=b, grid=[kh, kw],
            device_ms_per_launch=median, device_ms_min=least,
            call_ms_median=per_call, card=torch.cuda.get_device_name(0))))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=".")
    parser.add_argument("--label", default="")
    parser.add_argument("--launches", type=int, default=200)
    parser.add_argument("--repeats", type=int, default=7)
    opts = parser.parse_args()
    sys.path.insert(0, opts.root)
    from labelanything_tpu_torch.ops import flash_attention as fa

    windowed, lanes = (fa.flash_attention_relpos_lanes_batched,
                       fa.flash_attention_relpos_lanes)

    def lanes_lse(qkv, r, scale, grid, heads):
        return fa._launch("relpos_global", qkv, r, scale, grid, heads,
                          want_lse=True)

    fns = {"relpos_global": lanes, "relpos_global_b8": lanes,
           "relpos_global_b8_heads16": lanes,
           "relpos_global_lse": lanes_lse,
           "relpos_global_b6_heads16_lse": lanes_lse,
           "relpos_window": windowed, "relpos_window_b200": windowed,
           "relpos_window_heads16": windowed}
    packed = getattr(fa, "flash_attention_relpos_packed", None)
    rng = np.random.default_rng(1)
    for name, (b, (kh, kw), heads, dh) in SHAPES.items():
        if name not in fns and packed is None:
            continue    # a checkout from before the packed kernels
        n = kh * kw
        qkv = torch.from_numpy(rng.standard_normal(
            (b, n, 3 * heads * dh), np.float32)).cuda().bfloat16()
        r = torch.from_numpy(0.5 * rng.standard_normal(
            (b, n, heads * (kh + kw)), np.float32)).cuda().bfloat16()
        if name not in fns:
            qkv = qkv.view(b, n, 3 * heads, dh).permute(0, 2, 1, 3)
            r = r.view(b, n, heads, kh + kw).permute(0, 2, 1, 3)

        def call():
            return fns.get(name, packed)(qkv, r, dh ** -0.5, (kh, kw), heads)

        median, least, per_call = device_and_call_ms(call, opts.launches,
                                                     opts.repeats)
        print(json.dumps(dict(
            label=opts.label, kernel=name, batch=b, grid=[kh, kw],
            device_ms_per_launch=median, device_ms_min=least,
            call_ms_median=per_call, card=torch.cuda.get_device_name(0))))
    time_backward(opts)
    if os.path.exists(os.path.join(
            opts.root, "labelanything_tpu_torch/ops/fused_twoway.py")):
        time_fused_twoway(opts)
    if hasattr(fa, "flash_attention"):
        time_flash(opts)
    if os.path.exists(os.path.join(
            opts.root, "labelanything_tpu_torch/ops/fused_window.py")):
        time_int8(opts)
        time_fused_window(opts)


if __name__ == "__main__":
    main()
