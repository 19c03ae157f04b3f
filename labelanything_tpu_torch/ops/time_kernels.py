"""Device time of the forward kernels at their main paths' shapes (ViT-B's
lanes kernels, ViT-H's packed kernels, the fused TwoWayTransformer at the
episode-decode path's two call sites: 96 prompt-encoder instances and 16
mask-decoder instances of 900 image tokens against 6 tokens, bf16, and the
plain flash kernel at the affinity decoder's call: 6 x 8 heads of 4096
queries against 8192 keys, 32 wide, bf16 and fp32), for comparing two
checkouts on one card.

    python labelanything_tpu_torch/ops/time_kernels.py [--root DIR] [--label X]

``--root`` names the checkout whose ``labelanything_tpu_torch`` is timed
(default: the current directory). Each kernel is launched ``--launches``
times back to back between two CUDA events, so the figure is the device's
time per launch and not the host's time per call; the per-call median (an
event pair around every call, host time included) is printed beside it.
One JSON line per kernel. To compare two trees, run them alternately in one
job: A, B, B, A.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

import numpy as np
import torch

# kernel: (batch, key grid, heads, head width); ViT-B's lanes kernels, then
# ViT-H's packed kernels on the token-major view the encoder hands them
SHAPES = {"relpos_global": (1, (64, 64), 12, 64),
          "relpos_window": (25, (14, 14), 12, 64),
          "relpos_packed_global": (1, (64, 64), 16, 80),
          "relpos_packed_window": (25, (14, 14), 16, 80)}


# fused TwoWayTransformer: instances, image tokens, tokens (width 256)
# the two call sites of the decode path; then one instance alone, and 96
# instances of 16 image tokens, where the image side is nearly nothing and
# the time left is the token side's (self-attention, MLP, small projections)
TWOWAY_SHAPES = {"prompt_encoder": (96, 900, 6), "mask_decoder": (16, 900, 6),
                 "one_instance": (1, 900, 6), "token_side": (96, 16, 6)}


def device_and_call_ms(call, launches: int, repeats: int):
    """(device ms per launch: median and least over ``repeats`` runs of
    ``launches`` back-to-back calls, per-call median over 50 single calls)."""
    def events(count):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(count):
            call()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / count

    with torch.no_grad():
        events(10)
        device_ms = [events(launches) for _ in range(repeats)]
        call_ms = [events(1) for _ in range(50)]
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


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=".")
    parser.add_argument("--label", default="")
    parser.add_argument("--launches", type=int, default=200)
    parser.add_argument("--repeats", type=int, default=7)
    opts = parser.parse_args()
    sys.path.insert(0, opts.root)
    from labelanything_tpu_torch.ops import flash_attention as fa

    fns = {"relpos_global": fa.flash_attention_relpos_lanes,
           "relpos_window": fa.flash_attention_relpos_lanes_batched}
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
    if os.path.exists(os.path.join(
            opts.root, "labelanything_tpu_torch/ops/fused_twoway.py")):
        time_fused_twoway(opts)
    if hasattr(fa, "flash_attention"):
        time_flash(opts)


if __name__ == "__main__":
    main()
