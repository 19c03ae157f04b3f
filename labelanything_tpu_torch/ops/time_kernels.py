"""Device time of the forward rel-pos attention kernels at the serving
shapes, for comparing two checkouts on one card.

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
import statistics
import sys

import numpy as np
import torch

SHAPES = {"relpos_global": (1, (64, 64)), "relpos_window": (25, (14, 14))}
HEADS = 12


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
    rng = np.random.default_rng(1)
    for name, (b, (kh, kw)) in SHAPES.items():
        n = kh * kw
        qkv = torch.from_numpy(rng.standard_normal(
            (b, n, 3 * HEADS * 64), np.float32)).cuda().bfloat16()
        r = torch.from_numpy(0.5 * rng.standard_normal(
            (b, n, HEADS * (kh + kw)), np.float32)).cuda().bfloat16()

        def call():
            return fns[name](qkv, r, 64 ** -0.5, (kh, kw), HEADS)

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
            device_ms = [events(opts.launches) for _ in range(opts.repeats)]
            call_ms = [events(1) for _ in range(50)]
        print(json.dumps(dict(
            label=opts.label, kernel=name, batch=b, grid=[kh, kw],
            device_ms_per_launch=statistics.median(device_ms),
            device_ms_min=min(device_ms),
            call_ms_median=statistics.median(call_ms),
            card=torch.cuda.get_device_name(0))))


if __name__ == "__main__":
    main()
