"""Score-path variants of the packed global rel-pos attention kernel on the
card (counterpart of ``scripts/microbench_softmax_dtype.py``).

    python -m labelanything_tpu_torch.ops.microbench_softmax_dtype [--batch 8]

The mma.sync packed global kernel (``csrc/relpos_packed.cuh``) compiled
three ways:

a. the bias expanded by a one-hot ``mma`` into the score accumulators
   (``la_relpos_packed_onehot``);
e. the bias added from the query row's r values, exponentials in fp32
   (``la_relpos_packed_global``, launched past the route, which sends bf16
   at 64-wide key-grid rows to the wgmma kernel of
   ``csrc/relpos_packed_sm90.cuh``, so that the three stay one kernel);
f. e with the exponentials two at a time in bf16
   (``ex2.approx.ftz.bf16x2``), P never held in fp32, the row sums from one
   more ``mma`` against a column of ones (``la_relpos_packed_bf16exp``).

Each runs at the JAX script's shape (12 heads of 64, grid 64 x 64, bf16)
and at ViT-H's (16 heads of 80), is held against the plain twin on the same
inputs (largest absolute error, and that over the twin's largest value;
the rule is the kernels' bf16 rule, 4 x |plain bf16 - plain fp32| + 1e-6,
checked at batch 1 where the twin's (B, heads, N, N) arrays fit), and is
timed per launch: ``--launches`` launches between two CUDA events, the
variants in turns. One JSON line per shape and variant. a and f are launched
from here only; no model path takes them.
"""

from __future__ import annotations

import argparse
import json
import statistics
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import flash_attention as fa

VARIANTS = {"a": "relpos_packed_onehot", "e": "relpos_packed_global",
            "f": "relpos_packed_bf16exp"}
GRID = (64, 64)
SHAPES = ((12, 64), (16, 80))   # (heads, head width)


def run_variant(qkv: torch.Tensor, r: torch.Tensor, scale: float,
                grid_hw: Tuple[int, int], heads: int, mode: str
                ) -> torch.Tensor:
    """The packed global kernel in variant ``mode`` ("a", "e" or "f") on
    CUDA tensors; arguments as ``flash_attention_relpos_packed``."""
    fa._check_packed(qkv, r, grid_hw, heads)
    return fa._launch_packed(VARIANTS[mode], qkv, r, scale, grid_hw, heads,
                             route=False)


def inputs(batch: int, heads: int, dh: int, seed: int = 0
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX script's inputs: 0.3 x standard normal, bf16, on the card."""
    n, rr = GRID[0] * GRID[1], GRID[0] + GRID[1]
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy((0.3 * rng.standard_normal(
        (batch, 3 * heads, n, dh))).astype(np.float32))
    r = torch.from_numpy((0.3 * rng.standard_normal(
        (batch, heads, n, rr))).astype(np.float32))
    return qkv.cuda().bfloat16(), r.cuda().bfloat16()


def errors(heads: int, dh: int) -> Dict[str, dict]:
    """Each variant against the plain twin at batch 1; raises when one is
    outside 4 x the bf16 rounding floor + 1e-6."""
    qkv, r = inputs(1, heads, dh)
    scale = dh ** -0.5
    with torch.no_grad():
        ref = fa.relpos_packed_plain(qkv, r, scale, GRID, heads).float()
        ref32 = fa.relpos_packed_plain(qkv.float(), r.float(), scale, GRID,
                                       heads)
        floor = (ref - ref32).abs().max().item()
        top = ref32.abs().max().item()
        del ref32
        out = {}
        for mode in VARIANTS:
            got = run_variant(qkv, r, scale, GRID, heads, mode)
            torch.cuda.synchronize()
            err = (got.float() - ref).abs().max().item()
            if not err <= 4 * floor + 1e-6:
                raise RuntimeError(
                    f"variant {mode} (heads {heads}, dh {dh}): error {err} > "
                    f"4 x floor {floor}")
            out[mode] = dict(max_abs_err=err, rel_err=err / max(top, 1e-9),
                             bf16_floor=floor)
    return out


def times(batch: int, heads: int, dh: int, launches: int, repeats: int
          ) -> Dict[str, List[float]]:
    """Device ms per launch of each variant, ``repeats`` readings each,
    taken in turns (a, e, f, a, e, f, ...)."""
    qkv, r = inputs(batch, heads, dh)
    scale = dh ** -0.5

    def events(mode: str, count: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(count):
            run_variant(qkv, r, scale, GRID, heads, mode)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / count

    readings: Dict[str, List[float]] = {mode: [] for mode in VARIANTS}
    for mode in VARIANTS:
        events(mode, 3)
    for _ in range(repeats):
        for mode in VARIANTS:
            readings[mode].append(events(mode, launches))
    return readings


def run(batch: int = 8, launches: int = 200, repeats: int = 5,
        shapes=SHAPES) -> List[dict]:
    """The whole microbench; returns (and prints) one record per shape and
    variant."""
    if not torch.cuda.is_available():
        raise RuntimeError("the microbench needs a CUDA device")
    records = []
    for heads, dh in shapes:
        errs = errors(heads, dh)
        ms = times(batch, heads, dh, launches, repeats)
        flops = 4 * batch * heads * (GRID[0] * GRID[1]) ** 2 * dh
        for mode, kernel in VARIANTS.items():
            median = statistics.median(ms[mode])
            records.append(dict(
                variant=mode, kernel=kernel, batch=batch, heads=heads, dh=dh,
                grid=list(GRID), ms_per_launch=median,
                ms_min=min(ms[mode]), ms_max=max(ms[mode]),
                tflops=flops / median / 1e9, **errs[mode],
                card=torch.cuda.get_device_name(0)))
            print(json.dumps(records[-1]), flush=True)
    return records


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--launches", type=int, default=200)
    parser.add_argument("--repeats", type=int, default=5)
    opts = parser.parse_args()
    run(opts.batch, opts.launches, opts.repeats)


if __name__ == "__main__":
    main()
