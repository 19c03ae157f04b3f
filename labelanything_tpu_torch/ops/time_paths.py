"""End-to-end times of the paths that run the attention kernels, for
comparing two checkouts on one card: ``chip_smoke.py``'s ViT-B request
(phase 4) and ``lam_h`` request (phase 8), each with a profiler pass over
it, bf16 training step with its profiler pass (phase 6), embedding of 8
images with ``build_vit_b``, ``build_vit_l`` and ``build_vit_h`` (phases 9
and 15), affinity decode (phase 13) and episode decode with its profiler
pass (phase 11), each as that checkout's ``chip_smoke.py`` drives it, with
its own kernels and launch checks.

    python labelanything_tpu_torch/ops/time_paths.py [--root DIR]

``--root`` names the checkout (default: the current directory); the script
runs from that directory, so its kernels are built and loaded from there.
Run one process per checkout, alternately in one job (A, B, B, A): two
checkouts' packages cannot share a process. Each phase prints its own
lines; the last line is one JSON object of the headline numbers.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import sys


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=".")
    parser.add_argument("--label", default="")
    # requests a ViT-B and a lam_h serve after the support set; the first
    # warms up
    parser.add_argument("--requests", type=int, default=3)
    opts = parser.parse_args()
    root = os.path.abspath(opts.root)
    os.chdir(root)
    sys.path.insert(0, root)
    import chip_smoke as cs
    import torch

    card = cs.phase_card()
    cs.phase_build()
    log = io.StringIO()

    class Tee(io.TextIOBase):
        def write(self, text):
            log.write(text)
            return sys.__stdout__.write(text)

    with contextlib.redirect_stdout(Tee()):
        cs.phase_serve(requests=opts.requests, profile=True)
        cs.phase_train()
        cs.phase_serve(cs.CONFIG_H, cs.ENCODER_LAUNCHES_H,
                       requests=opts.requests, profile=True)
        for build, name, launches in (
                (cs.build_vit_b, "vit_b", cs.ENCODER_LAUNCHES),
                (cs.build_vit_l, "vit_l", cs.ENCODER_LAUNCHES_L),
                (cs.build_vit_h, "vit_h", cs.ENCODER_LAUNCHES_H)):
            cs.phase_embed(build, name, launches)
        cs.phase_affinity()
        cs.phase_decode()
    text = log.getvalue()

    def number(pattern: str, which: int = 0) -> float:
        found = re.findall(pattern, text)
        return float(found[which]) if len(found) > which else float("nan")

    # the ViT-B request's profiler pass, then the lam_h request's
    request_kernel = (r"profile: 2 requests, .*kernel time ([\d.]+) ms a "
                      r"request")

    print(card)
    print(json.dumps(dict(
        label=opts.label, root=root, card=torch.cuda.get_device_name(0),
        request_ms=number(r"serve lam_b: .*?request latency median ([\d.]+)"),
        request_kernel_ms=number(request_kernel, 0),
        train_step_ms=number(r"train: 6 images.*?median ([\d.]+) ms"),
        train_kernel_ms=number(
            r"profile: 2 steps, .*kernel time ([\d.]+) ms a step"),
        request_h_ms=number(
            r"serve lam_h: .*?request latency median ([\d.]+)"),
        request_h_kernel_ms=number(request_kernel, 1),
        embed_vit_b=number(r"embed vit_b: .*= ([\d.]+) images/s"),
        embed_vit_l=number(r"embed vit_l: .*= ([\d.]+) images/s"),
        embed_vit_h=number(r"embed vit_h: .*= ([\d.]+) images/s"),
        affinity_ms=number(r"affinity decode: .*?median ([\d.]+) ms"),
        affinity_kernel_ms=number(
            r"profile: 2 forwards, .*kernel time ([\d.]+) ms a forward"),
        decode_ms=number(r"decode with masks: .*?median ([\d.]+) ms"),
        decode_kernel_ms=number(
            r"profile: 4 steps, .*kernel time ([\d.]+) ms a step"))))


if __name__ == "__main__":
    main()
