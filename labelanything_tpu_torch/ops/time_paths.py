"""End-to-end times of the paths that run the attention kernels, for
comparing two checkouts on one card: ``chip_smoke.py``'s ViT-B request
(phase 4), bf16 training step (phase 6), embedding of 8 images with
``build_vit_b``, ``build_vit_l`` and ``build_vit_h`` (phases 9 and 15) and
affinity decode (phase 13), each as that checkout's ``chip_smoke.py``
drives it, with its own kernels and launch checks.

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
    # requests a ViT-B serve after the support set; the first warms up
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
        cs.phase_serve(requests=opts.requests)
        cs.phase_train()
        for build, name, launches in (
                (cs.build_vit_b, "vit_b", cs.ENCODER_LAUNCHES),
                (cs.build_vit_l, "vit_l", cs.ENCODER_LAUNCHES_L),
                (cs.build_vit_h, "vit_h", cs.ENCODER_LAUNCHES_H)):
            cs.phase_embed(build, name, launches)
        cs.phase_affinity()
    text = log.getvalue()

    def number(pattern: str) -> float:
        found = re.search(pattern, text)
        return float(found.group(1)) if found else float("nan")

    print(card)
    print(json.dumps(dict(
        label=opts.label, root=root, card=torch.cuda.get_device_name(0),
        request_ms=number(r"serve lam_b: .*?request latency median ([\d.]+)"),
        train_step_ms=number(r"train: 6 images.*?median ([\d.]+) ms"),
        embed_vit_b=number(r"embed vit_b: .*= ([\d.]+) images/s"),
        embed_vit_l=number(r"embed vit_l: .*= ([\d.]+) images/s"),
        embed_vit_h=number(r"embed vit_h: .*= ([\d.]+) images/s"),
        affinity_ms=number(r"affinity decode: .*?median ([\d.]+) ms"),
        affinity_kernel_ms=number(
            r"profile: 2 forwards, .*kernel time ([\d.]+) ms a forward"))))


if __name__ == "__main__":
    main()
