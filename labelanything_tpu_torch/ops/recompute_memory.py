"""Peak memory of the affinity model's fp32 training step (``chip_smoke.py``
phase 18's configuration) at every (episodes, ways, shots) of
4.2_Affinity_SAM.yaml's ``possible_batch_example_nums``, with K6's backward
recomputing its (B, H, Q, K) fp32 scores at once and in the
``RECOMPUTE_BYTES`` blocks the port takes: the measurement behind that
constant.

    python labelanything_tpu_torch/ops/recompute_memory.py

Run from the checkout's root on one card. One line a tuple and recompute; a
tuple that does not fit says so. The last line is one JSON object of the
peaks in GiB (null where the step did not fit).
"""

from __future__ import annotations

import json
import os
import sys


def main() -> None:
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    os.chdir(root)
    sys.path.insert(0, root)
    import chip_smoke as cs
    import torch
    from labelanything_tpu_torch.ops import flash_attention as fa

    card = cs.phase_card()
    cs.phase_build()
    generator = torch.Generator()
    state = cs.train_state("float32", cs.CONFIG_AFFINITY,
                           scheduler=cs.SCHEDULE)
    blocked, peaks = fa.RECOMPUTE_BYTES, {}
    # at once: a limit above every tuple's scores
    for label, limit in (("at once", 2 ** 62), ("in blocks", blocked)):
        fa.RECOMPUTE_BYTES = limit
        for episodes, ways, shots in cs.AFFINITY_TUPLES:
            tup, error = [episodes, ways, shots], None
            try:
                rec = cs.affinity_tuple_step(state, ways, shots, episodes,
                                             generator, 2)
            except torch.cuda.OutOfMemoryError as err:
                error = str(err).splitlines()[0][:120]
            if error is not None:
                for p in state.model.parameters():
                    p.grad = None
                torch.cuda.empty_cache()
                peaks[f"{label} {tup}"] = None
                print(f"affinity training, fp32, {tup}, recompute {label}: "
                      f"does not fit ({error})")
                continue
            peaks[f"{label} {tup}"] = rec["peak_gib"]
            print(f"affinity training, fp32, {tup}, recompute {label}: peak "
                  f"memory {rec['peak_gib']:.2f} GiB, step {rec['ms']:.1f} "
                  f"ms, losses {[round(x, 6) for x in rec['losses']]}")
    fa.RECOMPUTE_BYTES = blocked
    print(card)
    print(json.dumps(peaks))


if __name__ == "__main__":
    main()
