"""Command-line interface (counterpart of ``labelanything_tpu/cli.py``;
reference: label_anything/cli.py:12-371), on ``argparse``.

    python -m labelanything_tpu_torch.cli experiment --parameters FILE.yaml
    python -m labelanything_tpu_torch.cli run --parameters FILE.yaml
    python -m labelanything_tpu_torch.cli validate --parameters FILE.yaml \\
        --checkpoint RUN_DIR/checkpoints

The options keep the JAX CLI's names; ``--device`` (default ``cuda``)
names the device, ``--device cpu`` runs on the CPU. The JAX CLI's other
commands are not ported yet: they print so and exit with status 2.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
from typing import List, Optional

NOT_PORTED = ("test", "generate_embeddings", "generate_embeddings_huggingface",
              "generate_feature_pyramids", "preprocess_clip", "preprocess_voc",
              "pretrain_pe", "generate_gt", "rename_coco20i_json", "benchmark",
              "app")


def _experiment(args) -> int:
    if args.parallel:
        print("experiment --parallel is not ported yet (experiment/parallel.py)",
              file=sys.stderr)
        return 2
    from .experiment import experiment

    experiment(args.parameters, out_dir=args.out_dir, device=args.device)
    return 0


def _run(args) -> int:
    from .experiment import run_single

    run_single(args.parameters, out_dir=args.out_dir, device=args.device)
    return 0


def _validate(args) -> int:
    """Validate the first grid point of the file on its validation sets:
    the weights of ``--checkpoint`` (a run's ``checkpoints`` directory, whose
    ``best`` is taken when it has one and ``latest`` otherwise, or one such
    tag directory), else the seeded initial weights."""
    from .experiment import Run
    from .train.checkpoint import CheckpointManager
    from .utils.config import expand_experiment, load_yaml

    flat = expand_experiment(load_yaml(args.parameters))[0]
    if args.reruns is not None:
        flat = {**flat, "val_params": {**flat.get("val_params", {}),
                                       "reruns": args.reruns}}
    run = Run().init(flat, run_dir=args.out_dir, device=args.device)
    if args.checkpoint is not None:
        path = pathlib.Path(args.checkpoint)
        tags = [t for t in ("best", "latest") if (path / t).is_dir()]
        if tags:
            directory, tag = path, tags[0]
        else:
            directory, tag = path.parent, path.name
        restored, meta = CheckpointManager(str(directory)).restore(run.state,
                                                                  tag)
        if restored is None:
            print(f"no checkpoint at {path}", file=sys.stderr)
            return 1
        print(f"restored {directory / tag} (epoch {meta.get('epoch')})")
    metrics = run.validate(epoch=0)
    run.close()
    print(json.dumps(metrics, indent=2))
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="labelanything_tpu_torch",
        description="LabelAnything on PyTorch and CUDA.")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("experiment",
                       help="run a grid of training runs from a YAML file")
    p.add_argument("--parameters", required=True)
    p.add_argument("--out-dir", default="runs")
    p.add_argument("--parallel", action="store_true",
                   help="not ported yet")
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=_experiment)

    p = sub.add_parser("run", help="one training run (the first grid point)")
    p.add_argument("--parameters", required=True)
    p.add_argument("--out-dir", default="runs/single")
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=_run)

    p = sub.add_parser("validate",
                       help="validate a checkpoint on the validation sets")
    p.add_argument("--parameters", required=True)
    p.add_argument("--out-dir", default="runs/validate")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--reruns", default=None, type=int,
                   help="override val_params.reruns")
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=_validate)

    for name in NOT_PORTED:
        sub.add_parser(name, help="not ported yet")
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in NOT_PORTED:
        print(f"command {argv[0]!r} is not ported to the PyTorch package "
              "yet (ROADMAP A11); use the JAX package's CLI", file=sys.stderr)
        return 2
    args = build_parser().parse_args(argv)
    for key in ("parameters",):
        if not pathlib.Path(getattr(args, key)).exists():
            print(f"--{key}: {getattr(args, key)} does not exist",
                  file=sys.stderr)
            return 2
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
