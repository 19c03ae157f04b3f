"""Command-line interface (counterpart of ``labelanything_tpu/cli.py``;
reference: label_anything/cli.py:12-371), on ``argparse``.

    python -m labelanything_tpu_torch.cli experiment --parameters FILE.yaml
    python -m labelanything_tpu_torch.cli run --parameters FILE.yaml
    python -m labelanything_tpu_torch.cli validate --parameters FILE.yaml \\
        --checkpoint RUN_DIR/checkpoints [--folds 0,2] [--compare REF.json]
    python -m labelanything_tpu_torch.cli test --parameters FILE.yaml
    python -m labelanything_tpu_torch.cli generate_embeddings \\
        --directory IMAGES --instances_path instances.json
    python -m labelanything_tpu_torch.cli generate_embeddings_huggingface \\
        --model_name HF_CHECKPOINT_DIR --directory IMAGES
    python -m labelanything_tpu_torch.cli generate_feature_pyramids \\
        --encoder resnet50 --directory IMAGES
    python -m labelanything_tpu_torch.cli generate_gt --dataset_name coco \\
        --anns_path instances.json --outfolder EMBEDDINGS
    python -m labelanything_tpu_torch.cli preprocess_voc \\
        --input_folder VOC/SegmentationClass
    python -m labelanything_tpu_torch.cli rename_coco20i_json \\
        --instances_path instances.json

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

NOT_PORTED = ("preprocess_clip", "pretrain_pe", "benchmark", "app")


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


def _first_run(args):
    """A ``Run`` of the file's first grid point on ``--device``."""
    from .experiment import Run
    from .utils.config import expand_experiment, load_yaml

    flat = expand_experiment(load_yaml(args.parameters))[0]
    if getattr(args, "reruns", None) is not None:
        flat = {**flat, "val_params": {**flat.get("val_params", {}),
                                       "reruns": args.reruns}}
    return Run().init(flat, run_dir=args.out_dir, device=args.device)


def _validate(args) -> int:
    """With ``--checkpoint``: the fold x rerun protocol of
    ``experiment/evaluate.py`` (every grid point a fold, or ``--folds``).
    Without: the first grid point validated with the seeded initial
    weights, as the JAX CLI does."""
    if args.checkpoint is not None:
        from .experiment.evaluate import evaluate_checkpoint

        folds = ([int(x) for x in args.folds.split(",")] if args.folds
                 else None)
        results = evaluate_checkpoint(
            args.parameters, args.checkpoint, out_dir=args.out_dir,
            folds=folds, reruns=args.reruns, compare=args.compare,
            device=args.device)
        print(json.dumps(results, indent=2))
        return 0
    run = _first_run(args)
    try:
        metrics = run.validate(epoch=0)
    finally:
        run.close()
    print(json.dumps(metrics, indent=2))
    return 0


def _test(args) -> int:
    """The test protocol of the first grid point's ``test_*`` datasets."""
    run = _first_run(args)
    try:
        results = run.test(batch_size=args.batch_size)
    finally:
        run.close()
    print(json.dumps(results, indent=2))
    return 0


def _generate_embeddings(args) -> int:
    """Embed an image folder into safetensors caches (JAX
    ``generate_embeddings``)."""
    from .preprocess import preprocess_images_to_embeddings

    rate = preprocess_images_to_embeddings(
        encoder_name=args.encoder, directory=args.directory,
        instances_path=args.instances_path, checkpoint=args.checkpoint,
        use_sam_checkpoint=args.use_sam_checkpoint,
        batch_size=args.batch_size, num_workers=args.num_workers,
        outfolder=args.outfolder, last_block_dir=args.last_block_dir,
        image_size=args.image_size, custom_preprocess=args.custom_preprocess,
        limit=args.limit, device=args.device)
    print(json.dumps({"images_per_second": rate}))
    return 0


def _generate_embeddings_huggingface(args) -> int:
    """Embed an image folder with a local Hugging Face ViT checkpoint (JAX
    ``generate_embeddings_huggingface``)."""
    from .preprocess import preprocess_images_to_embeddings_huggingface

    rate = preprocess_images_to_embeddings_huggingface(
        model_name=args.model_name, directory=args.directory,
        instances_path=args.instances_path, batch_size=args.batch_size,
        outfolder=args.outfolder, image_resolution=args.image_resolution,
        custom_preprocess=args.custom_preprocess, limit=args.limit,
        device=args.device)
    print(json.dumps({"images_per_second": rate}))
    return 0


def _generate_feature_pyramids(args) -> int:
    """Feature-pyramid caches of an image folder (JAX
    ``generate_feature_pyramids``)."""
    from .preprocess import preprocess_images_to_feature_pyramids

    rate = preprocess_images_to_feature_pyramids(
        encoder_name=args.encoder, directory=args.directory,
        instances_path=args.instances_path, batch_size=args.batch_size,
        outfolder=args.outfolder, image_resolution=args.image_resolution,
        limit=args.limit, device=args.device)
    print(json.dumps({"images_per_second": rate}))
    return 0


def _generate_gt(args) -> int:
    from .preprocess import generate_ground_truths

    generate_ground_truths(args.dataset_name, args.anns_path, args.outfolder)
    return 0


def _preprocess_voc(args) -> int:
    from .preprocess import preprocess_voc

    preprocess_voc(args.input_folder)
    return 0


def _rename_coco20i_json(args) -> int:
    from .preprocess import rename_coco20i_json

    rename_coco20i_json(args.instances_path)
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
    p.add_argument("--checkpoint", default=None,
                   help="a save_pretrained directory, a run's checkpoints "
                        "directory (latest before best) or a weights file: "
                        "runs the fold x rerun protocol of the file")
    p.add_argument("--folds", default=None,
                   help="comma-separated grid (fold) indexes; default all")
    p.add_argument("--reruns", default=None, type=int,
                   help="override val_params.reruns")
    p.add_argument("--compare", default=None,
                   help="a JSON of reference values to report deltas to")
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=_validate)

    p = sub.add_parser("test", help="the test protocol of the test_* sets")
    p.add_argument("--parameters", required=True)
    p.add_argument("--out-dir", default="runs/test")
    p.add_argument("--batch-size", default=8, type=int,
                   help="queries a predict call")
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=_test)

    p = sub.add_parser("generate_embeddings",
                       help="embed an image folder into safetensors caches")
    p.add_argument("--encoder", default="vit_b",
                   help="encoder registry name (vit_b, vit_l, vit_h)")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--use_sam_checkpoint", action="store_true")
    p.add_argument("--directory", required=True)
    p.add_argument("--instances_path", default=None)
    p.add_argument("--batch_size", default=8, type=int)
    p.add_argument("--num_workers", default=16, type=int)
    p.add_argument("--outfolder", default="data/processed/embeddings")
    p.add_argument("--last_block_dir", default=None)
    p.add_argument("--image_size", default=1024, type=int)
    p.add_argument("--custom_preprocess", dest="custom_preprocess",
                   action="store_true", default=True)
    p.add_argument("--square_resize", dest="custom_preprocess",
                   action="store_false")
    p.add_argument("--limit", default=None, type=int)
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=_generate_embeddings,
                   must_exist=("directory", "instances_path"))

    p = sub.add_parser("generate_embeddings_huggingface",
                       help="embed an image folder with a local Hugging "
                            "Face ViT checkpoint")
    p.add_argument("--model_name", required=True,
                   help="local checkpoint directory (config.json + weights)")
    p.add_argument("--directory", required=True)
    p.add_argument("--instances_path", default=None)
    p.add_argument("--batch_size", default=8, type=int)
    p.add_argument("--outfolder", default="data/processed/embeddings")
    p.add_argument("--image_resolution", default=480, type=int)
    p.add_argument("--custom_preprocess", dest="custom_preprocess",
                   action="store_true", default=True)
    p.add_argument("--square_resize", dest="custom_preprocess",
                   action="store_false")
    p.add_argument("--limit", default=None, type=int)
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=_generate_embeddings_huggingface,
                   must_exist=("model_name", "directory", "instances_path"))

    p = sub.add_parser("generate_feature_pyramids",
                       help="feature-pyramid caches of an image folder")
    p.add_argument("--encoder", required=True,
                   help="the pyramid backbone: resnet50 or swin_b")
    p.add_argument("--directory", required=True)
    p.add_argument("--instances_path", default=None)
    p.add_argument("--batch_size", default=4, type=int)
    p.add_argument("--outfolder", default="data/processed/pyramids")
    p.add_argument("--image_resolution", default=384, type=int)
    p.add_argument("--limit", default=None, type=int)
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=_generate_feature_pyramids,
                   must_exist=("directory", "instances_path"))

    p = sub.add_parser("generate_gt",
                       help="add ground-truth maps to embedding caches")
    p.add_argument("--dataset_name", required=True)
    p.add_argument("--anns_path", required=True)
    p.add_argument("--outfolder", required=True)
    p.set_defaults(fn=_generate_gt, must_exist=("anns_path", "outfolder"))

    p = sub.add_parser("preprocess_voc",
                       help="VOC palette masks to class-index PNGs")
    p.add_argument("--input_folder", required=True)
    p.set_defaults(fn=_preprocess_voc, must_exist=("input_folder",))

    p = sub.add_parser("rename_coco20i_json",
                       help="strip COCO 2014 prefixes from file names")
    p.add_argument("--instances_path", required=True)
    p.set_defaults(fn=_rename_coco20i_json, must_exist=("instances_path",))

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
    for key in getattr(args, "must_exist", ("parameters", "compare")):
        value = getattr(args, key, None)
        if value is not None and not pathlib.Path(value).exists():
            print(f"--{key}: {value} does not exist", file=sys.stderr)
            return 2
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
