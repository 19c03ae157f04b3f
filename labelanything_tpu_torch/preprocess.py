"""Offline embedding extraction and the dataset helpers (counterpart of
``labelanything_tpu/preprocess.py``; reference: label_anything/preprocess.py).

:func:`preprocess_images_to_embeddings` streams images through a SAM
encoder (``build_vit_b`` / ``build_vit_l`` / ``build_vit_h``) on the card
and writes one safetensors file per image, ``{"embedding": (C, H, W)}`` in
fp32 named ``<id>.zfill(12).safetensors``: the cache the reference and the
JAX package write, so caches are interchangeable (``data/embeddings.py``
reads them back channels-last). With ``last_block_dir`` the last block's
state (before the neck) goes to a second cache of the same layout, as the
affinity configurations read it.

Images come as ``(image_id, source)`` pairs, the source a file path
(JPEG, PNG or TIFF, decoded by ``data/image_io.py``) or an array already
decoded: :func:`image_files` lists an image folder as the JAX package does
(the instances file's images, else ``*.jpg`` then ``*.png``, sharded by
``LA_SHARD_INDEX`` / ``LA_SHARD_COUNT``), :func:`images_from_directory`
reads a folder of ``.npy`` arrays. Loader threads decode, convert to RGB,
resize on the host (``data/transforms.py``, PIL's BILINEAR bit for bit)
and pad bottom-right; the uint8 batch goes to the card, which normalizes
it with the pad exactly zero. The next batch is queued on the card before
this batch's output is fetched, and files are written by a thread pool.

:func:`preprocess_images_to_embeddings_huggingface` does the same with a
plain ViT (``models/vit.py``) read from a local Hugging Face checkpoint
directory, and :func:`preprocess_images_to_feature_pyramids` writes
``{"stageN": (C, H, W)}`` caches of the ResNet-50 or Swin-B pyramid
backbone, which ``is_pyramids`` models read.

Also here: :func:`generate_ground_truths` (ground-truth maps into the
caches), :func:`preprocess_voc` (VOC masks to class-index PNGs) and
:func:`rename_coco20i_json`. Not ported yet (ROADMAP A10): the CLIP
extractor.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import pathlib
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from .data.image_io import convert, open_image
from .data.png import write_png
from .data.transforms import (IMAGENET_MEAN, IMAGENET_STD, CustomResize,
                              PromptsProcessor, as_rgb, resize_uint8)
from .models.build_encoder import ENCODERS
from .models.build_lam import model_dtype
from .utils.safetensors import load_file, save_file
from .utils.weights import init_weights

logger = logging.getLogger(__name__)

Image = Tuple[str, Union[str, np.ndarray]]


def save_st(tensors: dict, path: str) -> None:
    """``save_file`` with every array made contiguous in its logical order
    first (the JAX ``save_st`` rule: a transposed view written as its raw
    buffer would scramble the cache)."""
    save_file({k: np.ascontiguousarray(v) for k, v in tensors.items()}, path)


def cache_name(image_id) -> str:
    """The cache file of an image: a numeric (COCO) id zero-filled to 12
    digits, as the reference and the JAX package name it; any other id (a
    VOC name, ``2007_000032``) as it is, the name the PASCAL datasets read.
    The JAX package zero-fills every id, so its VOC caches are
    ``02007_000032.safetensors``, which its datasets do not find (ROADMAP
    C25)."""
    name = str(image_id)
    return f"{name.zfill(12) if name.isdigit() else name}.safetensors"


def image_files(instances_path: Optional[str], directory: str
                ) -> List[Tuple[Union[int, str], str]]:
    """``(image_id, path)`` of the images to embed (the JAX
    ``_image_files``): the instances file's images under ``directory``,
    else ``*.jpg`` then ``*.png`` of the folder in name order, the id the
    stem without leading zeros. With ``LA_SHARD_COUNT`` > 1 the worker
    ``LA_SHARD_INDEX`` takes every ``LA_SHARD_COUNT``-th file."""
    if instances_path:
        with open(instances_path) as f:
            instances = json.load(f)
        files = [(img["id"], os.path.join(directory, img["file_name"]))
                 for img in instances["images"]]
    else:
        paths = sorted(pathlib.Path(directory).glob("*.jpg")) + sorted(
            pathlib.Path(directory).glob("*.png"))
        files = [(p.stem.lstrip("0") or "0", str(p)) for p in paths]
    shard = int(os.environ.get("LA_SHARD_INDEX", 0))
    count = int(os.environ.get("LA_SHARD_COUNT", 1))
    if count > 1:
        files = files[shard::count]
        logger.info("worker shard %d/%d: %d images", shard, count, len(files))
    return files


def images_from_directory(directory: str) -> Iterator[Image]:
    """``(image_id, array)`` of every ``.npy`` file of ``directory`` in
    name order, the id being the stem without leading zeros (as the JAX
    package names image files' ids)."""
    for path in sorted(pathlib.Path(directory).glob("*.npy")):
        yield path.stem.lstrip("0") or "0", np.load(path)


def load_one(item: Image, image_size: int, custom_preprocess: bool):
    """Decode a path (to RGB, as PIL's ``convert("RGB")``), resize on the
    host, pad bottom-right into (S, S, 3) uint8: (image_id, padded, (h,
    w) after the resize)."""
    image_id, image = item
    if isinstance(image, (str, os.PathLike)):
        image = convert(open_image(image), target="RGB")
    image = as_rgb(image)
    if custom_preprocess:
        image = CustomResize(image_size)(image)
    elif image.shape[:2] != (image_size, image_size):
        image = resize_uint8(image, (image_size, image_size))
    h, w = image.shape[:2]
    out = np.zeros((image_size, image_size, 3), np.uint8)
    out[:h, :w] = image
    return image_id, out, (h, w)


def normalize(x_u8: torch.Tensor, hw: torch.Tensor) -> torch.Tensor:
    """(B, S, S, 3) uint8 to fp32 ``(x / 255 - mean) / std``, the pad
    outside each image's (h, w) exactly zero (reference:
    transforms.py:27-46, pad after normalize)."""
    s = x_u8.shape[1]
    mean = torch.tensor(IMAGENET_MEAN, device=x_u8.device)
    std = torch.tensor(IMAGENET_STD, device=x_u8.device)
    x = (x_u8.float() / 255.0 - mean) / std
    idx = torch.arange(s, device=x_u8.device)
    valid = ((idx[None, :, None] < hw[:, 0, None, None])
             & (idx[None, None, :] < hw[:, 1, None, None]))
    return torch.where(valid[..., None], x, 0.0)


def _chunks(items: Iterable[Image], size: int) -> Iterator[list]:
    it = iter(items)
    while True:
        chunk = list(itertools.islice(it, size))
        if not chunk:
            return
        yield chunk


def _stream_encode(items: Iterable[Image], *, image_size: int,
                   custom_preprocess: bool, batch_size: int, num_workers: int,
                   encode_fn: Callable, write_fn: Callable,
                   device: torch.device, log_label: str = "images") -> float:
    """The streaming loop shared by the extractors: ``encode_fn(x)`` runs
    the encoder on normalized fp32 pixels (B, S, S, 3) and returns a tensor
    or a tuple of tensors; ``write_fn(image_id, outputs)`` gets them sliced
    per image as host fp32 numpy. Batch n is queued on the card, with the
    copy of its outputs to pinned host memory, before batch n - 1's copy is
    waited on and handed to the writers. Returns images a second."""
    cuda = device.type == "cuda"

    def queue(chunk):
        ids = [c[0] for c in chunk]
        arrs = np.stack([c[1] for c in chunk])
        hws = np.asarray([c[2] for c in chunk], np.int32)
        pad = batch_size - len(ids)
        if pad:     # one batch shape for every call
            arrs = np.concatenate([arrs, np.zeros((pad,) + arrs.shape[1:],
                                                  arrs.dtype)])
            hws = np.concatenate([hws, np.zeros((pad, 2), np.int32)])
        x = torch.from_numpy(arrs)
        hw = torch.from_numpy(hws)
        if cuda:
            x, hw = x.pin_memory(), hw.pin_memory()
        x = x.to(device, non_blocking=True)
        hw = hw.to(device, non_blocking=True)
        with torch.no_grad():
            out = encode_fn(normalize(x, hw))
        outs = out if isinstance(out, tuple) else (out,)
        host = []
        for o in outs:
            buf = torch.empty(o.shape, dtype=torch.float32, pin_memory=cuda)
            buf.copy_(o, non_blocking=cuda)
            host.append(buf)
        done = torch.cuda.Event() if cuda else None
        if cuda:
            done.record()
        return ids, host, done, isinstance(out, tuple)

    def hand_over(in_flight, pending, write_pool):
        ids, host, done, is_tuple = in_flight
        if done is not None:
            done.synchronize()
        arrays = [h.numpy() for h in host]
        for i, image_id in enumerate(ids):
            per_image = tuple(a[i] for a in arrays)
            pending.append(write_pool.submit(
                write_fn, image_id, per_image if is_tuple else per_image[0]))

    t0 = time.perf_counter()
    count = 0
    with ThreadPoolExecutor(max(1, num_workers)) as io_pool, \
            ThreadPoolExecutor(4) as write_pool:
        loaded = io_pool.map(
            lambda chunk: [load_one(item, image_size, custom_preprocess)
                           for item in chunk], _chunks(items, batch_size))
        pending, in_flight = [], None
        for chunk in loaded:
            queued = queue(chunk)
            if in_flight is not None:
                hand_over(in_flight, pending, write_pool)
            in_flight = queued
            count += len(chunk)
        if in_flight is not None:
            hand_over(in_flight, pending, write_pool)
        for f in pending:
            f.result()
    rate = count / (time.perf_counter() - t0)
    logger.info("finished: %d %s at %.2f images/sec", count, log_label, rate)
    return rate


def load_encoder_checkpoint(encoder: torch.nn.Module, checkpoint: str,
                            use_sam_checkpoint: bool = False) -> None:
    """Load the encoder's weights from a reference-layout checkpoint
    (``.safetensors``, or a ``torch.save`` file); with
    ``use_sam_checkpoint`` a whole SAM model's, whose ``image_encoder.``
    entries are the encoder's."""
    from .api import load_weights_file

    state = load_weights_file(checkpoint)
    if use_sam_checkpoint:
        state = {k[len("image_encoder."):]: v for k, v in state.items()
                 if k.startswith("image_encoder.")}
    encoder.load_state_dict(state, strict=True)


def preprocess_images_to_embeddings(
        encoder_name: str, images: Optional[Iterable[Image]] = None,
        directory: Optional[str] = None, instances_path: Optional[str] = None,
        checkpoint: Optional[str] = None, use_sam_checkpoint: bool = False,
        batch_size: int = 8, num_workers: int = 16,
        outfolder: str = "data/processed/embeddings",
        last_block_dir: Optional[str] = None, image_size: int = 1024,
        custom_preprocess: bool = True,
        dtype: Union[str, torch.dtype] = torch.bfloat16,
        limit: Optional[int] = None,
        device: Union[str, torch.device] = "cuda", seed: int = 0) -> float:
    """Embed ``images`` (``(image_id, path or array)`` pairs), or the
    image files of ``directory`` (:func:`image_files` with
    ``instances_path``), with the SAM encoder ``encoder_name`` ("vit_b",
    "vit_l", "vit_h") into ``outfolder`` (and ``last_block_dir``), on
    ``device`` (the first CUDA card unless named). The weights come from
    ``checkpoint``, else from ``seed``. Returns images a second
    (reference: preprocess.py:78-141,143-175)."""
    images = _images(images, directory, instances_path, limit)
    device = torch.device(device)
    os.makedirs(outfolder, exist_ok=True)
    if last_block_dir:
        os.makedirs(last_block_dir, exist_ok=True)
    with torch.device("meta"):
        encoder = ENCODERS[encoder_name](project_last_hidden=True,
                                         dtype=model_dtype(dtype),
                                         image_size=image_size)
    encoder = encoder.to_empty(device=device).eval()
    if checkpoint:
        load_encoder_checkpoint(encoder, checkpoint, use_sam_checkpoint)
    else:
        init_weights(encoder, seed)
    want_last_block = last_block_dir is not None

    def encode_fn(x):
        if want_last_block:
            out = encoder(x, return_last_block_state=True)
            return out["last_hidden_state"], out["last_block_state"]
        return encoder(x)

    def write_fn(image_id, out):
        hidden, last_block = out if want_last_block else (out, None)
        save_st({"embedding": hidden.transpose(2, 0, 1)},
                os.path.join(outfolder, cache_name(image_id)))
        if last_block is not None:
            save_st({"embedding": last_block.transpose(2, 0, 1)},
                    os.path.join(last_block_dir, cache_name(image_id)))

    return _stream_encode(images, image_size=image_size,
                          custom_preprocess=custom_preprocess,
                          batch_size=batch_size, num_workers=num_workers,
                          encode_fn=encode_fn, write_fn=write_fn,
                          device=device)


def _images(images, directory, instances_path, limit):
    if (images is None) == (directory is None):
        raise ValueError("give images or directory, one of them")
    if images is None:
        images = image_files(instances_path, directory)
    return itertools.islice(images, limit) if limit else images


def preprocess_images_to_embeddings_huggingface(
        model_name: str, images: Optional[Iterable[Image]] = None,
        directory: Optional[str] = None, instances_path: Optional[str] = None,
        batch_size: int = 8, num_workers: int = 16,
        outfolder: str = "data/processed/embeddings",
        image_resolution: int = 480, custom_preprocess: bool = True,
        dtype: Union[str, torch.dtype] = torch.bfloat16,
        limit: Optional[int] = None,
        device: Union[str, torch.device] = "cuda") -> float:
    """Embed images with the plain ViT of a local Hugging Face checkpoint
    directory ``model_name`` (``config.json`` and ``model.safetensors``, read
    by the port's own reader, or ``pytorch_model.bin``; nothing is
    downloaded), sized from its config, at ``image_resolution`` (the
    position table interpolated as the JAX package does), on ``device``.
    Writes ``{"embedding": (C, H, W)}`` caches; returns images a second
    (reference: preprocess.py:210-258; JAX ``preprocess.py:224-284``)."""
    from .api import load_weights_file
    from .models.vit import StandardViT

    ckpt = pathlib.Path(model_name)
    with open(ckpt / "config.json") as f:
        cfg = json.load(f)
    weights = next((ckpt / n for n in ("model.safetensors",
                                       "pytorch_model.bin")
                    if (ckpt / n).exists()), None)
    if weights is None:
        raise FileNotFoundError(f"no weights under {ckpt}")
    device = torch.device(device)
    patch, width = cfg.get("patch_size", 16), cfg.get("hidden_size", 768)
    with torch.device("meta"):
        encoder = StandardViT(
            patch_size=patch, embed_dim=width,
            depth=cfg.get("num_hidden_layers", 12),
            num_heads=cfg.get("num_attention_heads", 12),
            mlp_ratio=cfg.get("intermediate_size", 3072) / width,
            pretrain_grid=cfg.get("image_size", 224) // patch,
            layernorm_eps=cfg.get("layer_norm_eps", 1e-12),
            dtype=model_dtype(dtype))
    encoder = encoder.to_empty(device=device).eval()
    # a ViTModel's state dict but its pooler, which the encoder does not run
    encoder.load_state_dict({k: v for k, v in load_weights_file(
        str(weights)).items() if not k.startswith("pooler.")}, strict=True)
    os.makedirs(outfolder, exist_ok=True)

    def write_fn(image_id, emb):
        save_st({"embedding": emb.transpose(2, 0, 1)},
                os.path.join(outfolder, cache_name(image_id)))

    return _stream_encode(_images(images, directory, instances_path, limit),
                          image_size=image_resolution,
                          custom_preprocess=custom_preprocess,
                          batch_size=batch_size, num_workers=num_workers,
                          encode_fn=encoder, write_fn=write_fn, device=device,
                          log_label="hf images")


PYRAMID_ENCODERS = ("resnet50", "swin_b")


def load_pyramid_checkpoint(backbone: torch.nn.Module, encoder_name: str,
                            checkpoint: str) -> None:
    """A torchvision ResNet-50 or an original Swin-B checkpoint into the
    pyramid backbone, through the key maps of PPNet's and DCAMA's
    backbones (the JAX ``convert_ppnet_state_dict`` /
    ``convert_dcama_state_dict``): the classifier and the tables the port
    computes dropped. The Swin stage norms, which such a checkpoint does
    not hold, take the identity (flax's initial values, which the JAX
    extractor keeps)."""
    from .api import load_weights_file
    from .utils.weights import reference_baseline_state_dict

    state = load_weights_file(checkpoint)
    if encoder_name == "resnet50":
        state = {f"resnet.{k}": v for k, v in state.items()
                 if not k.startswith("fc.")}
        backbone.load_state_dict(state, strict=True)
        return
    state = reference_baseline_state_dict(
        "dcama", {f"feature_extractor.{k}": v for k, v in state.items()})
    state = {"swin." + k[len("feature_extractor."):]: v
             for k, v in state.items()}
    for key, value in backbone.state_dict().items():
        if key.startswith("norm_stage"):
            state[key] = (torch.ones_like(value) if key.endswith("weight")
                          else torch.zeros_like(value))
    backbone.load_state_dict(state, strict=True)


def preprocess_images_to_feature_pyramids(
        encoder_name: str, images: Optional[Iterable[Image]] = None,
        directory: Optional[str] = None, instances_path: Optional[str] = None,
        batch_size: int = 4, num_workers: int = 16,
        outfolder: str = "data/processed/pyramids",
        image_resolution: int = 384, limit: Optional[int] = None,
        checkpoint: Optional[str] = None,
        device: Union[str, torch.device] = "cuda") -> float:
    """Feature-pyramid caches ``{"stageN": (C, H, W)}`` of stages 2 to 4
    of the ResNet-50 or Swin-B backbone (``models/pyramid_encoders.py``) in
    fp32 on ``device``, from images resized as the embedding extractors
    resize them (long side, then padding), its weights from ``checkpoint``
    (:func:`load_pyramid_checkpoint`) or else seeded with 0 (reference: preprocess.py:262-322; JAX
    ``preprocess.py:343-437``). The JAX package takes any other name to
    ``transformers.AutoBackbone`` on the host, which the card's machine
    does not have: here it is refused."""
    if encoder_name not in PYRAMID_ENCODERS:
        raise ValueError(f"encoder {encoder_name!r}: the feature-pyramid "
                         f"extractor takes {' or '.join(PYRAMID_ENCODERS)} "
                         f"(other backbones go through transformers' "
                         f"AutoBackbone in the JAX package)")
    device = torch.device(device)
    out_features = ("stage2", "stage3", "stage4")
    kwargs = {"out_features": out_features}
    if encoder_name == "swin_b":
        kwargs["image_size"] = image_resolution
    with torch.device("meta"):
        backbone = ENCODERS[encoder_name](**kwargs)
    backbone = backbone.to_empty(device=device).eval()
    if checkpoint:
        load_pyramid_checkpoint(backbone, encoder_name, checkpoint)
    else:
        init_weights(backbone, 0)
    os.makedirs(outfolder, exist_ok=True)

    def encode_fn(x):
        stages = backbone(x)
        return tuple(stages[s] for s in out_features)

    def write_fn(image_id, maps):
        save_st({s: m.transpose(2, 0, 1) for s, m in zip(out_features, maps)},
                os.path.join(outfolder, cache_name(image_id)))

    return _stream_encode(_images(images, directory, instances_path, limit),
                          image_size=image_resolution,
                          custom_preprocess=True,
                          batch_size=batch_size, num_workers=num_workers,
                          encode_fn=encode_fn, write_fn=write_fn,
                          device=device, log_label="pyramids")


def generate_ground_truths(dataset_name: str, anns_path: str, outfolder: str,
                           custom_preprocess: bool = True) -> None:
    """Add each image's ground-truth map, ``{dataset_name}_gt`` (H, W)
    int64 of category ids (the largest id where instances overlap), to
    its cache in ``outfolder`` (reference: preprocess.py:28-50)."""
    with open(anns_path) as f:
        anns = json.load(f)
    pp = PromptsProcessor(custom_preprocess=custom_preprocess)
    by_image: dict = {}
    for ann in anns["annotations"]:
        by_image.setdefault(ann["image_id"], []).append(ann)
    for image in anns["images"]:
        h, w = image["height"], image["width"]
        gt = np.zeros((h, w), np.int64)
        for ann in by_image.get(image["id"], []):
            mask = pp.convert_mask(ann["segmentation"], h, w).astype(np.int64)
            mask[mask == 1] = ann["category_id"]
            gt = np.maximum(gt, mask)
        path = os.path.join(outfolder, cache_name(image["id"]))
        loaded = {k: v.numpy() for k, v in load_file(path).items()}
        loaded[f"{dataset_name}_gt"] = gt
        save_st(loaded, path)


def preprocess_voc(input_folder: str) -> None:
    """VOC's palette masks (``SegmentationClass/*.png``) to class-index
    masks in ``<input_folder>Processed`` beside it: each file's indices
    (a grayscale mask's levels) written as an 8-bit grayscale PNG
    (reference: data/voc12.py preprocess_voc)."""
    folder = pathlib.Path(input_folder)
    out_dir = folder.parent / (folder.name + "Processed")
    out_dir.mkdir(exist_ok=True)
    for path in sorted(folder.glob("*.png")):
        arr = convert(open_image(path), target="P")
        write_png(str(out_dir / path.name), arr.astype(np.uint8))
    logger.info("VOC masks processed into %s", out_dir)


def rename_coco20i_json(instances_path: str) -> None:
    """Strip COCO 2014's ``COCO_train2014_`` style prefix from every image's
    ``file_name``, in place (reference: preprocess.py:325-336)."""
    with open(instances_path) as f:
        anns = json.load(f)
    for image in anns["images"]:
        image["file_name"] = image["file_name"].split("_")[-1]
    with open(instances_path, "w") as f:
        json.dump(anns, f)
