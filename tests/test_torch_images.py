"""The port's images path against PIL and the JAX package, on the CPU:

* ``data/image_io.py``'s ``convert`` against PIL's, mode by mode, and the
  format sniffing of ``open_image``;
* ``preprocess.image_files`` and its sharding against the JAX
  ``_image_files``; ``generate_ground_truths``, ``preprocess_voc`` and
  ``rename_coco20i_json`` against the JAX functions, and the four CLI
  commands;
* the first batches of the COCO engine on an image folder (JPEG and PNG
  files written by PIL) against the JAX engine's uint8 ingest, and PASCAL
  episodes on ``JPEGImages``, bit for bit, with the faults of C11 taken
  out of the JAX side as ``tests/test_torch_data.py`` does;
* the items and support batch of the four cross-domain sets on roots in
  their folder layouts, bit for bit;
* for the slice as a whole, two ``Run`` steps of ``COCO_vit.yaml``'s
  ``lam_b`` (a toy ViT of 2 blocks, 128 wide, in ViT-B's place) on an
  image root against the JAX ``Run`` from the same weights, fp32, rtol
  1e-3, atol 5e-4 (the golden harness's);
* C13: ``parameters/test/*.yaml``'s ``lam_no_vit`` on the images that the
  cross-domain sets yield fails in both packages.
"""

import json
import os
import pathlib
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from labelanything_tpu import preprocess as jpre
from labelanything_tpu.data import coco as jcoco
from labelanything_tpu.data import crossdomain as jcross
from labelanything_tpu.data import dataset as jds
from labelanything_tpu.data import loader as jloader
from labelanything_tpu.experiment import run as jrun
from labelanything_tpu.models import build_lam as jbl
from labelanything_tpu.models.image_encoder import ImageEncoderViT as JViT
from labelanything_tpu.parallel import mesh as jmesh
from labelanything_tpu_torch import cli, preprocess
from labelanything_tpu_torch.data import crossdomain as tcross
from labelanything_tpu_torch.data import dataset as tds
from labelanything_tpu_torch.data import image_io
from labelanything_tpu_torch.data import loader as tloader
from labelanything_tpu_torch.data.synthetic_coco import (COCO_CATEGORY_IDS,
                                                         write_synthetic_coco)
from labelanything_tpu_torch.data.synthetic_crossdomain import (
    write_brain, write_dram, write_kvasir, write_weedmap)
from labelanything_tpu_torch.data.transforms import normalize_padded
from labelanything_tpu_torch.experiment import Run
from labelanything_tpu_torch.models import build_lam as tbl
from labelanything_tpu_torch.models import prompt_encoder as tpe
from labelanything_tpu_torch.models.build_encoder import ENCODERS
from labelanything_tpu_torch.models.image_encoder import ImageEncoderViT
from labelanything_tpu_torch.typing import BatchKeys
from labelanything_tpu_torch.utils import safetensors as st
from labelanything_tpu_torch.utils.config import expand_experiment, load_yaml
from labelanything_tpu_torch.utils.weights import state_dict_from_jax
from tests.test_torch_data import (JaxSamplerEpisodeTypesWhole,
                                   assert_batches_equal, first_batches)
from tests.test_torch_image_encoder import TOY_VIT
from tests.test_torch_run import read_metrics
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-3, atol=5e-4)


def _scene(rng, h, w, channels=3):
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(xx * 5 + yy * 3 + 40 * c) % 256
                     for c in range(channels)], -1)
    out = np.clip(base + rng.integers(-30, 30, base.shape), 0, 255)
    return out.astype(np.uint8)


# ---- image_io ---------------------------------------------------------------- #

def _pil(array, mode, palette=None):
    im = Image.fromarray(array) if mode not in ("CMYK", "P", "LA") \
        else Image.fromarray(array, mode)
    if palette is not None:
        im.putpalette(palette.ravel().tolist())
    return im


@pytest.mark.parametrize("mode", ["L", "LA", "P", "RGB", "RGBA", "CMYK",
                                  "I;16"])
def test_convert_matches_pil(mode):
    rng = np.random.default_rng(len(mode))
    h, w = 13, 17
    channels = {"L": 1, "LA": 2, "P": 1, "RGB": 3, "RGBA": 4, "CMYK": 4,
                "I;16": 1}[mode]
    if mode == "I;16":
        array = rng.integers(0, 600, (h, w)).astype(np.uint16)
    else:
        array = rng.integers(0, 256, (h, w, channels), dtype=np.uint8)
        array = array[..., 0] if channels == 1 else array
    # a short palette: indices past it read as black
    palette = (rng.integers(0, 256, (200, 3), dtype=np.uint8)
               if mode == "P" else None)
    im = _pil(array, mode, palette)
    assert im.mode == mode
    for target in ("RGB", "L", "P"):
        if target == "P" and mode not in ("L", "P"):
            with pytest.raises(ValueError, match="web palette"):
                image_io.convert(array, mode, target, palette)
            continue
        np.testing.assert_array_equal(
            image_io.convert(array, mode, target, palette),
            np.asarray(im.convert(target)), err_msg=f"{mode} -> {target}")


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_resize_matches_pil(channels):
    """PIL's BILINEAR resize, bit for bit, by the C passes and the numpy
    twin: up and down, one axis or both, to and from one pixel."""
    from labelanything_tpu_torch.data.transforms import (resize_uint8,
                                                         resize_uint8_plain)

    rng = np.random.default_rng(channels)
    mode = {1: "L", 3: "RGB", 4: "RGBA"}[channels]
    for _ in range(40):
        h, w = (int(v) for v in rng.integers(1, 70, 2))
        oh, ow = (int(v) for v in rng.integers(1, 140, 2))
        if rng.random() < 0.3:
            oh = h if rng.random() < 0.5 else oh
            ow = w if oh != h else ow
        image = rng.integers(0, 256, (h, w, channels), dtype=np.uint8)
        image = image[..., 0] if channels == 1 else image
        ref = Image.fromarray(image, mode)
        if mode == "RGBA":     # PIL premultiplies RGBA: resize RGB planes
            ref = Image.fromarray(image[..., :3])
            image = image[..., :3]
        ref = np.asarray(ref.resize((ow, oh), Image.BILINEAR))
        np.testing.assert_array_equal(resize_uint8(image, (oh, ow)), ref)
        np.testing.assert_array_equal(resize_uint8_plain(image, (oh, ow)),
                                      ref)


def test_open_image_sniffs_the_format(tmp_path):
    rng = np.random.default_rng(0)
    image = _scene(rng, 9, 11)
    for fmt, ext in (("JPEG", "jpg"), ("PNG", "png"), ("TIFF", "tif")):
        # the extension lies: the signature decides
        path = tmp_path / f"image.{'bin' if ext == 'png' else ext}"
        Image.fromarray(image).save(path, fmt)
        got = image_io.open_image(path)
        with Image.open(path) as im:
            assert got.mode == im.mode
            np.testing.assert_array_equal(got.array, np.asarray(im))
    (tmp_path / "x.gif").write_bytes(b"GIF89a" + bytes(20))
    with pytest.raises(ValueError, match="unknown image format"):
        image_io.open_image(tmp_path / "x.gif")


# ---- the preprocess helpers ------------------------------------------------ #

def test_image_files_and_sharding_match_jax(tmp_path, monkeypatch):
    folder = tmp_path / "images"
    folder.mkdir()
    for name in ("000000000042.jpg", "000000000007.png", "000000000000.jpg",
                 "000000000100.jpg", "000000000003.png", "notes.txt"):
        (folder / name).write_bytes(b"")
    instances = tmp_path / "instances.json"
    instances.write_text(json.dumps({"images": [
        {"id": 5, "file_name": "b.jpg"}, {"id": 2, "file_name": "a.jpg"}]}))
    for shard in (None, (0, 2), (1, 2), (2, 3)):
        if shard is None:
            monkeypatch.delenv("LA_SHARD_INDEX", raising=False)
            monkeypatch.delenv("LA_SHARD_COUNT", raising=False)
        else:
            monkeypatch.setenv("LA_SHARD_INDEX", str(shard[0]))
            monkeypatch.setenv("LA_SHARD_COUNT", str(shard[1]))
        for inst in (None, str(instances)):
            got = preprocess.image_files(inst, str(folder))
            assert got == jpre._image_files(inst, str(folder))
    monkeypatch.delenv("LA_SHARD_INDEX")
    monkeypatch.delenv("LA_SHARD_COUNT")
    assert [i for i, _ in preprocess.image_files(None, str(folder))] == [
        "0", "42", "100", "3", "7"]


@pytest.fixture(scope="module")
def image_root(tmp_path_factory):
    """A synthetic COCO root whose images are JPEGs that PIL wrote (every
    fourth a PNG from the port's writer), with 8-wide caches on a 4 x 4
    grid."""
    root = tmp_path_factory.mktemp("image_root")
    rng = np.random.default_rng(7)
    sources = []
    for i, (h, w) in enumerate([(48, 64), (64, 48), (40, 64), (72, 96),
                                (33, 47)]):
        path = root / f"source{i}.jpg"
        Image.fromarray(_scene(rng, h, w)).save(
            path, quality=85, subsampling=i % 3)
        sources.append(str(path))
    return write_synthetic_coco(
        str(root / "coco"), seed=3, num_images=24, embed_dim=8, grid=4,
        sizes=((48, 64), (64, 48)), category_ids=COCO_CATEGORY_IDS[:8],
        classes_per_image=3, image_sources=sources)


def test_synthetic_image_root_has_its_files_sizes(image_root):
    instances = json.loads(pathlib.Path(image_root["instances_path"])
                           .read_text())
    kinds = set()
    for image in instances["images"]:
        path = os.path.join(image_root["img_dir"], image["file_name"])
        with Image.open(path) as im:
            assert (im.height, im.width) == (image["height"], image["width"])
            kinds.add(im.format)
    assert kinds == {"JPEG", "PNG"}


def test_generate_ground_truths_matches_jax(image_root, tmp_path):
    dirs = {}
    for pkg in ("jax", "port"):
        dirs[pkg] = tmp_path / pkg
        shutil.copytree(image_root["emb_dir"], dirs[pkg])
    jpre.generate_ground_truths("coco", image_root["instances_path"],
                                str(dirs["jax"]))
    assert cli.main(["generate_gt", "--dataset_name", "coco", "--anns_path",
                     image_root["instances_path"], "--outfolder",
                     str(dirs["port"])]) == 0
    names = sorted(os.listdir(dirs["jax"]))
    assert names == sorted(os.listdir(dirs["port"])) and len(names) == 24
    for name in names:
        ours = st.load_file(str(dirs["port"] / name))
        ref = st.load_file(str(dirs["jax"] / name))
        assert sorted(ours) == sorted(ref) == ["coco_gt", "embedding"]
        for key in ref:
            assert ours[key].dtype == ref[key].dtype
            assert torch.equal(ours[key], ref[key]), (name, key)
        assert ours["coco_gt"].max() > 0


def test_preprocess_voc_and_rename_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    for pkg in ("jax", "port"):
        folder = tmp_path / pkg / "SegmentationClass"
        folder.mkdir(parents=True)
        for i in range(4):
            arr = rng.integers(0, 22, (23 + i, 31), dtype=np.uint8)
            arr[0, :5] = 255
            im = (Image.fromarray(arr, "P") if i % 2 == 0
                  else Image.fromarray(arr))            # P and L masks
            if i % 2 == 0:
                im.putpalette(list(range(256)) * 3)
            im.save(folder / f"2007_{i:06d}.png")
        rng = np.random.default_rng(2)     # the same masks for both
    jpre.preprocess_voc(str(tmp_path / "jax" / "SegmentationClass"))
    assert cli.main(["preprocess_voc", "--input_folder",
                     str(tmp_path / "port" / "SegmentationClass")]) == 0
    out = {pkg: tmp_path / pkg / "SegmentationClassProcessed"
           for pkg in ("jax", "port")}
    names = sorted(os.listdir(out["jax"]))
    assert names == sorted(os.listdir(out["port"])) and len(names) == 4
    for name in names:
        with Image.open(out["jax"] / name) as a, \
                Image.open(out["port"] / name) as b:
            assert a.mode == b.mode == "L"
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    anns = {"images": [{"id": 1, "file_name": "COCO_train2014_000000000001.jpg"},
                       {"id": 2, "file_name": "000000000002.jpg"}],
            "annotations": []}
    for pkg in ("jax", "port"):
        (tmp_path / f"{pkg}.json").write_text(json.dumps(anns))
    jpre.rename_coco20i_json(str(tmp_path / "jax.json"))
    assert cli.main(["rename_coco20i_json", "--instances_path",
                     str(tmp_path / "port.json")]) == 0
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads(
        (tmp_path / "jax.json").read_text())


def test_cli_generate_embeddings_reads_the_folder(image_root, tmp_path,
                                                  monkeypatch):
    """``generate_embeddings`` with the JAX option names on the CPU (a toy
    encoder in ViT-B's place): one cache an image of the instances file,
    each the encoder's output on that image's decoded, resized frame."""
    monkeypatch.setitem(ENCODERS, "vit_b", lambda project_last_hidden, dtype,
                        image_size: ImageEncoderViT(dtype=dtype, **dict(
                            TOY_VIT, img_size=64, depth=1,
                            global_attn_indexes=(0,))))
    out = tmp_path / "emb"
    assert cli.main(["generate_embeddings", "--directory",
                     image_root["img_dir"], "--instances_path",
                     image_root["instances_path"], "--outfolder", str(out),
                     "--image_size", "64", "--batch_size", "4",
                     "--num_workers", "2", "--limit", "6",
                     "--device", "cpu"]) == 0
    names = sorted(os.listdir(out))
    assert names == [f"{i:012d}.safetensors" for i in range(1, 7)]
    cache = st.load_file(str(out / names[0]))["embedding"]
    assert tuple(cache.shape) == (32, 4, 4) and torch.isfinite(cache).all()


def _hf_checkpoint(path: pathlib.Path) -> pathlib.Path:
    """A seeded local Hugging Face ViT checkpoint directory: ``config.json``
    and ``model.safetensors`` (with a pooler, which the extractors drop)
    written by the port, a 2 x 2 pretraining grid."""
    from labelanything_tpu_torch.models.vit import StandardViT
    from labelanything_tpu_torch.utils.weights import init_weights

    path.mkdir()
    (path / "config.json").write_text(json.dumps(dict(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=64, image_size=32, patch_size=16,
        layer_norm_eps=1e-12)))
    vit = StandardViT(patch_size=16, embed_dim=32, depth=2, num_heads=2,
                      mlp_ratio=2.0, pretrain_grid=2)
    init_weights(vit, 4)
    state = dict(vit.state_dict(), **{"pooler.dense.weight": torch.ones(32, 32),
                                      "pooler.dense.bias": torch.ones(32)})
    st.save_file(state, str(path / "model.safetensors"))
    return path


def _caches_close(ours: pathlib.Path, ref: pathlib.Path, keys,
                  names=None) -> None:
    """Six caches of ``ours`` within the fp32 tolerance of ``ref``'s, by
    name, or ``names``: (ours, ref) pairs."""
    if names is None:
        names = [(n, n) for n in sorted(os.listdir(ref))]
        assert sorted(os.listdir(ours)) == [n for n, _ in names]
    assert len(names) == 6
    for mine, theirs in names:
        got = st.load_file(str(ours / mine))
        want = st.load_file(str(ref / theirs))
        assert sorted(got) == sorted(want) == sorted(keys)
        for key in keys:
            np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                       rtol=1e-3, atol=5e-4,
                                       err_msg=f"{mine} {key}")


def test_cli_generate_embeddings_huggingface_matches_jax(image_root,
                                                         tmp_path):
    """The Hugging Face extractor on a seeded local checkpoint, fp32, at
    64 px (the 2 x 2 position table interpolated to 4 x 4): the port writes
    the JAX extractor's caches; its CLI (bf16) exits 0."""
    import jax.numpy as jnp

    ckpt = str(_hf_checkpoint(tmp_path / "vit"))
    common = dict(directory=image_root["img_dir"],
                  instances_path=image_root["instances_path"], batch_size=4,
                  num_workers=2, image_resolution=64, limit=6)
    jpre.preprocess_images_to_embeddings_huggingface(
        ckpt, outfolder=str(tmp_path / "jax"), dtype=jnp.float32, **common)
    preprocess.preprocess_images_to_embeddings_huggingface(
        ckpt, outfolder=str(tmp_path / "port"), dtype=torch.float32,
        device="cpu", **common)
    _caches_close(tmp_path / "port", tmp_path / "jax", ["embedding"])
    # the command as users run it (bf16, the JAX command's dtype)
    assert cli.main([
        "generate_embeddings_huggingface", "--model_name", ckpt,
        "--directory", image_root["img_dir"], "--instances_path",
        image_root["instances_path"], "--outfolder", str(tmp_path / "cli"),
        "--image_resolution", "64", "--batch_size", "4", "--limit", "2",
        "--device", "cpu"]) == 0
    cache = st.load_file(str(tmp_path / "cli" / "000000000001.safetensors"))
    assert tuple(cache["embedding"].shape) == (32, 4, 4)
    ref = st.load_file(str(tmp_path / "jax" / "000000000001.safetensors"))
    rel = (cache["embedding"] - ref["embedding"]).norm() / ref[
        "embedding"].norm()
    assert rel < 5e-2        # bf16 against fp32, as phase 25's caches


def test_generate_feature_pyramids_matches_jax_and_c25(image_root, tmp_path,
                                                       monkeypatch):
    """ResNet-50's pyramid (its blocks cut to one a layer in both
    packages) from a torchvision-layout ``.pth`` at 64 px, on a folder of
    VOC-named JPEGs: stage 2 to 4 caches equal to the JAX extractor's. The
    JAX extractor zero-fills the names to 12 characters
    (``02007_000001``), where the PASCAL datasets of both packages read
    ``<name>.safetensors``; the port names such a cache as the image, a
    numeric id as JAX does (C25). The CLI (seeded weights) exits 0;
    another backbone name is refused."""
    from labelanything_tpu.models import build_encoder as jbe
    from labelanything_tpu.models import pyramid_encoders as jpe
    from labelanything_tpu_torch.models import pyramid_encoders as tpe
    from labelanything_tpu_torch.utils.weights import init_weights

    monkeypatch.setitem(jbe.ENCODERS, "resnet50", lambda **kw:
                        jpe.build_resnet50(layers=(1, 1, 1, 1), **kw))
    monkeypatch.setitem(ENCODERS, "resnet50", lambda **kw:
                        tpe.build_resnet50(layers=(1, 1, 1, 1), **kw))
    backbone = tpe.build_resnet50(layers=(1, 1, 1, 1))
    init_weights(backbone, 5)
    state = {k[len("resnet."):]: v for k, v in backbone.state_dict().items()}
    state.update({"fc.weight": torch.ones(10, 2048), "fc.bias": torch.ones(10)})
    pth = str(tmp_path / "resnet50.pth")
    torch.save(state, pth)
    folder = tmp_path / "JPEGImages"
    folder.mkdir()
    sources = sorted(pathlib.Path(image_root["img_dir"]).glob("*.jpg"))[:6]
    names = [f"2007_00000{i}" for i in range(6)]
    for name, src in zip(names, sources):
        shutil.copy(src, folder / f"{name}.jpg")
    common = dict(directory=str(folder), batch_size=4, image_resolution=64,
                  checkpoint=pth)
    jpre.preprocess_images_to_feature_pyramids(
        "resnet50", outfolder=str(tmp_path / "jax"), **common)
    preprocess.preprocess_images_to_feature_pyramids(
        "resnet50", outfolder=str(tmp_path / "port"), num_workers=2,
        device="cpu", **common)
    assert sorted(os.listdir(tmp_path / "jax")) == [
        f"0{n}.safetensors" for n in names]
    assert sorted(os.listdir(tmp_path / "port")) == [
        f"{n}.safetensors" for n in names]
    assert preprocess.cache_name(42) == "000000000042.safetensors"
    stages = ["stage2", "stage3", "stage4"]
    _caches_close(tmp_path / "port", tmp_path / "jax", stages,
                  [(f"{n}.safetensors", f"0{n}.safetensors") for n in names])

    out = tmp_path / "cli"
    assert cli.main(["generate_feature_pyramids", "--encoder", "resnet50",
                     "--directory", image_root["img_dir"], "--instances_path",
                     image_root["instances_path"], "--outfolder", str(out),
                     "--image_resolution", "64", "--limit", "2",
                     "--device", "cpu"]) == 0
    cache = st.load_file(str(out / "000000000002.safetensors"))
    assert [tuple(cache[s].shape) for s in stages] == [
        (512, 8, 8), (1024, 4, 4), (2048, 2, 2)]
    with pytest.raises(ValueError, match="resnet50 or swin_b"):
        preprocess.preprocess_images_to_feature_pyramids(
            "microsoft/resnet-50", images=[], device="cpu")


# ---- the episode engines ---------------------------------------------------- #

class _JaxUint8(jds.LabelAnythingDataset):
    """The JAX dataset union with its uint8 ingest on
    (``device_normalize=True``), the form the port's image episodes take."""

    def __init__(self, datasets_params, common_params, **kw):
        datasets_params = {k: {**v, "device_normalize": True}
                           for k, v in datasets_params.items()}
        super().__init__(datasets_params, common_params, **kw)


@pytest.mark.parametrize("split", ["train", "val"])
def test_coco_image_episodes_match_jax(image_root, monkeypatch, split):
    """mae.yaml's engine (thread loader, 2 workers) on the image folder:
    the first 6 batches' uint8 frames, dims, resized dims, prompts and
    ground truths, bit for bit."""
    monkeypatch.setattr(jcoco.CocoLVISDataset, "instances_path",
                        image_root["instances_path"], raising=False)
    paths = {"instances_path": image_root["instances_path"],
             "img_dir": image_root["img_dir"], "emb_dir": None}
    with monkeypatch.context() as m:
        m.setattr(jds, "LabelAnythingDataset", _JaxUint8)
        expected = first_batches(jds, jloader, paths, split, num_workers=2)
    got = first_batches(tds, tloader, paths, split, num_workers=2)
    assert len(got) == 6
    assert_batches_equal(got, expected)
    (batch, _), _ = got[0]
    assert batch[BatchKeys.IMAGES].dtype == np.uint8
    if split == "train":   # the COCO-20i val episodes carry DIMS alone
        assert batch[BatchKeys.RESIZED_DIMS].shape == \
            batch[BatchKeys.DIMS].shape


def test_pascal_image_episodes_match_jax(tmp_path, monkeypatch):
    """PASCAL episodes on ``JPEGImages`` (written by PIL at the masks'
    sizes): every key bit for bit but the frames, which the port ships as
    uint8 and the JAX package normalized; normalized as the model
    normalizes them, those are bit for bit too."""
    from labelanything_tpu_torch.data.synthetic_voc import write_synthetic_voc
    from tests.test_torch_pascal import PROMPTS, sorted_name_draws_in_jax

    sorted_name_draws_in_jax(monkeypatch)
    rng = np.random.default_rng(9)
    sources = []
    for i, (h, w) in enumerate([(50, 70), (70, 50), (45, 66)]):
        path = tmp_path / f"src{i}.jpg"
        Image.fromarray(_scene(rng, h, w)).save(path, quality=80)
        sources.append(str(path))
    paths = write_synthetic_voc(str(tmp_path / "voc"), seed=4, num_images=60,
                                classes_per_image=(2, 3), val_share=0.5,
                                image_sources=sources, embeddings=False)
    for p in (tmp_path / "voc" / "SegmentationClass").glob("*.png"):
        with Image.open(p) as im:     # masks PIL wrote
            im.load()
            arr, palette = np.asarray(im), im.getpalette()
        out = Image.fromarray(arr, mode="P")
        out.putpalette(palette)
        out.save(p)
    for name, params, meta in [
            ("pascal", dict(split="train"), {"num_examples": 2}),
            ("val_pascal5i_N1K1", dict(name="pascal", split="val",
                                       val_fold_idx=1, n_folds=4, n_shots=1,
                                       n_ways=2, val_num_samples=4), {})]:
        common = {"image_size": 64, "seed": 11}
        params = {**paths, **params}
        jset = jds.LabelAnythingDataset({name: params}, common)
        tset = tds.LabelAnythingDataset({name: params}, common)
        meta = {**meta, "prompt_types": PROMPTS["all"]}
        (got, gts), names = tset.collate_fn([tset[(i, meta)]
                                             for i in range(4)])
        (exp, jgts), jnames = jset.collate_fn([jset[(i, meta)]
                                               for i in range(4)])
        assert names == jnames and np.array_equal(gts, jgts)
        frames = got.pop(BatchKeys.IMAGES)
        resized = got.pop(BatchKeys.RESIZED_DIMS)
        jframes = exp.pop(BatchKeys.IMAGES)
        assert_batches_equal([((got, gts), names)], [((exp, jgts), jnames)])
        assert frames.dtype == np.uint8 and jframes.dtype == np.float32
        for f, jf, (nh, nw) in zip(frames.reshape(-1, 64, 64, 3),
                                   jframes.reshape(-1, 64, 64, 3),
                                   resized.reshape(-1, 2)):
            np.testing.assert_array_equal(normalize_padded(f[:nh, :nw], 64),
                                          jf)


# ---- the cross-domain sets --------------------------------------------------- #

@pytest.fixture(scope="module")
def crossdomain_roots(tmp_path_factory):
    """The four layouts, their JPEG and TIFF files written by PIL, the
    PNGs by the port."""
    root = tmp_path_factory.mktemp("crossdomain")
    rng = np.random.default_rng(13)
    src = root / "sources"
    src.mkdir()
    pairs, tifs, jpegs = [], [], []
    for i, (h, w) in enumerate([(40, 52), (52, 40), (36, 36)]):
        image, mask = src / f"k{i}.jpg", src / f"k{i}_mask.jpg"
        Image.fromarray(_scene(rng, h, w)).save(image, quality=80)
        blob = np.zeros((h, w), np.uint8)
        blob[h // 4:3 * h // 4, w // 3:2 * w // 3] = 255
        Image.fromarray(blob).save(mask, quality=90)
        pairs.append((str(image), str(mask)))
        jpegs.append(str(image))
        tif, tmask = src / f"b{i}.tif", src / f"b{i}_m.tif"
        Image.fromarray(_scene(rng, h, w)).save(
            tif, compression=["tiff_lzw", None, "packbits"][i])
        Image.fromarray(blob if i < 2 else blob * 0).save(
            tmask, compression="tiff_lzw")
        tifs.append((str(tif), str(tmask)))
    return {
        "test_kvasir": write_kvasir(str(root / "kvasir"), pairs, seed=1),
        "test_weedmap": write_weedmap(str(root / "weedmap"), size=(30, 44),
                                      seed=2),
        "test_brain": write_brain(str(root / "brain"), tifs, num_images=9,
                                  seed=3),
        "test_dram": write_dram(str(root / "dram"), jpegs, seed=4),
    }


CROSS = {"test_kvasir": ("KvasirTestDataset", 2),
         "test_weedmap": ("WeedMapTestDataset", 3),
         "test_brain": ("BrainMriTestDataset", 2),
         "test_dram": ("DramTestDataset", 12)}


@pytest.mark.parametrize("custom", [True, False])
@pytest.mark.parametrize("name", sorted(CROSS))
def test_crossdomain_items_match_jax(crossdomain_roots, name, custom):
    cls, classes = CROSS[name]
    params = dict(crossdomain_roots[name], image_size=48,
                  custom_preprocess=custom)
    ds = getattr(tcross, cls)(**params)
    jd = getattr(jcross, cls)(**params)
    assert ds.num_classes == jd.num_classes == classes
    assert len(ds) == len(jd) > 0
    assert ds.support_files() == jd.support_files()
    support, jsupport = ds.extract_prompts(), jd.extract_prompts()
    assert sorted(support) == sorted(jsupport)
    for key, ref in jsupport.items():
        assert support[key].dtype == ref.dtype, key
        np.testing.assert_array_equal(support[key], ref, err_msg=key)
    assert support[BatchKeys.FLAG_MASKS][0, :, 1:].any()
    items = [ds[i] for i in range(len(ds))]
    jitems = [jd[i] for i in range(len(jd))]
    for item, ref in zip(items, jitems):
        assert sorted(item) == sorted(ref)
        for key in ref:
            assert item[key].dtype == ref[key].dtype, key
            np.testing.assert_array_equal(item[key], ref[key], err_msg=key)
    (batch, gt), (jbatch, jgt) = ds.collate_fn(items), jd.collate_fn(jitems)
    np.testing.assert_array_equal(gt, jgt)
    for key in jbatch:
        np.testing.assert_array_equal(batch[key], jbatch[key])


# ---- Run on images, and C13 ------------------------------------------------- #

def _jax_toy_vit(project_last_hidden, dtype, remat=False):
    return JViT(use_rel_pos=True, project_last_hidden=project_last_hidden,
                dtype=dtype, **TOY_VIT)


def _port_toy_vit(project_last_hidden, image_size, dtype, **kw):
    return ImageEncoderViT(project_last_hidden=project_last_hidden,
                           dtype=dtype, **TOY_VIT)


def coco_vit_config(paths, num_steps: int = 2) -> dict:
    """``trainval/other/COCO_vit.yaml`` (its first grid point) on the image
    root: its model block at toy width (the toy ViT in ViT-B's place: 128
    px, 128 wide, LAM width 32), without ``checkpoint`` and
    ``use_sam_checkpoint`` (no SAM weights here), its train block at a
    constant learning rate, one batch shape, two steps, no validation
    set."""
    cfg = load_yaml(str(REPO / "parameters/trainval/other/COCO_vit.yaml"))
    cfg.pop("other_grids")
    p = cfg["parameters"]
    p["logger"]["log_frequency"] = [1]
    tp = p["train_params"]
    tp.update(max_epochs=[1], initial_lr=[1e-3], chunk_steps=[1],
              memory_preflight=[False], check_nan=[0])
    tp.pop("scheduler")
    m = p["model"]
    for key in ("checkpoint", "use_sam_checkpoint"):
        m.pop(key)
    m.update(image_embed_dim=[TOY_VIT["embed_dim"]], embed_dim=[32],
             image_size=[TOY_VIT["img_size"]])
    m["class_encoder"].update(embed_dim=[32], bank_size=[10])
    datasets = p["dataset"]["datasets"]
    for name in [n for n in datasets if n.startswith("val_")]:
        del datasets[name]      # the steps alone: no evaluation program
    datasets["coco20i"].update(instances_path=[paths["instances_path"]],
                               img_dir=[paths["img_dir"]])
    p["dataset"]["common"].update(image_size=[TOY_VIT["img_size"]],
                                  seed=[42], remove_small_annotations=[False])
    p["dataloader"].update(num_steps=[num_steps], num_workers=[2],
                           possible_batch_example_nums=[[[2, 1, 2]]],
                           prompt_types=[["mask"]])
    return cfg


def test_run_on_images_matches_jax(image_root, tmp_path, monkeypatch):
    """Two training steps of ``COCO_vit.yaml``'s ``lam_b`` on the image
    root, the backbone frozen as the file sets it:
    the losses and every parameter after the steps within rtol 1e-3, atol
    5e-4 of the JAX ``Run``'s from the same weights; the frozen encoder
    unchanged on both sides and the decoder moved."""
    flat = expand_experiment(coco_vit_config(image_root))[0]
    monkeypatch.setattr(jrun, "create_mesh", lambda: jmesh.create_mesh(
        devices=jax.devices()[:1]))
    monkeypatch.setattr(jrun, "VariableBatchSampler",
                        JaxSamplerEpisodeTypesWhole)
    monkeypatch.setattr(jcoco.CocoLVISDataset, "instances_path",
                        image_root["instances_path"], raising=False)
    monkeypatch.setattr(jbl, "build_vit_b", _jax_toy_vit)
    monkeypatch.setattr(tbl, "build_vit_b", _port_toy_vit)
    initial = {}
    lazy_init = jrun.Run._lazy_init

    def keep_initial(self, *args):
        lazy_init(self, *args)
        initial["model"] = jax.tree.map(np.array, self.state.params["model"])

    monkeypatch.setattr(jrun.Run, "_lazy_init", keep_initial)
    rows = []
    permutation = jax.random.permutation

    def recorded(key, x, *args, **kw):
        out = permutation(key, x, *args, **kw)
        if isinstance(x, int) and x == 9:
            jax.debug.callback(lambda v: rows.append(np.asarray(v)), out,
                               ordered=True)
        return out

    monkeypatch.setattr(jax.random, "permutation", recorded)
    jdir = tmp_path / "jax"
    jax_run = jrun.Run().init(flat, run_dir=str(jdir))
    jax_run.launch()
    jax.effects_barrier()
    monkeypatch.setattr(jax.random, "permutation", permutation)

    tdir = tmp_path / "torch"
    run = Run().init(flat, run_dir=str(tdir), device="cpu")
    run.state.model.load_state_dict(state_dict_from_jax(initial["model"]))
    replay = iter(rows)

    def class_rows(self, num_classes, generator=None):
        if generator is None:
            return torch.arange(num_classes)
        fg = torch.as_tensor(next(replay)[:num_classes - 1] + 1)
        return torch.cat([torch.zeros(1, dtype=torch.long), fg.long()])

    monkeypatch.setattr(tpe.RandomMatrixEncoder, "class_rows", class_rows)
    run.launch()
    assert next(replay, None) is None, "the runs drew different passes"

    jloss = [r["train/loss"] for r in read_metrics(jdir) if "train/loss" in r]
    tloss = [r["train/loss"] for r in read_metrics(tdir) if "train/loss" in r]
    assert len(tloss) == len(jloss) == 2 and np.isfinite(tloss).all()
    np.testing.assert_allclose(tloss, jloss, **TOL)
    final = state_dict_from_jax(jax.tree.map(np.asarray,
                                             jax_run.state.params["model"]))
    start = state_dict_from_jax(initial["model"])
    got = run.state.model.state_dict()
    assert sorted(got) == sorted(final)
    for name, ref in final.items():
        np.testing.assert_allclose(got[name].numpy(), ref.numpy(), **TOL,
                                   err_msg=name)
        if name.startswith("image_encoder."):
            assert torch.equal(got[name], start[name]), name
            assert torch.equal(ref, start[name]), name
    assert any(not torch.equal(got[n], start[n]) for n in got
               if n.startswith("mask_decoder."))
    assert int(jax_run.state.step) == run.state.step == 2


def test_c13_lam_no_vit_on_crossdomain_images_fails_in_both(
        crossdomain_roots, tmp_path, monkeypatch):
    """``parameters/test/kvasir.yaml`` as it stands (``lam_no_vit``) on the
    Kvasir root: the JAX ``Lam`` calls its absent image encoder (a
    TypeError), the port names the fault (a ValueError). With ``lam_b``
    (the toy ViT in ViT-B's place) the port's ``cli test`` runs the
    protocol and gives finite metrics. ``weedmap.yaml`` gives its set a
    ``root``, which ``WeedMapTestDataset`` does not take, in either
    package."""
    cfg = load_yaml(str(REPO / "parameters/test/kvasir.yaml"))
    params = cfg["parameters"]
    params["model"].update(image_embed_dim=[32], embed_dim=[32],
                           image_size=[128])
    params["dataset"]["datasets"]["test_kvasir"] = {
        "root": [crossdomain_roots["test_kvasir"]["root"]],
        "image_size": [128]}
    flat = expand_experiment(cfg)[0]
    jax_run = jrun.Run().init(flat, run_dir=str(tmp_path / "jax"))
    with pytest.raises(TypeError, match="NoneType"):
        jax_run.test()
    weedmap = expand_experiment(load_yaml(str(
        REPO / "parameters/test/weedmap.yaml")))[0]["dataset"]["datasets"][
        "test_weedmap"]
    for cls in (jcross.WeedMapTestDataset, tcross.WeedMapTestDataset):
        with pytest.raises(TypeError, match="root"):
            cls(**weedmap)
    run = Run().init(flat, run_dir=str(tmp_path / "torch"), device="cpu")
    with pytest.raises(ValueError, match="no image encoder"):
        run.test(batch_size=2)
    run.close()

    from labelanything_tpu_torch.utils import yaml_subset

    # lam_b: the toy ViT's neck gives 32 channels (image_embed_dim)
    params["model"]["name"] = ["lam_b"]
    path = tmp_path / "kvasir_lam_b.yaml"
    path.write_text(yaml_subset.dumps(cfg))
    monkeypatch.setattr(tbl, "build_vit_b", _port_toy_vit)
    assert cli.main(["test", "--parameters", str(path), "--out-dir",
                     str(tmp_path / "cli"), "--batch-size", "2",
                     "--device", "cpu"]) == 0
    lines = read_metrics(tmp_path / "cli")
    values = [v for r in lines for k, v in r.items() if k.endswith("miou")]
    assert values and np.isfinite(values).all()
