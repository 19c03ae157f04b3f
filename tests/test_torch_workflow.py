"""The precomputed-embeddings workflow of the port against the JAX package,
on the CPU: the safetensors reader and writer against the ``safetensors``
package, ``CustomResize`` against PIL, ``preprocess`` against the JAX
``preprocess_images_to_embeddings``, checkpoints between the two packages
(``save_torch_compatible`` / ``from_pretrained`` both ways), the resume of
a training run, and ``raw_decode`` / ``predict_original_resolution``.

fp32 tolerances are the golden harness's (rtol 1e-3, atol 5e-4) unless a
test says otherwise.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from labelanything_tpu import api as japi
from labelanything_tpu import inference as jinf
from labelanything_tpu import preprocess as jpre
from labelanything_tpu.data.synthetic import random_batch
from labelanything_tpu.data.transforms import CustomResize as JCustomResize
from labelanything_tpu.models.image_encoder import ImageEncoderViT as JViT
from labelanything_tpu.models.registry import model_registry as jregistry
from labelanything_tpu_torch import api, inference, preprocess
from labelanything_tpu_torch.data import embeddings
from labelanything_tpu_torch.data.transforms import CustomResize
from labelanything_tpu_torch.models.build_encoder import ENCODERS
from labelanything_tpu_torch.models.image_encoder import ImageEncoderViT
from labelanything_tpu_torch.parallel.train_step import (init_train_state,
                                                         make_train_step)
from labelanything_tpu_torch.train import losses as tl
from labelanything_tpu_torch.train.checkpoint import (CheckpointManager,
                                                      load_params, save_params)
from labelanything_tpu_torch.typing import BatchKeys, ResultDict
from labelanything_tpu_torch.utils import safetensors as st
from labelanything_tpu_torch.utils.weights import init_weights
from tests.test_torch_baselines import jax_init
from tests.test_torch_train_embeddings import TOY_FLAGSHIP, episode
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-3, atol=5e-4)


# ---- safetensors -------------------------------------------------------------

def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {"f32": rng.standard_normal((3, 4, 5)).astype(np.float32),
            "f16": rng.standard_normal((7,)).astype(np.float16),
            "i64": rng.integers(-2**40, 2**40, (2, 3), dtype=np.int64),
            "i32": rng.integers(-2**20, 2**20, (4, 1), dtype=np.int32),
            "u8": rng.integers(0, 256, (2, 2, 3), dtype=np.uint8),
            "bool": rng.integers(0, 2, (5,)).astype(bool),
            "scalar": np.asarray(2.5, np.float32),
            "empty": np.zeros((0, 3), np.float32)}


def test_safetensors_matches_the_package(tmp_path):
    """Every dtype both ways against ``safetensors.numpy`` (BF16, which
    numpy has not, against ``safetensors.torch``), and the package's bytes
    for the same dict."""
    from safetensors.numpy import load_file as np_load
    from safetensors.numpy import save_file as np_save
    from safetensors.torch import load_file as pt_load
    from safetensors.torch import save_file as pt_save

    arrays = _arrays()
    ours, theirs = tmp_path / "ours.safetensors", tmp_path / "theirs.st"
    st.save_file(arrays, str(ours), metadata={"format": "np"})
    np_save(arrays, str(theirs), metadata={"format": "np"})
    assert ours.read_bytes() == theirs.read_bytes()
    for path in (ours, theirs):
        back = st.load_file(str(path))
        for name, value in arrays.items():
            assert back[name].numpy().dtype == value.dtype, name
            np.testing.assert_array_equal(back[name].numpy(), value)
        for name, value in np_load(str(path)).items():
            np.testing.assert_array_equal(value, arrays[name])
    assert st.read_header(str(ours))["__metadata__"] == {"format": "np"}
    bf16 = {"w": torch.randn(4, 3, generator=torch.Generator().manual_seed(1)
                             ).bfloat16(), "x": torch.arange(6).int()}
    st.save_file(bf16, str(ours))
    pt_save(bf16, str(theirs))
    assert ours.read_bytes() == theirs.read_bytes()
    for back in (st.load_file(str(theirs)), pt_load(str(ours))):
        for name, value in bf16.items():
            assert torch.equal(back[name], value), name


def test_safetensors_f32_files_are_byte_identical(tmp_path):
    """An embedding cache as ``preprocess`` writes it (a CHW view of an HWC
    array): the package's file byte for byte, the view's logical order."""
    from safetensors.numpy import save_file as np_save

    hwc = np.random.default_rng(2).standard_normal((4, 6, 8)).astype(
        np.float32)
    ours, theirs = tmp_path / "a", tmp_path / "b"
    preprocess.save_st({"embedding": hwc.transpose(2, 0, 1)}, str(ours))
    np_save({"embedding": np.ascontiguousarray(hwc.transpose(2, 0, 1))},
            str(theirs))
    assert ours.read_bytes() == theirs.read_bytes()
    back = embeddings.load_embedding(str(ours))
    np.testing.assert_array_equal(back.numpy(), hwc)
    stacked = embeddings.stack_embeddings([back, back])
    assert tuple(stacked.shape) == (2, 4, 6, 8)
    pyramid = embeddings.embedding_from_file({"stage2": torch.zeros(3, 2, 2)})
    assert tuple(pyramid["stage2"].shape) == (2, 2, 3)
    with pytest.raises(KeyError):
        embeddings.embedding_from_file({"other": torch.zeros(1)})


# ---- CustomResize ------------------------------------------------------------

@pytest.mark.parametrize("h,w,side", [(480, 640, 1024), (37, 53, 64),
                                      (700, 300, 480), (2000, 1500, 1024),
                                      (64, 40, 64)],
                         ids=["up", "up_small", "down", "down_large",
                              "identity"])
def test_custom_resize_matches_pil(h, w, side):
    """PIL's BILINEAR resize within 1 uint8 level (antialiased when it
    downscales), the same size, identical where nothing is resized."""
    image = np.random.default_rng(h + w).integers(0, 256, (h, w, 3),
                                                  dtype=np.uint8)
    ours = CustomResize(side)(image)
    ref = np.asarray(JCustomResize(side)(Image.fromarray(image)))
    assert ours.shape == ref.shape and ours.dtype == np.uint8
    assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1
    if (h, w) == ours.shape[:2]:
        np.testing.assert_array_equal(ours, image)


# ---- preprocess --------------------------------------------------------------

TOY_VIT = dict(img_size=64, patch_size=16, embed_dim=128, depth=2,
               num_heads=2, window_size=3, global_attn_indexes=(1,),
               out_chans=32)


def test_preprocess_matches_jax(tmp_path, monkeypatch):
    """A toy SAM encoder (64 px) with the same reference-layout checkpoint in
    both packages, both reading the same folder of PNG files: the embedding
    and last-block caches agree (fp32), the downscaled image's too, since
    the port's resize is PIL's bit for bit."""
    monkeypatch.setitem(jregistry, "vit_b", lambda project_last_hidden, dtype,
                        image_size: JViT(use_rel_pos=True, dtype=dtype,
                                         project_last_hidden=True, **TOY_VIT))
    monkeypatch.setitem(ENCODERS, "vit_b", lambda project_last_hidden, dtype,
                        image_size: ImageEncoderViT(dtype=dtype, **TOY_VIT))
    vit = ImageEncoderViT(**TOY_VIT)
    init_weights(vit, 3)
    ckpt = str(tmp_path / "encoder.pth")
    torch.save(vit.state_dict(), ckpt)
    image_dir = tmp_path / "images"
    image_dir.mkdir()
    rng = np.random.default_rng(4)
    decoded = []
    for i, (h, w) in enumerate([(48, 64), (64, 30), (100, 80), (20, 20),
                                (64, 64)]):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            image_dir / f"{i + 1:06d}.png")
    for path in sorted(image_dir.glob("*.png")):
        decoded.append((path.stem.lstrip("0"), np.asarray(Image.open(path))))
    dirs = {pkg: (str(tmp_path / pkg / "emb"), str(tmp_path / pkg / "last"))
            for pkg in ("jax", "port")}
    jpre.preprocess_images_to_embeddings(
        "vit_b", checkpoint=ckpt, directory=str(image_dir), batch_size=2,
        num_workers=2, outfolder=dirs["jax"][0], last_block_dir=dirs["jax"][1],
        image_size=64, dtype=jnp.float32)
    rate = preprocess.preprocess_images_to_embeddings(
        "vit_b", directory=str(image_dir), checkpoint=ckpt, batch_size=2,
        num_workers=2,
        outfolder=dirs["port"][0], last_block_dir=dirs["port"][1],
        image_size=64, dtype="float32", device="cpu")
    assert rate > 0
    names = sorted(os.listdir(dirs["jax"][0]))
    assert names == sorted(os.listdir(dirs["port"][0])) == [
        f"{i:012d}.safetensors" for i in range(1, 6)]
    # the 100 x 80 image is downscaled: the port's pixels are PIL's
    image = decoded[2][1]
    np.testing.assert_array_equal(CustomResize(64)(image), np.asarray(
        JCustomResize(64)(Image.fromarray(image))))
    for k, shape in ((0, (32, 4, 4)), (1, (128, 4, 4))):
        for i, name in enumerate(names):
            ours = st.load_file(os.path.join(dirs["port"][k], name))
            ref = st.load_file(os.path.join(dirs["jax"][k], name))
            assert list(ours) == list(ref) == ["embedding"]
            assert tuple(ours["embedding"].shape) == shape
            np.testing.assert_allclose(
                ours["embedding"].numpy(), ref["embedding"].numpy(), **TOL)


def test_images_from_directory(tmp_path):
    for name in ("000012.npy", "000003.npy"):
        np.save(tmp_path / name, np.zeros((2, 3, 3), np.uint8))
    assert [i for i, _ in preprocess.images_from_directory(str(tmp_path))] \
        == ["3", "12"]


# ---- checkpoints between the packages ------------------------------------------

@pytest.fixture(scope="module")
def jax_model():
    """The toy flagship ``lam_no_vit`` in the JAX ``LabelAnything``, its
    weights seeded fills of the JAX init's tree, and an episode."""
    batch = random_batch(batch_size=2, num_examples=1, num_classes=3,
                         image_size=64, embed_dim=48, seed=6)
    la = japi.LabelAnything(dict(TOY_FLAGSHIP))
    la.params = jax_init(la.model, jax.tree.map(jnp.asarray, batch))
    return la, batch


def _logits(la, batch):
    return la(batch)[ResultDict.LOGITS].numpy()


def test_jax_checkpoint_into_the_port(jax_model, tmp_path):
    """The JAX ``save_torch_compatible`` directory through the port's
    ``from_pretrained`` gives the JAX logits; the JAX ``params/`` layout is
    refused by name, a missing checkpoint raises."""
    jla, batch = jax_model
    jla.save_torch_compatible(str(tmp_path))
    want = np.asarray(jla(jax.tree.map(jnp.asarray, batch))[
        ResultDict.LOGITS])
    la = api.LabelAnything.from_pretrained(str(tmp_path), device="cpu")
    np.testing.assert_allclose(_logits(la, batch), want, **TOL)
    os.remove(tmp_path / "model.safetensors")
    (tmp_path / "params").mkdir()
    with pytest.raises(ValueError, match="save_torch_compatible"):
        api.LabelAnything.from_pretrained(str(tmp_path), device="cpu")
    with pytest.raises(FileNotFoundError):
        api.LabelAnything.from_pretrained(str(tmp_path / "nowhere"), "cpu")


def test_port_checkpoint_into_jax(jax_model, tmp_path, monkeypatch):
    """The port's ``save_torch_compatible`` directory through the JAX
    ``from_pretrained`` gives the port's logits; the port reads its own
    ``pytorch_model.bin`` and a Hugging Face snapshot by id."""
    _, batch = jax_model
    la = api.LabelAnything(dict(TOY_FLAGSHIP), "cpu", seed=5)
    la.save_torch_compatible(str(tmp_path / "ckpt"))
    want = _logits(la, batch)
    jla = japi.LabelAnything.from_pretrained(str(tmp_path / "ckpt"))
    got = np.asarray(jla(jax.tree.map(jnp.asarray, batch))[ResultDict.LOGITS])
    np.testing.assert_allclose(got, want, **TOL)
    snap = tmp_path / "hub" / "models--org--toy" / "snapshots" / "abc"
    snap.mkdir(parents=True)
    api.LabelAnythingConfig(la.config).save(str(snap / "config.json"))
    torch.save(la.model.state_dict(), snap / "pytorch_model.bin")
    monkeypatch.setenv("LABELANYTHING_CACHE", str(tmp_path))
    again = api.LabelAnything.from_pretrained("org/toy", device="cpu")
    np.testing.assert_array_equal(_logits(again, batch), want)
    save_params(str(tmp_path / "w.safetensors"), la.model)
    fresh = api.LabelAnything(dict(TOY_FLAGSHIP), "cpu", seed=9)
    load_params(str(tmp_path / "w.safetensors"), fresh.model)
    np.testing.assert_array_equal(_logits(fresh, batch), want)


# ---- resume -------------------------------------------------------------------

def _state(seed=0):
    loss = tl.LabelAnythingLoss({"focal": {"weight": 1.0}},
                                class_weighting=True)
    return init_train_state(dict(TOY_FLAGSHIP, name="lam_no_vit"), loss,
                            "cpu", seed=seed, name="AdamW",
                            learning_rate=5e-5, scheduler={
                                "name": "constant_with_warmup",
                                "num_warmup_steps": 3})


def test_resume_retraces_the_run(tmp_path):
    """Four steps straight against two, a save, a restore into a fresh
    state (other weights) and two more: the same losses and parameters bit
    for bit, the class rows drawn from the restored generator."""
    batches = [episode(TOY_FLAGSHIP, 2, 1, 1, seed=s) for s in range(4)]
    step = make_train_step()
    ckpt = CheckpointManager(str(tmp_path), watch_metric="loss",
                             higher_is_better=False)
    state, gen = _state(), torch.Generator().manual_seed(0)
    losses = []
    for i, (batch, gt) in enumerate(batches):
        state, aux = step(state, batch, gt, gen, 1.0, apply_update=True,
                          use_accum=False)
        losses.append(float(aux["loss"]))
        if i == 1:
            ckpt.save_latest(state, epoch=1, generator=gen, note="x")
    fresh, gen2 = _state(seed=7), torch.Generator().manual_seed(99)
    fresh, meta = ckpt.restore(fresh, generator=gen2)
    assert meta == {"epoch": 1, "note": "x"} and fresh.step == 2
    assert fresh.scheduler.last_epoch == 2
    for batch, gt in batches[2:]:
        fresh, aux = step(fresh, batch, gt, gen2, 1.0, apply_update=True,
                          use_accum=False)
        assert float(aux["loss"]) == losses[fresh.step - 1]
    ours = fresh.model.state_dict()
    for key, value in state.model.state_dict().items():
        assert torch.equal(value, ours[key]), key
    assert CheckpointManager(str(tmp_path / "none")).restore(_state()) == (
        None, {})


def test_maybe_save_best_keeps_the_best(tmp_path):
    state = _state()
    ckpt = CheckpointManager(str(tmp_path), watch_metric="miou")
    saved = [ckpt.maybe_save_best(state, epoch, value)
             for epoch, value in enumerate((0.5, 0.3, 0.7, 0.7))]
    assert saved == [True, False, True, False]
    meta = CheckpointManager(str(tmp_path))._read_meta("best")
    assert meta == {"epoch": 2, "value": 0.7, "metric": "miou"}
    assert CheckpointManager(str(tmp_path)).best_value == 0.7
    lower = CheckpointManager(str(tmp_path / "low"), higher_is_better=False)
    assert [lower.maybe_save_best(state, 0, v) for v in (0.5, 0.6, 0.2)] == [
        True, False, True]
    _, meta = lower.restore(_state(seed=3), tag="best")
    assert meta["value"] == 0.2


# ---- raw_decode, predict_original_resolution ---------------------------------

def test_raw_decode_and_original_resolution_match_jax(jax_model):
    """The port with the JAX weights: ``raw_decode`` against cached class
    embeddings, and ``predict_original_resolution`` with and without them,
    at queries of other sizes than the model's, against the JAX package."""
    jla, batch = jax_model
    batch = dict(batch)
    batch[BatchKeys.DIMS] = np.asarray([[[100, 80], [64, 64]],
                                        [[30, 64], [64, 64]]], np.int32)
    support = {k: v[:, 1:] if k in (BatchKeys.EMBEDDINGS, BatchKeys.DIMS)
               else v for k, v in batch.items()}
    jb = jax.tree.map(jnp.asarray, batch)
    jembs = jla.generate_class_embeddings(jax.tree.map(jnp.asarray, support))
    la = api.LabelAnything.from_jax_params(dict(TOY_FLAGSHIP), jla.params,
                                           "cpu")
    embs = la.generate_class_embeddings(support)
    want = np.asarray(jla.model.apply(jla.params, jb, jembs,
                                      method="raw_decode"))
    with torch.no_grad():
        got = la.model.raw_decode(la.to_device(batch), embs).numpy()
    assert got.shape == want.shape == (2, 3, 16, 16)
    np.testing.assert_allclose(got, want, **TOL)
    for ours_embs, theirs_embs in ((None, None), (embs, jembs)):
        ref = jinf.predict_original_resolution(jla.model, jla.params, jb,
                                               theirs_embs)
        out = inference.predict_original_resolution(la, batch, ours_embs)
        assert out.shape == ref.shape == (2, 3, 100, 80)
        assert out.dtype == torch.float32
        np.testing.assert_array_equal(np.isfinite(out.numpy()),
                                      np.isfinite(ref))
        finite = np.isfinite(ref)
        np.testing.assert_allclose(out.numpy()[finite], ref[finite], **TOL)
        assert (out[1, 0, 30:] == 0).all() and torch.isneginf(
            out[1, 1:, 30:]).all()
