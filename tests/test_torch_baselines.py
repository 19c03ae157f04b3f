"""The ResNet / VGG baselines of the port against the JAX package and the
original's golden outputs, on the CPU:

* the components with a rule of their own against their JAX functions:
  PPNet's k-means and its first-valid init (``lax.top_k``'s order of
  ties), BAM's ``weighted_gap`` and ``gram_matrix``, HDMNet's
  ``get_similarity`` and ``MaskAttention`` (self and cross);
* PPNet, DENet and PANet through the registry's builders (the episode
  wrappers) on the same seeded numpy episodes and the same weights,
  carried from the JAX model by
  ``utils/weights.state_dict_from_jax_baseline``, 1-way 1-shot and 2-way
  2-shot, tiny ResNets (layers (1, 1, 1, 2)) at 65 px: logits within rtol
  1e-3, atol 5e-4, the classes that FLAG_GTS leaves out -inf on both sides
  (compared as ROADMAP C4 does). BAM and HDMNet, whose JAX programs take
  longest to compile, the same way in ``test_torch_baselines_bam.py``;
* the weights' round trip: reference-layout weights through the JAX
  package's ``convert_*_state_dict`` and back through the port's inverse,
  bit for bit, and loaded with ``strict=True`` (PANet, which has no JAX
  converter: the JAX variables through the port and back);
* the golden fixtures ``ppnet_full``, ``denet_2way_2shot``, ``bam_1shot``
  and ``hdmnet_1shot`` (the original PyTorch models' outputs) replayed
  through the port without JAX (``tests/torch_golden_replay.py``);
* ROADMAP C15: ``validation/Pascal/denet_N3-4-5.yaml``'s model block names
  a ``checkpoint``, which the JAX builders do not take.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from labelanything_tpu.experiment import run as jrun
from labelanything_tpu.models import bam as jbam
from labelanything_tpu.models import hdmnet as jhdm
from labelanything_tpu.models import ppnet as jppnet
from labelanything_tpu.models.registry import model_registry as jregistry
from labelanything_tpu.parallel import mesh as jmesh
from labelanything_tpu.utils import torch_import as jti
from labelanything_tpu_torch.experiment import Run
from labelanything_tpu_torch.models import bam as tbam
from labelanything_tpu_torch.models import hdmnet as thdm
from labelanything_tpu_torch.models import ppnet as tppnet
from labelanything_tpu_torch.models.registry import model_registry
from labelanything_tpu_torch.utils.config import expand_experiment, load_yaml
from labelanything_tpu_torch.utils.weights import (
    reference_baseline_state_dict, state_dict_from_jax_baseline)
from tests.golden import CASES, fill_state_dict
from tests.torch_golden_replay import BASELINE_CASES, replay_baseline
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-3, atol=5e-4)
TINY = (1, 1, 1, 2)
IMG = 65


# ---- components ----------------------------------------------------------- #

def test_kmeans_and_its_init_match_jax():
    """Weighted k-means over two point sets, one with fewer valid points
    than centres (the init then takes the first invalid points, in
    ``lax.top_k``'s order of ties), at 10 iterations."""
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((2, 40, 6)).astype(np.float32)
    w = (rng.random((2, 40)) < 0.5).astype(np.float32)
    w[1] = 0
    w[1, [7, 30]] = 1
    for k in (3, 5):
        init = tppnet.kmeans_first_valid_init(torch.from_numpy(pts),
                                              torch.from_numpy(w), k)
        got = tppnet.masked_kmeans(torch.from_numpy(pts),
                                   torch.from_numpy(w), init, 10)
        for g in range(2):
            jinit = jppnet.kmeans_first_valid_init(jnp.asarray(pts[g]),
                                                   jnp.asarray(w[g]), k)
            np.testing.assert_array_equal(init[g].numpy(), np.asarray(jinit))
            ref = jppnet.masked_kmeans(jnp.asarray(pts[g]), jnp.asarray(w[g]),
                                       jinit, 10)
            np.testing.assert_allclose(got[g].numpy(), np.asarray(ref),
                                       rtol=1e-5, atol=1e-6)


def test_weighted_gap_gram_and_similarity_match_jax():
    rng = np.random.default_rng(1)
    feat = rng.standard_normal((3, 16, 9, 9)).astype(np.float32)
    other = rng.standard_normal((3, 16, 9, 9)).astype(np.float32)
    mask = (rng.random((3, 1, 9, 9)) < 0.4).astype(np.float32)
    nhwc = lambda a: jnp.asarray(a.transpose(0, 2, 3, 1))
    got = tbam.weighted_gap(torch.from_numpy(feat), torch.from_numpy(mask))
    ref = jbam.weighted_gap(nhwc(feat), nhwc(mask))
    np.testing.assert_allclose(got.numpy()[:, :, 0, 0],
                               np.asarray(ref)[:, 0, 0], rtol=1e-5, atol=1e-6)
    got = tbam.gram_matrix(torch.from_numpy(feat))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jbam.gram_matrix(nhwc(feat))),
                               rtol=1e-5, atol=1e-6)
    # the mask at 33 px, nearest-resized to the 9 x 9 features
    big = (rng.random((3, 33, 33)) < 0.5).astype(np.float32)
    got = thdm.get_similarity(torch.from_numpy(feat), torch.from_numpy(other),
                              torch.from_numpy(big))
    ref = jhdm.get_similarity(nhwc(feat), nhwc(other), jnp.asarray(big))
    np.testing.assert_allclose(got.numpy()[:, 0], np.asarray(ref)[..., 0],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cross", [False, True])
def test_mask_attention_matches_jax(cross):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 12, 16)).astype(np.float32)
    kv = rng.standard_normal((2, 20, 16)).astype(np.float32)
    mask = (rng.random((2, 12, 20)) < 0.6).astype(np.float32)
    jmod = jhdm.MaskAttention(16, 2)
    args = (jnp.asarray(q), jnp.asarray(kv), jnp.asarray(mask), cross)
    params = jmod.init(jax.random.key(0), *args)
    ref = np.asarray(jmod.apply(params, *args))
    tmod = thdm.MaskAttention(16, 2)
    tmod.load_state_dict({
        f"{name}.weight": torch.from_numpy(np.asarray(p["kernel"]).T.copy())
        for name, p in params["params"].items()})
    got = tmod(torch.from_numpy(q), torch.from_numpy(kv),
               torch.from_numpy(mask), cross)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-5,
                               atol=1e-5)


# ---- whole models against the JAX package --------------------------------- #

def episode(name: str, ways: int, shots: int, seed: int = 0) -> dict:
    """A seeded episode batch (normalized float images, way-major examples
    "(k c)", each flagging its own class) of 2 episodes (PPNet: 1); the
    last class of the last episode is unflagged where there are two."""
    rng = np.random.default_rng(seed)
    b = 1 if name == "ppnet" else 2
    c, m = ways + 1, ways * shots
    flag = np.zeros((b, m, c), np.int32)
    flag[:, :, 0] = 1
    for e in range(m):
        flag[:, e, 1 + e % ways] = 1
    gts = np.ones((b, c), bool)
    if ways > 1:
        gts[-1, -1] = False
    return {"images": rng.standard_normal((b, m + 1, IMG, IMG, 3)).astype(
                np.float32),
            "prompt_masks": (rng.random((b, m, c, 32, 32)) < 0.4).astype(
                np.float32),
            "flag_examples": flag, "flag_gts": gts,
            "dims": np.full((b, m + 1, 2), IMG, np.int32)}


def builder_args(name: str, shots: int) -> dict:
    args = {"image_size": IMG}
    if name in ("bam", "hdmnet"):
        args.update(shots=shots, resnet_layers=TINY)
    elif name in ("ppnet", "denet"):
        args["resnet_layers"] = TINY
    if name == "ppnet":
        args["num_centers"] = 3
    return args


def jax_variables(model, batch: dict, seed: int = 0) -> dict:
    """Seeded variables of the JAX model's tree, its shapes by
    ``jax.eval_shape`` (compiling ``init`` costs more than the forward)."""
    return seeded_variables(
        jax.eval_shape(model.init, jax.random.key(seed), batch), seed)


# leaves that flax's initializers start at 0, at 1, and at a unit normal
_ZEROS = ("bias", "mean", "rel_pos_h", "rel_pos_w")
_ONES = ("scale", "var", "weight")
_UNIT = ("positional_encoding_gaussian_matrix", "embeddings",
         "point_embeddings", "not_a_point_embed", "no_mask_embed",
         "not_a_mask_embed", "no_sparse_embedding")


def flax_like_variables(shapes, seed: int = 0) -> dict:
    """Numpy values for a tree of JAX variable shapes as flax's default
    initializers lay them out, from a seeded generator: biases and
    BatchNorm means 0, norm scales and variances 1, the embeddings drawn
    from a unit normal, kernels and the rest normal over sqrt(fan in).
    What ``init`` gives in distribution, without compiling it."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name in _ZEROS:
            return np.zeros(leaf.shape, np.float32)
        if name in _ONES:
            return np.ones(leaf.shape, np.float32)
        n = rng.standard_normal(leaf.shape).astype(np.float32)
        if name in _UNIT:
            return n
        if name == "pos_embedding":
            return np.float32(0.02) * n
        fan_in = int(np.prod(leaf.shape[:-1])) if name == "kernel" \
            else leaf.shape[-1]
        return n / np.float32(np.sqrt(fan_in))

    return jax.tree_util.tree_map_with_path(fill, shapes)


def jax_init(model, *args, seed: int = 0) -> dict:
    """:func:`flax_like_variables` of ``model.init``'s tree, its shapes by
    ``jax.eval_shape``: what ``jax.jit(model.init)`` gives in
    distribution, without compiling the forward pass that ``init`` runs."""
    return flax_like_variables(
        jax.eval_shape(model.init, jax.random.key(seed), *args), seed)


def seed_jax_init(monkeypatch, module_cls, seed: int = 0,
                  fill=flax_like_variables) -> None:
    """Make ``module_cls.init`` (a flax module class) return ``fill`` of
    the shapes ``jax.eval_shape`` gives, for the rest of the test: the JAX
    ``Run`` initializes its model through ``init`` under ``jit``, whose
    compile costs more than the steps'."""
    model_init = module_cls.init

    def seeded_init(self, rng, *args, **kwargs):
        return fill(jax.eval_shape(functools.partial(model_init, self), rng,
                                   *args, **kwargs), seed)

    monkeypatch.setattr(module_cls, "init", seeded_init)


def seeded_variables(shapes, seed: int = 0) -> dict:
    """Numpy values for a tree of JAX variable shapes: kernels and DENet's
    class bank normal over sqrt(fan in), biases 0.02 x, norm scales 1 +
    0.05 x, BatchNorm means 0.1 x and variances in [0.5, 1.5), so that the
    running statistics are exercised."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        n = rng.standard_normal(leaf.shape).astype(np.float32)
        name = path[-1].key
        if name == "var":
            return (0.5 + rng.random(leaf.shape)).astype(np.float32)
        if name == "mean":
            return 0.1 * n
        if name == "bias":
            return 0.02 * n
        if name == "scale":
            return 1.0 + 0.05 * n
        fan_in = int(np.prod(leaf.shape[:-1])) if name == "kernel" \
            else leaf.shape[-1]
        return n / np.float32(np.sqrt(fan_in))

    return jax.tree_util.tree_map_with_path(fill, shapes)


def compare_with_jax(name: str, ways: int, shots: int) -> None:
    batch = episode(name, ways, shots)
    args = builder_args(name, shots)
    jmodel = jregistry[name](**args)
    variables = jax_variables(jmodel, batch)
    ref = np.asarray(jax.jit(jmodel.apply)(variables, batch)["logits"])
    model = model_registry[name](**args).eval()
    model.load_state_dict(state_dict_from_jax_baseline(name, variables),
                          strict=True)
    with torch.no_grad():
        got = model({k: torch.from_numpy(v) for k, v in batch.items()})
    got = got["logits"].numpy()
    assert got.shape == ref.shape == (
        batch["flag_gts"].shape[0], ways + 1, IMG, IMG)
    flagged = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), flagged)
    assert flagged.any() and (ways == 1 or not flagged.all())
    np.testing.assert_allclose(got[flagged], ref[flagged], **TOL)


@pytest.mark.parametrize("name", ["ppnet", "denet", "panet"])
@pytest.mark.parametrize("ways,shots", [(1, 1), (2, 2)])
def test_model_matches_jax(name, ways, shots):
    compare_with_jax(name, ways, shots)


# ---- weights -------------------------------------------------------------- #

def _bare_shapes(model: torch.nn.Module, scope: str) -> dict:
    """The reference layout's shapes: the port wrapper's state dict without
    its scope."""
    return {k[len(scope):]: tuple(v.shape)
            for k, v in model.state_dict().items() if k.startswith(scope)}


ROUND_TRIPS = {
    "ppnet": (lambda: model_registry["ppnet"](resnet_layers=TINY),
              lambda sd: jti.convert_ppnet_state_dict(sd, prefix="ppnet.")),
    "denet": (lambda: model_registry["denet"](resnet_layers=TINY),
              jti.convert_denet_state_dict),
    "bam": (lambda: model_registry["bam"](shots=2, resnet_layers=TINY),
            jti.convert_bam_state_dict),
    "hdmnet": (lambda: model_registry["hdmnet"](shots=2, resnet_layers=TINY),
               jti.convert_hdmnet_state_dict),
}


@pytest.mark.parametrize("name", sorted(ROUND_TRIPS))
def test_weights_round_trip_through_jax(name):
    """Reference-layout weights (the golden harness's fill, with PPNet's
    training head ``aspp.*`` beside them) -> the JAX converter -> the
    port's inverse: every kept entry equal bit for bit, and the result
    loads with ``strict=True``."""
    build, convert = ROUND_TRIPS[name]
    with torch.device("meta"):
        model = build()
    scope = f"{name}."
    shapes = _bare_shapes(model, scope)
    if name == "ppnet":
        shapes["aspp.c0.weight"] = (4, 2048, 3, 3)
    start = fill_state_dict(shapes, seed=11)
    back = state_dict_from_jax_baseline(name, convert(start))
    kept = reference_baseline_state_dict(name, start)
    assert sorted(back) == sorted(scope + k for k in kept)
    for key, value in kept.items():
        assert torch.equal(back[scope + key], value), key
    model.to_empty(device="cpu").load_state_dict(back, strict=True)


def test_panet_weights_round_trip():
    """PANet has no JAX converter: its flax variables go to the port's VGG16
    names (``encoder.conv_k`` -> ``encoder.features.i``) and back, bit for
    bit."""
    variables = jax_variables(jregistry["panet"](image_size=IMG),
                              episode("panet", 1, 1), seed=3)
    sd = state_dict_from_jax_baseline("panet", variables)
    model = model_registry["panet"](image_size=IMG)
    model.load_state_dict(sd, strict=True)
    convs = [i for i, layer in enumerate(model.encoder.features)
             if isinstance(layer, torch.nn.Conv2d)]
    for k, index in enumerate(convs):
        conv = variables["params"]["encoder"][f"conv_{k}"]
        w = sd[f"encoder.features.{index}.weight"].numpy()
        np.testing.assert_array_equal(w.transpose(2, 3, 1, 0),
                                      conv["kernel"])
        np.testing.assert_array_equal(
            sd[f"encoder.features.{index}.bias"].numpy(), conv["bias"])
    assert len(sd) == 2 * len(convs) == 26


# ---- the original's outputs ----------------------------------------------- #

@pytest.mark.parametrize("name", BASELINE_CASES)
def test_golden_baseline_replay(name):
    ours, ref = replay_baseline(name)
    assert sorted(ours) == sorted(ref)
    CASES[name].compare(ours, ref)


# ---- C15 ------------------------------------------------------------------ #

def test_c15_checkpoint_key_fails_the_jax_builder(tmp_path, monkeypatch):
    """``validation/Pascal/denet_N3-4-5.yaml``'s model block carries the
    reference's ``checkpoint`` path: the JAX ``Run`` hands it to
    ``build_denet`` with and without ``custom_preprocess`` and raises
    TypeError; the port's builds leave the key out, as they do for every
    model, and build the file's DENet. (The file also lacks ``data_dir``,
    ROADMAP C12: given here on a synthetic VOC root.)"""
    from labelanything_tpu_torch.data.synthetic_voc import write_synthetic_voc

    voc = write_synthetic_voc(str(tmp_path / "voc"), seed=1, num_images=12,
                              embeddings=False)
    cfg = load_yaml("parameters/validation/Pascal/denet_N3-4-5.yaml")
    p = cfg["parameters"]
    assert p["model"]["checkpoint"] == ["checkpoints/DENet/pascal/fold0.bin"]
    p["model"]["resnet_layers"] = [list(TINY)]
    for params in p["dataset"]["datasets"].values():
        params["data_dir"] = [voc["data_dir"]]
    p["dataloader"]["num_workers"] = [0]
    flat = expand_experiment(cfg)[0]
    monkeypatch.setattr(jrun, "create_mesh", lambda: jmesh.create_mesh(
        devices=jax.devices()[:1]))
    with pytest.raises(TypeError, match="checkpoint"):
        jrun.Run().init(flat, run_dir=str(tmp_path / "jax"))
    run = Run().init(flat, run_dir=str(tmp_path / "torch"), device="cpu")
    try:
        assert type(run.state.model).__name__ == "DENetMultiClass"
    finally:
        run.close()
