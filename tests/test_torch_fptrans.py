"""The port's FPTrans baseline against the JAX package and the original's
golden output, on the CPU:

* the seed point of the farthest-point sampling: ``ops/jax_random.py``'s
  threefry draw equals ``jax.random.categorical(jax.random.key(1289),
  ...)`` bit for bit (the installed JAX, ``jax_threefry_partitionable``
  on), over several shapes, with a row that has no valid pixel (JAX
  clamps it to pixel 0) and a row with one;
* ``compute_multiple_prototypes`` in both seed modes, with a slice of
  fewer valid pixels than prototypes, and ``pairwise_loss``;
* FPTrans at 1-shot (two episodes, a two-block ViT 32 wide at 64 px) with
  the seed point ``first_valid`` and ``random``, the outputs and the
  prompted encoder's tokens, and ``FPTransMultiClass`` at 2-way 1-shot
  with a padded shot and a class that ``FLAG_GTS`` leaves out, at rtol
  1e-3 / atol 5e-4, from the same seeded variables (shapes from
  ``jax.eval_shape``);
* the weights' round trip through the JAX package's
  ``convert_fptrans_state_dict`` and the port's inverse, bit for bit;
* the golden fixture ``fptrans_1shot``;
* the two files of ``parameters/`` that name ``fptrans`` build in the port
  with the JAX model's parameter count (ViT-B/16 at 480 px, depth 10, on
  the meta device);
* K6's rule refuses FPTrans's attention (901 image tokens, 973 with the
  prompts, heads 64 wide): the path launches no kernel.
"""

import functools
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from labelanything_tpu.models import fptrans as jfpt
from labelanything_tpu.models import registry as jreg
from labelanything_tpu.utils import torch_import as jti
from labelanything_tpu_torch.api import build_from_config
from labelanything_tpu_torch.models import fptrans as tfpt
from labelanything_tpu_torch.ops import jax_random
from labelanything_tpu_torch.ops.attention import flash_ok
from labelanything_tpu_torch.utils.config import expand_experiment, load_yaml
from labelanything_tpu_torch.utils.weights import (
    reference_baseline_state_dict, state_dict_from_jax_baseline)
from tests.golden import CASES, fill_state_dict
from tests.test_torch_baselines import seeded_variables
from tests.torch_golden_replay import replay_baseline
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-3, atol=5e-4)
IMG = 64
SMALL = dict(image_size=IMG, embed_dim=32, depth=2, num_heads=2, bg_num=2,
             num_prompt=12, ncls=5)


# ---- the seed point ------------------------------------------------------- #

@pytest.mark.parametrize("rows,n,seed", [(1, 16, 1289), (2, 900, 1289),
                                         (3, 3600, 1289), (4, 37, 7)])
def test_threefry_draw_equals_jax_categorical(rows, n, seed):
    """The draw over each row's valid elements and the random bits, bit for
    bit; row 0 has no valid element, row 1 (where there is one) a single
    one."""
    rng = np.random.default_rng(n)
    valid = rng.random((rows, n)) < 0.3
    valid[0] = False
    if rows > 1:
        valid[1] = False
        valid[1, n // 2] = True
    ref = np.asarray(jax.random.categorical(
        jax.random.key(seed), jnp.where(jnp.asarray(valid), 0.0, -jnp.inf)))
    got = jax_random.categorical_valid(seed, torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.clip(ref, 0, n - 1))
    assert got[0] == 0
    np.testing.assert_array_equal(
        jax_random.random_bits(jax_random.key_of_seed(seed), (rows, n)),
        np.asarray(jax.random.bits(jax.random.key(seed), (rows, n))))
    # the noise: numpy's float32 log against XLA's, which round apart
    np.testing.assert_allclose(
        jax_random.gumbel(jax_random.key_of_seed(seed), (rows, n)),
        np.asarray(jax.random.gumbel(jax.random.key(seed), (rows, n))),
        rtol=1e-6, atol=1e-6)


# ---- prototypes, similarity, the loss -------------------------------------- #

@pytest.mark.parametrize("first", ["first_valid", "random"])
def test_multiple_prototypes_match_jax(first):
    """Two episodes of 2 shots on a 9 x 7 grid, bg_num 4; one slice has
    three valid pixels (fewer than the prototypes: its first four pixels
    are made valid), one none."""
    rng = np.random.default_rng(3)
    fts = rng.standard_normal((2, 2, 9, 7, 8)).astype(np.float32)
    bg = rng.random((2, 2, 9, 7)) < 0.5
    bg[0, 1] = False
    bg[0, 1, 4, 2:5] = True
    bg[1, 0] = False
    ref = np.asarray(jax.jit(functools.partial(
        jfpt.compute_multiple_prototypes, 4, first=first))(
            jnp.asarray(fts), jnp.asarray(bg)))
    got = tfpt.compute_multiple_prototypes(4, torch.from_numpy(fts),
                                           torch.from_numpy(bg), first)
    assert got.shape == ref.shape == (2, 8, 8)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_similarity_and_pairwise_loss_match_jax():
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 6, 5, 8)).astype(np.float32)
    fg = rng.standard_normal((2, 8)).astype(np.float32)
    bg = rng.standard_normal((2, 8, 6)).astype(np.float32)
    valid = np.array([[1, 1, 1, 0, 0, 0], [1] * 6], np.float32)
    ref = np.asarray(jax.jit(jfpt.compute_similarity)(
        jnp.asarray(fg), jnp.asarray(bg), jnp.asarray(q),
        proto_valid=jnp.asarray(valid)))
    got = tfpt.compute_similarity(torch.from_numpy(fg), torch.from_numpy(bg),
                                  torch.from_numpy(q),
                                  proto_valid=torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)

    x1 = rng.standard_normal((2, 2, 8, 30)).astype(np.float32)
    x2 = rng.standard_normal((2, 1, 8, 30)).astype(np.float32)
    y1 = rng.choice([0, 1, 255], (2, 2, 30)).astype(np.float32)
    y2 = rng.choice([0, 1, 255], (2, 1, 30)).astype(np.float32)
    ref = float(jax.jit(jfpt.pairwise_loss)(
        *(jnp.asarray(a) for a in (x1, y1, x2, y2))))
    got = float(tfpt.pairwise_loss(*(torch.from_numpy(a)
                                     for a in (x1, y1, x2, y2))))
    assert got == pytest.approx(ref, rel=1e-5)


# ---- the model ------------------------------------------------------------ #

def _fptrans_inputs(seed: int = 5):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, IMG, IMG, 3)).astype(np.float32)
    sx = rng.standard_normal((2, 1, IMG, IMG, 3)).astype(np.float32)
    sy = (rng.random((2, 1, IMG, IMG)) < 0.4).astype(np.float32)
    return q, sx, sy


@pytest.fixture(scope="module")
def fptrans_variables():
    """Seeded variables of the small JAX FPTrans (the same tree in both
    seed modes)."""
    model = jfpt.FPTrans(**SMALL, shot=1, drop_rate=0.0)
    args = tuple(jnp.asarray(a) for a in _fptrans_inputs())
    return seeded_variables(jax.eval_shape(model.init, jax.random.key(0),
                                           *args), seed=5)


@pytest.mark.parametrize("first", ["first_valid", "random"])
def test_fptrans_matches_jax(fptrans_variables, first):
    """1-shot, two episodes: the logits at the input size and the prompted
    encoder's foreground and background tokens."""
    inputs = _fptrans_inputs()
    jmodel = jfpt.FPTrans(**SMALL, shot=1, drop_rate=0.0, fps_first=first)
    ref = jax.jit(jmodel.apply)(fptrans_variables,
                                *(jnp.asarray(a) for a in inputs))
    model = tfpt.FPTrans(**SMALL, shot=1, drop_rate=0.0,
                         fps_first=first).eval()
    model.load_state_dict(state_dict_from_jax_baseline(
        "fptrans", fptrans_variables), strict=True)
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in inputs))
    assert got["out"].shape == (2, 2, IMG, IMG)
    for key in ("out", "tokens_fg", "tokens_bg"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   **TOL, err_msg=key)


def test_fptrans_multiclass_matches_jax():
    """2-way 1-shot through the registry's builder at the small width (the
    JAX ``build_fptrans`` with the same arguments), the second episode's
    second class unflagged in ``FLAG_GTS``, the first episode's second
    example padded for its class."""
    rng = np.random.default_rng(6)
    b, m, c = 2, 2, 3
    flag = np.zeros((b, m, c), np.int32)
    flag[:, :, 0] = 1
    flag[:, 0, 1] = 1
    flag[1, 1, 2] = 1
    gts = np.ones((b, c), bool)
    gts[1, 2] = False
    batch = {"images": rng.standard_normal((b, m + 1, IMG, IMG, 3)).astype(
                 np.float32),
             "prompt_masks": (rng.random((b, m, c, 32, 32)) < 0.4).astype(
                 np.float32),
             "flag_examples": flag, "flag_gts": gts,
             "dims": np.full((b, m + 1, 2), IMG, np.int32)}
    args = dict(dataset="PASCAL", image_size=IMG, vit_depth=2, shot=2,
                embed_dim=32, num_heads=2, bg_num=2, num_prompt=12)
    jmodel = jreg.model_registry["fptrans"](**args)
    variables = seeded_variables(jax.eval_shape(
        jmodel.init, jax.random.key(0), batch), seed=6)
    ref = np.asarray(jax.jit(jmodel.apply)(variables, batch)["logits"])
    with torch.device("meta"):
        model = build_from_config({"name": "fptrans", **args})
    model = model.to_empty(device="cpu").eval()
    model.load_state_dict(state_dict_from_jax_baseline("fptrans", variables),
                          strict=True)
    with torch.no_grad():
        got = model({k: torch.from_numpy(v) for k, v in batch.items()})
    got = got["logits"].numpy()
    assert got.shape == ref.shape == (b, c, IMG, IMG)
    flagged = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), flagged)
    assert not flagged.all()
    np.testing.assert_allclose(got[flagged], ref[flagged], **TOL)


# ---- weights and the original's output ------------------------------------ #

def test_fptrans_weights_round_trip_through_jax():
    """Reference-layout FPTrans weights (with a classifier head, which no
    path holds) -> the JAX converter (scope ``fptrans.``) -> the port's
    inverse: every kept entry bit for bit, loaded with ``strict=True``
    into the multi-class wrapper."""
    with torch.device("meta"):
        model = tfpt.FPTransMultiClass(**SMALL, shot=1)
    scope = "fptrans."
    shapes = {k[len(scope):]: tuple(v.shape)
              for k, v in model.state_dict().items()}
    extra = {"encoder.backbone.head.weight": (10, 32),
             "original_encoder.head.bias": (10,)}
    start = fill_state_dict({**shapes, **extra}, seed=13)
    back = state_dict_from_jax_baseline("fptrans", {
        "params": jti.convert_fptrans_state_dict(start, prefix=scope)})
    kept = reference_baseline_state_dict("fptrans", start)
    assert sorted(back) == sorted(scope + k for k in kept)
    assert sorted(kept) == sorted(shapes)
    for key, value in kept.items():
        assert torch.equal(back[scope + key], value), key
    model.to_empty(device="cpu").load_state_dict(back, strict=True)


def test_golden_replay():
    ours, ref = replay_baseline("fptrans_1shot")
    assert sorted(ours) == sorted(ref)
    CASES["fptrans_1shot"].compare(ours, ref)


def test_flash_ok_refuses_fptrans_shapes():
    """ViT-B/16 at 480 px: 901 tokens in the frozen encoder, 973 with the
    1-shot prompts (12 x (1 + 5)), heads 64 wide; under 1024 tokens, K6's
    rule sends both to the plain product, on the card as here."""
    grid = 480 // 16
    prompts = 72
    for tokens in (grid * grid + 1, grid * grid + 1 + prompts):
        assert not flash_ok("cuda", tokens, tokens, 64)
    assert flash_ok("cuda", 1024, 1024, 64)


# ---- the files of parameters/ --------------------------------------------- #

FPTRANS_FILES = ("validation/COCO/fptrans_1shot.yaml",
                 "validation/Pascal/fptrans.yaml")


@functools.lru_cache(maxsize=None)
def _jax_count(block: tuple) -> int:
    args = {k: v for k, v in block if k != "name"}
    model = jreg.model_registry["fptrans"](**args)
    size, shots = args["image_size"], args["shot"]
    batch = {"images": jax.ShapeDtypeStruct((1, shots + 1, size, size, 3),
                                            jnp.float32),
             "prompt_masks": jax.ShapeDtypeStruct((1, shots, 2, 64, 64),
                                                  jnp.float32),
             "flag_examples": jax.ShapeDtypeStruct((1, shots, 2), jnp.int32)}
    shapes = jax.eval_shape(model.init, jax.random.key(0), batch)
    return sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))


@pytest.mark.parametrize("path", FPTRANS_FILES)
def test_registry_builds_every_fptrans_file(path):
    """Every grid point's model block builds in the port (meta device) with
    the JAX model's parameter count: two ViT-B/16 at 480 px, depth 10, the
    purifier and the prompt bank (COCO 60 classes, PASCAL 15)."""
    for flat in expand_experiment(load_yaml(str(REPO / "parameters" / path))):
        block = dict(flat["model"])
        with torch.device("meta"):
            model = build_from_config(block)
        assert isinstance(model, tfpt.FPTransMultiClass)
        ours = sum(p.numel() for p in model.parameters())
        assert ours == _jax_count(tuple(sorted(block.items()))), path
