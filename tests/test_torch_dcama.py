"""The port's Swin backbone and DCAMA baseline against the JAX package and
the original's golden outputs, on the CPU:

* a small Swin (64 px, window 4, widths 16 to 128, depths (1, 2, 2, 1):
  its last stage's window clamped to the 2 x 2 grid) block by block;
  ``MaskAggregationAttention`` with a padded shot; the DCAMA head at
  1-shot and at 2-shot with the second shot padded; ``DCAMAMultiClass`` at
  2-way 1-shot with a class that ``FLAG_GTS`` leaves out; all from the
  same seeded variables, at rtol 1e-3 / atol 5e-4 (the JAX variables take
  their shapes from ``jax.eval_shape``, and each JAX reference is computed
  once, in a module fixture);
* the weights' round trip through the JAX package's
  ``convert_dcama_state_dict`` and the port's inverse, bit for bit;
* the golden fixtures ``swin_features`` and ``dcama_head_2shot``;
* the four files of ``parameters/`` that name ``dcama`` build in the port
  with the JAX model's parameter count (Swin-B at 384 px, on the meta
  device);
* one SGD step of ``trainval/coco20i/dcama.yaml`` through ``Run`` against
  the JAX ``Run`` (the small Swin put into both registries): the loss and
  every parameter, the frozen backbone's included (ROADMAP C17);
* the two JAX faults of C17 that the port repairs or keeps: a batch whose
  episodes drew no mask prompt, and ``backbone_checkpoint``.
"""

import functools
import json
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from labelanything_tpu.data import coco as jcoco
from labelanything_tpu.experiment import run as jrun
from labelanything_tpu.models import dcama as jdcama
from labelanything_tpu.models import registry as jreg
from labelanything_tpu.models import swin as jswin
from labelanything_tpu.parallel import mesh as jmesh
from labelanything_tpu.utils import torch_import as jti
from labelanything_tpu_torch.api import build_from_config
from labelanything_tpu_torch.experiment import Run
from labelanything_tpu_torch.models import dcama as tdcama
from labelanything_tpu_torch.models import registry as treg
from labelanything_tpu_torch.models import swin as tswin
from labelanything_tpu_torch.ops.attention import flash_ok
from labelanything_tpu_torch.utils.config import expand_experiment, load_yaml
from labelanything_tpu_torch.utils.weights import (
    init_weights, reference_baseline_state_dict, state_dict_from_jax_baseline)
from tests.golden import CASES, fill_state_dict
from tests.test_torch_baselines import seeded_variables
from tests.test_torch_data import JaxSamplerEpisodeTypesWhole
from tests.test_torch_images import image_root  # noqa: F401 (fixture)
from tests.torch_golden_replay import replay_baseline
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-3, atol=5e-4)
IMG = 64
SWIN = dict(img_size=IMG, patch_size=4, window_size=4, embed_dim=16,
            depths=(1, 2, 2, 1), num_heads=(1, 2, 2, 4))
IN_CH = (16, 32, 64, 128)
STACK = (1, 3, 5, 6)


def jax_small_dcama():
    return jdcama.DCAMAMultiClass(image_size=IMG,
                                  backbone=jswin.SwinTransformer(**SWIN),
                                  stack_ids=STACK, in_channels=IN_CH)


def torch_small_dcama(**_):
    return tdcama.DCAMAMultiClass(image_size=IMG,
                                  backbone=tswin.SwinTransformer(**SWIN),
                                  stack_ids=STACK, in_channels=IN_CH)


def episode(ways: int, shots: int, seed: int = 0) -> dict:
    """Two seeded episodes, way-major examples each flagging its class;
    with 2 ways the second episode's last class is left out by
    ``FLAG_GTS``."""
    rng = np.random.default_rng(seed)
    b, c, m = 2, ways + 1, ways * shots
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


def _tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---- the Swin backbone ---------------------------------------------------- #

@pytest.fixture(scope="module")
def swin_case():
    """(images, JAX variables, the JAX features) of the small Swin."""
    x = np.random.default_rng(1).standard_normal((2, IMG, IMG, 3)).astype(
        np.float32)
    model = jswin.SwinTransformer(**SWIN)
    variables = seeded_variables(jax.eval_shape(
        model.init, jax.random.key(0), jnp.asarray(x)), seed=1)
    feats = jax.jit(model.apply)(variables, jnp.asarray(x))
    return x, variables, [np.asarray(f) for f in feats]


def test_swin_features_match_jax(swin_case):
    x, variables, ref = swin_case
    model = tswin.SwinTransformer(**SWIN)
    sd = state_dict_from_jax_baseline("dcama", {"params": {
        "feature_extractor": variables["params"]}})
    model.load_state_dict({k[len("feature_extractor."):]: v
                           for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert len(got) == len(ref) == 6
    # the last stage's 2 x 2 grid is under the window: clamped, unshifted
    assert model.layers[3].blocks[0].window_size == 2
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), r, **TOL, err_msg=f"block {i}")


def test_shifted_window_mask_and_index_match_jax():
    for h, ws, shift in ((8, 4, 2), (12, 4, 2), (24, 12, 6)):
        np.testing.assert_array_equal(
            tswin.shifted_window_attn_mask(h, h, ws, shift),
            jswin.shifted_window_attn_mask(h, h, ws, shift))
        np.testing.assert_array_equal(tswin.relative_position_index(ws),
                                      jswin.relative_position_index(ws))
    np.testing.assert_array_equal(tdcama.sine_pe(36, 32),
                                  jdcama._sine_pe(36, 32))


# ---- the head ------------------------------------------------------------- #

def test_mask_aggregation_attention_matches_jax():
    """Two episodes of 2 shots, the second shot of the second episode
    padded (its keys at -1e9)."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 16, 32)).astype(np.float32)
    k = rng.standard_normal((2, 40, 32)).astype(np.float32)
    mask = (rng.random((2, 40)) < 0.5).astype(np.float32)
    valid = np.ones((2, 40), np.float32)
    valid[1, 20:] = 0
    jmod = jdcama.MaskAggregationAttention(d_model=32)
    args = tuple(jnp.asarray(a) for a in (q, k, mask, valid))
    variables = seeded_variables(jax.eval_shape(
        jmod.init, jax.random.key(0), *args), seed=2)
    ref = np.asarray(jax.jit(jmod.apply)(variables, *args))
    tmod = tdcama.MaskAggregationAttention(32)
    sd = state_dict_from_jax_baseline("dcama", {"params": {
        "dcama_block_0": variables["params"]}})
    tmod.load_state_dict({k[len("DCAMA_blocks.0."):]: v
                          for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = tmod(*(torch.from_numpy(a) for a in (q, k, mask, valid)))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def _head_inputs(swin_feats, shots: int, seed: int):
    """Per-block query and support features (the small Swin's, at batch 1
    a shot) and 64-px support masks."""
    rng = np.random.default_rng(seed)
    query = [f[:1] for f in swin_feats]
    support = [np.stack([f[1:2] + 0.1 * s for s in range(shots)], axis=1)
               for f in swin_feats]
    mask = (rng.random((1, shots, IMG, IMG)) < 0.4).astype(np.float32)
    return query, support, mask


@pytest.mark.parametrize("shots,flags", [(1, None), (2, (1.0, 0.0))])
def test_dcama_head_matches_jax(swin_case, shots, flags):
    """The head at 1-shot, and at 2-shot with the second shot padded (its
    keys out of every attention and out of the skip features' maximum)."""
    query, support, mask = _head_inputs(swin_case[2], shots, seed=shots)
    jflags = None if flags is None else np.asarray([flags], np.float32)
    jmod = jdcama.DCAMAModel(in_channels=IN_CH, stack_ids=STACK)
    args = ([jnp.asarray(q) for q in query], [jnp.asarray(s) for s in support],
            jnp.asarray(mask), None if jflags is None else jnp.asarray(jflags))
    variables = seeded_variables(jax.eval_shape(
        jmod.init, jax.random.key(0), *args), seed=3)
    ref = np.asarray(jax.jit(jmod.apply)(variables, *args))
    tmod = tdcama.DCAMAModel(in_channels=IN_CH, stack_ids=STACK)
    sd = state_dict_from_jax_baseline("dcama", {"params": {
        "model": variables["params"]}})
    tmod.load_state_dict({k[len("model."):]: v for k, v in sd.items()},
                         strict=True)
    with torch.no_grad():
        got = tmod([torch.from_numpy(q) for q in query],
                   [torch.from_numpy(s) for s in support],
                   torch.from_numpy(mask),
                   None if jflags is None else torch.from_numpy(jflags))
    assert got.shape == (1, 2, IMG, IMG)
    np.testing.assert_allclose(got.numpy(), ref.transpose(0, 3, 1, 2), **TOL)


def test_dcama_multiclass_matches_jax():
    """2-way 1-shot through the registry's wrapper (the small Swin): the
    classes' merge, the resize and the unflagged class at -inf."""
    batch = episode(2, 1, seed=4)
    jmodel = jax_small_dcama()
    variables = seeded_variables(jax.eval_shape(
        jmodel.init, jax.random.key(0), batch), seed=4)
    ref = np.asarray(jax.jit(jmodel.apply)(variables, batch)["logits"])
    model = torch_small_dcama().eval()
    model.load_state_dict(state_dict_from_jax_baseline("dcama", variables),
                          strict=True)
    with torch.no_grad():
        got = model(_tensors(batch))["logits"].numpy()
    assert got.shape == ref.shape == (2, 3, IMG, IMG)
    flagged = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), flagged)
    assert not flagged.all()
    np.testing.assert_allclose(got[flagged], ref[flagged], **TOL)


# ---- weights and the original's outputs ----------------------------------- #

def test_dcama_weights_round_trip_through_jax():
    """Reference-layout DCAMA weights (with the buffers and Swin's
    classifier the reference holds) -> the JAX converter -> the port's
    inverse: every kept entry bit for bit, loaded with ``strict=True``."""
    with torch.device("meta"):
        model = torch_small_dcama()
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    extra = {"feature_extractor.norm.weight": (128,),
             "feature_extractor.head.weight": (10, 128),
             "feature_extractor.layers.1.blocks.1.attn_mask": (4, 16, 16),
             "feature_extractor.layers.0.blocks.0.attn"
             ".relative_position_index": (16, 16),
             "model.pe.0.pe": (1, 100, 32)}
    start = fill_state_dict({**shapes, **extra}, seed=12)
    start.update({k: np.zeros(v, np.float32) for k, v in extra.items()
                  if k not in start})
    back = state_dict_from_jax_baseline(
        "dcama", {"params": jti.convert_dcama_state_dict(start)})
    kept = reference_baseline_state_dict("dcama", start)
    assert sorted(back) == sorted(kept) == sorted(shapes)
    for key, value in kept.items():
        assert torch.equal(back[key], value), key
    model.to_empty(device="cpu").load_state_dict(back, strict=True)


@pytest.mark.parametrize("name", ["swin_features", "dcama_head_2shot"])
def test_golden_replay(name):
    ours, ref = replay_baseline(name)
    assert sorted(ours) == sorted(ref)
    CASES[name].compare(ours, ref)


def test_flash_ok_refuses_swin_shapes():
    """Swin-B's windows (144 tokens, heads 32 wide in every stage) are
    outside K6's rule, and DCAMA's mask aggregation (its values a mask)
    does not go through ``dot_product_attention``: the path launches no
    kernel."""
    assert not flash_ok("cuda", 144, 144, 32)
    assert flash_ok("cuda", 1024, 1024, 32)


# ---- the files of parameters/ --------------------------------------------- #

DCAMA_FILES = ("validation/COCO/dcama.yaml", "validation/Pascal/dcama.yaml",
               "trainval/coco20i/dcama.yaml", "trainval/pascal/dcama.yaml")


@functools.lru_cache(maxsize=None)
def _jax_count(block: tuple) -> int:
    args = {k: v for k, v in block if k != "name"}
    model = jreg.model_registry["dcama"](**args)
    size = args.get("image_size", 384)
    batch = {"images": jax.ShapeDtypeStruct((1, 2, size, size, 3),
                                            jnp.float32),
             "prompt_masks": jax.ShapeDtypeStruct((1, 1, 2, 64, 64),
                                                  jnp.float32),
             "flag_examples": jax.ShapeDtypeStruct((1, 1, 2), jnp.int32)}
    shapes = jax.eval_shape(model.init, jax.random.key(0), batch)
    return sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))


@pytest.mark.parametrize("path", DCAMA_FILES)
def test_registry_builds_every_dcama_file(path):
    """Every grid point's model block builds in the port (meta device) with
    the JAX model's parameter count: Swin-B at 384 px and the head. (The
    JAX builder drops ``backbone_checkpoint``, C17: the count of a block is
    that of the block without it, traced once.)"""
    for flat in expand_experiment(load_yaml(str(REPO / "parameters" / path))):
        block = dict(flat["model"])
        with torch.device("meta"):
            model = build_from_config(block)
        assert isinstance(model, tdcama.DCAMAMultiClass)
        ours = sum(p.numel() for p in model.parameters())
        traced = {k: v for k, v in block.items()
                  if k != "backbone_checkpoint"}
        assert ours == _jax_count(tuple(sorted(traced.items()))), path


def test_c17_backbone_checkpoint_is_dropped_by_both():
    """``trainval/pascal/dcama.yaml`` names the Swin-B checkpoint the
    original loads; the file is not in the repository and both packages
    build the model without it (C17). The port drops it by name in
    ``build_from_config`` alone: its builders raise on a key they do not
    know, where the JAX ones take any."""
    block = expand_experiment(load_yaml(
        str(REPO / "parameters/trainval/pascal/dcama.yaml")))[0]["model"]
    assert block["backbone_checkpoint"].endswith(".pth")
    args = {k: v for k, v in block.items() if k != "name"}
    assert isinstance(jreg.model_registry["dcama"](**args),
                      jdcama.DCAMAMultiClass)
    with torch.device("meta"):
        assert isinstance(build_from_config(dict(block)),
                          tdcama.DCAMAMultiClass)
        for name in ("dcama", "fptrans"):
            with pytest.raises(TypeError, match="backbone_checkpoint"):
                treg.model_registry[name](
                    backbone_checkpoint=block["backbone_checkpoint"])


def test_c17_batch_without_mask_prompts():
    """A training batch whose episodes all drew points or boxes loses its
    mask prompts (``drop_absent_modalities``): the JAX DCAMA raises
    KeyError, the port's takes empty support masks."""
    batch = episode(1, 1, seed=5)
    del batch["prompt_masks"]
    with pytest.raises(KeyError):
        jax.eval_shape(jax_small_dcama().init, jax.random.key(0), batch)
    with torch.device("meta"):
        model = torch_small_dcama()
    model = model.to_empty(device="cpu")
    init_weights(model, 0)
    with torch.no_grad():
        out = model.eval()(_tensors(batch))["logits"]
    assert out.shape == (2, 2, IMG, IMG) and torch.isfinite(out).all()


# ---- one SGD step through Run --------------------------------------------- #

def _train_config(paths: dict) -> dict:
    """``trainval/coco20i/dcama.yaml``'s first grid point on the image root
    at 64 px: one of its tuples ([2, 1, 2]: two episodes of 1-way 2-shot),
    mask prompts, one step, no validation set, 2 loader threads; the
    warm-up dropped (its first step has learning rate 0) and the weight
    decay raised from 2.5e-5 to 0.05, so that the frozen backbone's decay
    shows in fp32."""
    cfg = load_yaml(str(REPO / "parameters/trainval/coco20i/dcama.yaml"))
    cfg.pop("other_grids")
    p = cfg["parameters"]
    tp = p["train_params"]
    tp.update(max_epochs=[1], weight_decay=[0.05], check_nan=[0],
              chunk_steps=[1], memory_preflight=[False])
    tp.pop("scheduler")
    p["model"]["image_size"] = [IMG]
    datasets = p["dataset"]["datasets"]
    for name in [n for n in datasets if n.startswith("val_")]:
        del datasets[name]
    datasets["coco20i"].update(instances_path=[paths["instances_path"]],
                               img_dir=[paths["img_dir"]])
    p["dataset"]["common"].update(image_size=[IMG], seed=[42],
                                  remove_small_annotations=[False])
    p["dataloader"].update(possible_batch_example_nums=[[[2, 1, 2]]],
                           prompt_types=[["mask"]], num_steps=[1],
                           num_workers=[2])
    return cfg


def test_sgd_step_through_run_matches_jax(image_root, tmp_path,  # noqa: F811
                                          monkeypatch):
    """One SGD step (lr 5e-3, momentum 0.9, coupled weight decay) from the
    same weights: the loss within 1e-4, every parameter within 1e-4 of
    JAX's (the step moves them by lr x (gradient + decay)). The backbone,
    frozen by a stop-gradient, still decays in JAX: the port's step gives
    it zero gradients, so it decays there too and equals JAX's, and it
    has moved from its start (ROADMAP C17)."""
    flat = expand_experiment(_train_config(image_root))[0]
    monkeypatch.setitem(jreg.model_registry, "dcama",
                        lambda **_: jax_small_dcama())
    monkeypatch.setitem(treg.model_registry, "dcama", torch_small_dcama)
    monkeypatch.setattr(jrun, "create_mesh", lambda: jmesh.create_mesh(
        devices=jax.devices()[:1]))
    monkeypatch.setattr(jrun, "VariableBatchSampler",
                        JaxSamplerEpisodeTypesWhole)
    monkeypatch.setattr(jcoco.CocoLVISDataset, "instances_path",
                        image_root["instances_path"], raising=False)
    initial = {}
    lazy_init = jrun.Run._lazy_init

    def keep_initial(self, *args):
        lazy_init(self, *args)
        # copies: the first pass donates these buffers
        initial["variables"] = jax.tree.map(np.array,
                                            self.state.params["model"])

    monkeypatch.setattr(jrun.Run, "_lazy_init", keep_initial)
    jax_run = jrun.Run().init(flat, run_dir=str(tmp_path / "jax"))
    model_init = type(jax_run.model).init

    def seeded_init(self, rng, *args, **kwargs):
        return seeded_variables(jax.eval_shape(
            functools.partial(model_init, self), rng, *args, **kwargs))

    monkeypatch.setattr(type(jax_run.model), "init", seeded_init)
    try:
        jax_run.train_epoch(0)
        final = state_dict_from_jax_baseline("dcama", jax.tree.map(
            np.asarray, jax_run.state.params["model"]))
        jax_steps = int(jax_run.state.step)
    finally:
        jax_run.close()
    start = state_dict_from_jax_baseline("dcama", initial["variables"])

    run = Run().init(flat, run_dir=str(tmp_path / "torch"), device="cpu")
    try:
        run.state.model.load_state_dict(start, strict=True)
        train_step = run.train_step
        seen = []

        def kept(state, *args, **kw):
            state, aux = train_step(state, *args, **kw)
            seen.append(float(aux["loss"]))
            return state, aux

        run.train_step = kept
        run.train_epoch(0)
        got = run.state.model.state_dict()
        assert run.state.step == jax_steps == 1
    finally:
        run.close()
    jlines = (tmp_path / "jax" / "metrics.jsonl").read_text().splitlines()
    jloss = [json.loads(line)["train/loss"] for line in jlines
             if "train/loss" in line]
    assert len(seen) == len(jloss) == 1
    np.testing.assert_allclose(seen, jloss, rtol=1e-4)
    assert sorted(got) == sorted(final)
    backbone_moved = 0
    for name, ref in final.items():
        np.testing.assert_allclose(got[name].numpy(), ref.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
        if name.startswith("feature_extractor."):
            backbone_moved += not torch.equal(ref, start[name])
    assert backbone_moved > 0
