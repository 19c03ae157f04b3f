"""The port's training entry point against the JAX package's, on the CPU:
``Run`` on a synthetic COCO root with ``parameters/trainval/coco20i/mae.yaml``
at toy width, from the JAX ``Run``'s initial parameters, step by step; and
the CLI's ``experiment`` / ``validate`` with ``--device cpu`` (checkpoints,
metrics, resume), as ``tests/test_runner.py`` checks the JAX package.

Both runs take the sampler's batches in order (the JAX side with
``chunk_steps: 1`` and a one-device mesh). Three faults of the JAX engine
that the port repairs are taken out of the JAX side (see
``tests/test_torch_data.py``): its COCO-20i datasets read an
``instances_path`` they never set, its sampler truncates and permutes the
episode-level prompt types, and its thread-mode loader leaves the episodes
unseeded (the config's ``common.seed`` seeds them). A fourth, its NaN
sentinel's reset, is kept out by running without ``check_nan``. JAX draws
the class rows of ``RandomMatrixEncoder`` from its own random stream: the
rows it draws are recorded and the port replays them. The error points of
substitution are random too, so the substitution case runs with
``num_points: 0``; it is in ``tests/test_torch_run_substitute.py``.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

import jax

from labelanything_tpu.data import coco as jcoco
from labelanything_tpu.experiment import run as jrun
from labelanything_tpu.models import lam as jlam
from labelanything_tpu.parallel import mesh as jmesh
from labelanything_tpu_torch import cli
from labelanything_tpu_torch.data.synthetic_coco import (COCO_CATEGORY_IDS,
                                                         write_synthetic_coco)
from labelanything_tpu_torch.experiment import Run
from labelanything_tpu_torch.experiment.experiment import Experimenter
from labelanything_tpu_torch.models import prompt_encoder as tpe
from labelanything_tpu_torch.train.checkpoint import STATE_FILE
from labelanything_tpu_torch.utils import yaml_subset
from labelanything_tpu_torch.utils.config import expand_experiment, load_yaml
from labelanything_tpu_torch.utils.weights import state_dict_from_jax
from tests.test_torch_baselines import seed_jax_init
from tests.test_torch_data import JaxSamplerEpisodeTypesWhole
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
BANK = 10
# learning rates: 1e-3 without substitution; 1e-6 with it. A pass whose
# example row of a class has no mask (the class has prompts in other rows)
# feeds the prompt encoder's mask_downscaling an all-zero mask: its first
# conv gives its bias, which starts at zero, and the LayerNorm over that
# near-constant vector divides by sqrt(var + 1e-6). Once AdamW has moved the
# bias to about 1e-3 the variance is near that epsilon and the loss follows
# fp32 rounding (its bias gradient reaches 2e3 and the two packages' differ
# by 2 %); the rotations of substitution make such passes, and 16 updates
# at 1e-4 already part the losses by 1 %. At 1e-6 the bias stays far below
# the epsilon's scale and the loop is compared, not that conditioning.
LRS = {False: 1e-3, True: 1e-6}
# the AdamW first moments after the run, all of them as one vector: the
# running mean of every step's gradients, linear in them, held to phase 5's
# relative L2 rule of chip_smoke.py, |m - m_ref|_2 <= MOMENT_REL_L2 *
# |m_ref|_2
MOMENT_REL_L2 = 2e-4
# the parameters' change from the start (final - start), as one vector.
# AdamW divides each element's gradient by that element's own scale, so an
# element's rounding error counts in proportion to its own gradient, not to
# the whole's, and an element whose gradient is zero in exact arithmetic (a
# key projection's bias, under the softmax's shift invariance) moves by
# +-lr on the sign of its rounding: 3.8e-3 (lr 1e-3) and 3.1e-3 (lr 1e-6,
# substitution) here, where the first moments agree to 1.7e-5 and 2.4e-6.
# An update skipped gives 1, a learning rate 2 % off 2e-2.
CHANGE_REL_L2 = 1e-2
# and every element within ELEMENT_STEPS * lr per AdamW update: where a
# gradient is noise-level its sign decides lr * g / (|g| + 1e-8), as in
# tests/test_torch_train.py::_assert_adamw_close
ELEMENT_STEPS = 2.001
# step losses: relative
LOSS_RTOL = 1e-4
# validation mIoU / FB-IoU of the two runs: absolute (argmax ties can fall
# either way between two fp32 models this close)
METRIC_ATOL = 2e-3


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("synthetic_coco_run")
    return write_synthetic_coco(
        str(root), seed=1, num_images=24, embed_dim=48, grid=4,
        sizes=((48, 64), (64, 48), (40, 64), (72, 96)),
        category_ids=COCO_CATEGORY_IDS[:8], classes_per_image=3)


def toy_config(paths, substitute: bool, num_steps: int = 4,
               lr: float = 1e-3) -> dict:
    """mae.yaml (its first grid point) at toy width on the synthetic root:
    64 px, embeddings 48 wide, LAM width 32, bank 10, fp32, a constant
    learning rate (``lr``) so that the steps move the weights."""
    cfg = load_yaml(str(REPO / "parameters/trainval/coco20i/mae.yaml"))
    cfg.pop("other_grids")
    p = cfg["parameters"]
    p["logger"]["log_frequency"] = [1]
    tp = p["train_params"]
    tp.update(max_epochs=[1], initial_lr=[lr], substitute=[substitute],
              num_points=[0], chunk_steps=[1], memory_preflight=[False])
    tp.pop("scheduler")
    p["model"].update(image_embed_dim=[48], embed_dim=[32], image_size=[64],
                      dtype=["float32"])
    p["model"]["class_encoder"].update(embed_dim=[32], bank_size=[BANK])
    for name, d in p["dataset"]["datasets"].items():
        d["instances_path"] = [paths["instances_path"]]
        d["emb_dir"] = [paths["emb_dir"]]
        if name.startswith("val_"):
            d["val_num_samples"] = [8]
    p["dataset"]["common"].update(image_size=[64], seed=[42],
                                  remove_small_annotations=[False])
    p["dataloader"].update(num_steps=[num_steps], num_workers=[2])
    return cfg


def one_shape(cfg: dict) -> dict:
    """One batch shape and one prompt modality, and the N2K1 validation set
    alone: the JAX side compiles one train program and one eval program."""
    p = cfg["parameters"]
    p["dataloader"].update(possible_batch_example_nums=[[[2, 2, 1]]],
                           prompt_types=[["mask"]])
    del p["dataset"]["datasets"]["val_coco20i_N1K1"]
    return cfg


def read_metrics(run_dir) -> list:
    lines = (pathlib.Path(run_dir) / "metrics.jsonl").read_text().splitlines()
    return [json.loads(line) for line in lines]


def _rel_l2(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def _first_moment_from_jax(opt_state) -> dict:
    """optax's Adam first moment (``mu``) of the model's parameters, under
    the port's names."""
    tree = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(opt_state)[0]:
        keys = [getattr(k, "key", getattr(k, "name", None)) for k in path]
        if "mu" in keys and "model" in keys:
            node = tree
            inner = keys[keys.index("model") + 1:]
            for k in inner[:-1]:
                node = node.setdefault(k, {})
            node[inner[-1]] = np.asarray(leaf)
    return {k: v.numpy() for k, v in state_dict_from_jax(tree).items()}


def check_run_matches_jax(coco_root, tmp_path, monkeypatch,
                          substitute: bool) -> None:
    """Four batches through the JAX ``Run`` and the port's from the same
    weights: the losses, the AdamW first moments, the parameters' change
    and the validation metrics."""
    lr = LRS[substitute]
    flat = expand_experiment(one_shape(toy_config(coco_root, substitute,
                                                  lr=lr)))[0]
    # the JAX loop zeroes its NaN sentinel to 0 instead of -1 when it
    # snapshots a metric window, so with check_nan it raises at its second
    # window whatever the loss; both runs go without the sentinel here
    flat["train_params"]["check_nan"] = 0

    # the JAX side: one device, the repaired sampler, the instances path
    monkeypatch.setattr(jrun, "create_mesh", lambda: jmesh.create_mesh(
        devices=jax.devices()[:1]))
    monkeypatch.setattr(jrun, "VariableBatchSampler",
                        JaxSamplerEpisodeTypesWhole)
    monkeypatch.setattr(jcoco.CocoLVISDataset, "instances_path",
                        coco_root["instances_path"], raising=False)
    initial = {}
    lazy_init = jrun.Run._lazy_init

    def keep_initial(self, *args):
        lazy_init(self, *args)
        # copies: the first pass donates these buffers
        initial["model"] = jax.tree.map(np.array, self.state.params["model"])

    monkeypatch.setattr(jrun.Run, "_lazy_init", keep_initial)
    if not substitute:
        # the JAX model's weights from seeded fills, not a compiled init;
        # the substitution case keeps the JAX init, at whose weights its
        # first-moment tolerance was set (its passes at lr 1e-6 follow the
        # conditioning of the masks' LayerNorm, see LRS)
        seed_jax_init(monkeypatch, jlam.Lam)
    rows = []
    permutation = jax.random.permutation

    def recorded(key, x, *args, **kw):
        out = permutation(key, x, *args, **kw)
        if isinstance(x, int) and x == BANK - 1:
            jax.debug.callback(lambda v: rows.append(np.asarray(v)), out,
                               ordered=True)
        return out

    monkeypatch.setattr(jax.random, "permutation", recorded)
    jdir = tmp_path / "jax"
    jax_run = jrun.Run().init(flat, run_dir=str(jdir))
    jax_run.launch()
    jax.effects_barrier()
    monkeypatch.setattr(jax.random, "permutation", permutation)

    # the port: JAX's initial weights and class rows
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

    jlines, tlines = read_metrics(jdir), read_metrics(tdir)
    jloss = [r["train/loss"] for r in jlines if "train/loss" in r]
    tloss = [r["train/loss"] for r in tlines if "train/loss" in r]
    assert len(tloss) == len(jloss) == 4         # a line a batch
    np.testing.assert_allclose(tloss, jloss, rtol=LOSS_RTOL)
    assert np.isfinite(tloss).all()

    final = state_dict_from_jax(jax.tree.map(np.asarray,
                                             jax_run.state.params["model"]))
    start = state_dict_from_jax(initial["model"])
    got = run.state.model.state_dict()
    assert sorted(got) == sorted(final)
    updates = run.state.step
    assert int(jax_run.state.step) == updates
    assert updates == (16 if substitute else 4)     # 4 batches of 3 images
    moved = 0
    for name, ref in final.items():
        ref = ref.numpy()
        moved += not np.array_equal(ref, start[name].numpy())
        np.testing.assert_allclose(got[name].numpy(), ref, rtol=0,
                                   atol=ELEMENT_STEPS * lr * updates,
                                   err_msg=name)
    assert moved > 0
    whole = lambda sd: np.concatenate([sd[k].numpy().ravel() for k in final])
    assert _rel_l2(whole(got) - whole(start),
                   whole(final) - whole(start)) <= CHANGE_REL_L2

    jmu = _first_moment_from_jax(jax_run.state.opt_state)
    # a parameter no step gave a gradient has no AdamW state in the port
    state = run.state.optimizer.state
    tmu = {n: state[p]["exp_avg"].numpy() if p in state else
           np.zeros(tuple(p.shape), np.float32)
           for n, p in run.state.model.named_parameters()}
    assert sorted(tmu) == sorted(jmu)
    assert _rel_l2(np.concatenate([tmu[k].ravel() for k in jmu]),
                   np.concatenate([v.ravel() for v in jmu.values()])
                   ) <= MOMENT_REL_L2

    def val(lines):
        return {k: v for r in lines for k, v in r.items()
                if k.startswith("validate/")}

    jval, tval = val(jlines), val(tlines)
    assert sorted(jval) == sorted(tval) and jval
    for key in jval:
        assert abs(tval[key] - jval[key]) <= METRIC_ATOL, (key, tval[key],
                                                           jval[key])


# substitution on: tests/test_torch_run_substitute.py
@pytest.mark.parametrize("substitute", [False])
def test_run_matches_jax(coco_root, tmp_path, monkeypatch, substitute):
    check_run_matches_jax(coco_root, tmp_path, monkeypatch, substitute)


def test_cli_experiment_validate_and_resume(coco_root, tmp_path):
    """``experiment`` through the CLI on the CPU: checkpoints, metric lines,
    then a second ``Run`` resumes at epoch 1 with the saved parameters and
    AdamW moments bit for bit; ``validate`` reads the checkpoint; the
    commands not ported exit with status 2."""
    cfg = toy_config(coco_root, substitute=True, num_steps=3)
    cfg["parameters"]["train_params"]["num_points"] = [1]
    params = tmp_path / "toy.yaml"
    params.write_text(yaml_subset.dumps(cfg))
    out = tmp_path / "runs"
    assert cli.main(["experiment", "--parameters", str(params), "--out-dir",
                     str(out), "--device", "cpu"]) == 0
    run_dir = out / "run0"
    ckpt = run_dir / "checkpoints"
    assert (ckpt / "latest" / STATE_FILE).exists()
    assert (ckpt / "best" / STATE_FILE).exists()
    lines = read_metrics(run_dir)
    assert any("train/loss" in r for r in lines)
    assert all(np.isfinite(r["train/loss"]) for r in lines
               if "train/loss" in r)
    assert any(k.startswith("validate/val_coco20i_N2K1/") for r in lines
               for k in r)
    run_id = json.loads((run_dir / "run_meta.json").read_text())["run_id"]

    flat = Experimenter(load_yaml(str(params)), device="cpu").runs[0]
    run2 = Run().init(flat, run_dir=str(run_dir), device="cpu")
    assert run2.start_epoch == 1
    assert run2.tracker.resumed and run2.tracker.run_id == run_id
    saved = torch.load(ckpt / "latest" / STATE_FILE, weights_only=True)
    for name, value in run2.state.model.state_dict().items():
        assert torch.equal(value, saved["model"][name]), name
    moments = run2.state.optimizer.state_dict()["state"]
    assert moments
    for idx, entry in saved["optimizer"]["state"].items():
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(moments[idx][key], entry[key]), (idx, key)
    assert run2.state.step == saved["step"] > 0
    assert run2.launch() is None          # nothing left to train
    run2.close()

    assert cli.main(["validate", "--parameters", str(params), "--out-dir",
                     str(tmp_path / "val"), "--checkpoint", str(ckpt),
                     "--device", "cpu"]) == 0
    assert cli.main(["benchmark", "--parameters", str(params)]) == 2
    assert cli.main(["experiment", "--parameters", str(params), "--parallel",
                     "--device", "cpu"]) == 2


@pytest.mark.parametrize("absent", [(), ("points",), ("points", "boxes"),
                                    ("points", "boxes", "masks")])
def test_modality_gating_matches_jax(absent):
    """``drop_absent_modalities`` drops what the JAX one drops (all
    example rows and rows 1..N alone), and ``with_all_modalities`` re-adds
    the same zero prompts."""
    from labelanything_tpu.data.synthetic import random_full_batch
    from labelanything_tpu_torch.experiment.run import (
        drop_absent_modalities, with_all_modalities)
    from labelanything_tpu_torch.typing import BatchKeys

    flags = {"points": BatchKeys.FLAG_POINTS, "boxes": BatchKeys.FLAG_BBOXES,
             "masks": BatchKeys.FLAG_MASKS}
    batch = random_full_batch(batch_size=2, num_examples=2, num_classes=3,
                              image_size=64, embed_dim=8, seed=3)
    for name in absent:
        batch[flags[name]] = np.zeros_like(batch[flags[name]])
    # a modality present on the query row alone
    batch[BatchKeys.FLAG_BBOXES][:, 1:] = 0
    for rows in (None, slice(1, None)):
        got = drop_absent_modalities(batch, example_rows=rows)
        ref = jrun.drop_absent_modalities(batch, example_rows=rows)
        assert sorted(got) == sorted(ref)
    flat = {k: torch.as_tensor(v) for k, v in drop_absent_modalities(
        batch, example_rows=slice(1, None)).items()}
    full = with_all_modalities(flat)
    jfull = jrun.with_all_modalities(
        {k: jax.numpy.asarray(v.numpy()) for k, v in flat.items()})
    assert sorted(full) == sorted(jfull)
    for key, value in jfull.items():
        assert tuple(full[key].shape) == value.shape, key
        np.testing.assert_array_equal(full[key].numpy(), np.asarray(value))


def test_host_confusion_folds_match_jax():
    """The episode-to-global tables and the numpy confusion counts equal
    the JAX ``experiment/run.py`` functions, the cascade of the reference's
    in-place substitution included; and the device fold that ``Run``
    accumulates (per-sample matrices through the tables) equals the pixel
    count through the tables, the global and the binary matrix alike."""
    from labelanything_tpu_torch.train import metrics as tm
    from labelanything_tpu_torch.typing import IGNORE_INDEX

    rng = np.random.default_rng(0)
    b, c_ep, h, w, num_global = 4, 4, 17, 19, 11
    preds = rng.integers(0, c_ep, (b, h, w))
    gts = rng.integers(0, c_ep, (b, h, w))
    gts[rng.random((b, h, w)) < 0.2] = IGNORE_INDEX
    # the last sample's classes have global ranks (2, 6): local 1 -> 2 -> 6
    classes = [[[2, 5], [5, 7]], [[1], [3, 6]], [[4], [2, 9]], [[1, 5], [1]]]
    categories = {k: {"name": str(k)} for k in (10, 1, 2, 3, 4, 5, 6, 7, 9)}
    lut = tm.to_global_lut(classes, categories, c_ep)
    np.testing.assert_array_equal(
        lut, jrun.to_global_lut(classes, categories, c_ep))
    assert lut[3].tolist()[:3] == [0, 6, 6]

    pixels = tm.global_confusion(preds, gts, lut, num_global)
    np.testing.assert_array_equal(
        pixels, jrun.global_confusion(preds, gts, lut, num_global))
    cm_ps = tm.confusion_matrix_per_sample(torch.as_tensor(preds),
                                           torch.as_tensor(gts), c_ep)
    folded = tm.fold_global_confusion(
        np.zeros((num_global, num_global), np.int64), cm_ps.numpy(), lut,
        num_global)
    np.testing.assert_array_equal(folded, pixels)
    np.testing.assert_array_equal(folded, jrun.fold_global_confusion(
        np.zeros((num_global, num_global), np.int64), cm_ps.numpy(), lut,
        num_global))
    np.testing.assert_array_equal(
        tm.fold_confusion_global(cm_ps, torch.as_tensor(lut),
                                 num_global).numpy(), pixels)

    binary = tm.binary_confusion_np(preds, gts)
    np.testing.assert_array_equal(binary, jrun.binary_confusion_np(preds, gts))
    np.testing.assert_array_equal(
        tm.binary_confusion_matrix(torch.as_tensor(preds),
                                   torch.as_tensor(gts)).numpy(), binary)
