"""The port's evaluation protocols against the JAX package's, on the CPU:
``validate --checkpoint`` (``experiment/evaluate.py``, the fold x rerun
protocol of ``parameters/validation/COCO/mae.yaml`` at toy width on a
synthetic COCO root), every kind of checkpoint it reads, the test protocol
(``Run._test_one`` on ``data/test.py``), and the metric classes of
``train/metrics.py``.

As in ``tests/test_torch_run.py``, the faults of the JAX engine that the
port repairs (ROADMAP C11) are taken out of the JAX side: its COCO-20i
datasets get the ``instances_path`` they never set, its episodes the seed
its thread-mode loader never gives them (``common.seed``). The JAX test
protocol counts its confusion matrix over the categories alone while its
ground truth indexes the background and the categories (ROADMAP C12): its
dataset's ``num_classes`` is raised by one where the two are compared."""

import json
import pathlib
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from labelanything_tpu.data import coco as jcoco
from labelanything_tpu.data import test as jtest
from labelanything_tpu.experiment import evaluate as jeval
from labelanything_tpu.experiment import run as jrun
from labelanything_tpu.models import lam as jlam
from labelanything_tpu.parallel import mesh as jmesh
from labelanything_tpu.train import checkpoint as jckpt
from labelanything_tpu.train import metrics as jmetrics
from labelanything_tpu.train.substitutor import Substitutor as JSubstitutor
from labelanything_tpu_torch import cli
from labelanything_tpu_torch.api import LabelAnything
from labelanything_tpu_torch.data import test as ttest
from labelanything_tpu_torch.data.synthetic_coco import (COCO_CATEGORY_IDS,
                                                         write_synthetic_coco)
from labelanything_tpu_torch.experiment import Run
from labelanything_tpu_torch.experiment import evaluate as teval
from labelanything_tpu_torch.train import metrics as tm
from labelanything_tpu_torch.train.checkpoint import CheckpointManager
from labelanything_tpu_torch.typing import IGNORE_INDEX, BatchKeys
from labelanything_tpu_torch.utils import yaml_subset
from labelanything_tpu_torch.utils.config import expand_experiment, load_yaml
from labelanything_tpu_torch.utils.safetensors import save_file
from labelanything_tpu_torch.utils.weights import state_dict_from_jax
from tests.test_torch_baselines import seed_jax_init
from tests.test_torch_data import JaxSamplerEpisodeTypesWhole
from tests.test_torch_run import METRIC_ATOL
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
SETS = ("val_coco20i_N1K1", "val_coco20i_N2K1")
MODEL = {"image_embed_dim": 48, "embed_dim": 32, "image_size": 64}


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("synthetic_coco_eval")
    return write_synthetic_coco(
        str(root), seed=2, num_images=20, embed_dim=48, grid=4,
        sizes=((48, 64), (64, 48), (40, 64), (72, 96)),
        category_ids=COCO_CATEGORY_IDS[:8], classes_per_image=3)


def toy_validation(paths) -> dict:
    """``parameters/validation/COCO/mae.yaml`` at toy width (64 px,
    embeddings 48 wide, LAM width 32, bank 10) on the synthetic root: its
    N1K1 and N2K1 sets, 4 episodes a set, the four folds of its grids."""
    cfg = load_yaml(str(REPO / "parameters/validation/COCO/mae.yaml"))
    p = cfg["parameters"]
    p["model"].update({k: [v] for k, v in MODEL.items()})
    p["model"]["class_encoder"].update(embed_dim=[32], bank_size=[10])
    p["train_params"] = {"memory_preflight": [False]}
    datasets = p["dataset"]["datasets"]
    for name in list(datasets):
        if name not in SETS:
            del datasets[name]
            for grid in cfg["other_grids"]:
                del grid["dataset"]["datasets"][name]
            continue
        datasets[name].update(instances_path=[paths["instances_path"]],
                              emb_dir=[paths["emb_dir"]], val_num_samples=[4])
    p["dataset"]["common"].update(image_size=[64], seed=[42],
                                  remove_small_annotations=[False])
    p["dataloader"]["num_workers"] = [2]
    return cfg


@pytest.fixture
def jax_side(monkeypatch, coco_root):
    """The JAX ``Run`` on one device with the C11 faults taken out."""
    monkeypatch.setattr(jrun, "create_mesh", lambda: jmesh.create_mesh(
        devices=jax.devices()[:1]))
    monkeypatch.setattr(jrun, "VariableBatchSampler",
                        JaxSamplerEpisodeTypesWhole)
    monkeypatch.setattr(jcoco.CocoLVISDataset, "instances_path",
                        coco_root["instances_path"], raising=False)
    seed_jax_init(monkeypatch, jlam.Lam)


def _jax_state(flat, run_dir):
    """A JAX ``Run``'s train state, initialized as ``evaluate_checkpoint``
    initializes it (from the first validation batch)."""
    run = jrun.Run().init(flat, run_dir=str(run_dir))
    try:
        loader = next(iter(run.val_loaders.values()))
        (batch, _), _ = next(iter(loader))
        device_batch, _ = run._device_batch(batch, example_rows=slice(1, None))
        sub = JSubstitutor(substitute=False)
        sub.reset(device_batch)
        run._lazy_init(*next(sub))
        return run.state
    finally:
        run.close()


def _write_checkpoints(flat, jdir, tdir, tmp_path):
    """A run's ``checkpoints`` directory on each side with ``latest`` and
    ``best`` of different weights (best: every parameter negated): orbax
    trees for the JAX package, ``state.pt`` for the port. Returns the
    latest and best weights in the port's names."""
    state = _jax_state(flat, tmp_path / "jstate")
    latest = jax.tree.map(np.asarray, state.params["model"])
    best = jax.tree.map(lambda x: -x, latest)
    manager = jckpt.CheckpointManager(str(jdir))
    manager.save_latest(state, 0)
    manager.maybe_save_best(
        state._replace(params={**state.params, "model": best}), 0, 0.5)
    run = Run().init(flat, run_dir=str(tmp_path / "tstate"), device="cpu")
    ours = CheckpointManager(str(tdir))
    sd_latest, sd_best = state_dict_from_jax(latest), state_dict_from_jax(best)
    run.state.model.load_state_dict(sd_best)
    assert ours.maybe_save_best(run.state, 0, 0.5)
    run.state.model.load_state_dict(sd_latest)
    ours.save_latest(run.state, 1)
    run.close()
    return sd_latest, sd_best


def test_validate_checkpoint_matches_jax(coco_root, jax_side, tmp_path,
                                         monkeypatch):
    """The repair: ``validate --checkpoint <run>/checkpoints`` through the
    port's CLI and the JAX ``evaluate_checkpoint`` (what its CLI runs) on
    two grids x two reruns take the same weights (``latest`` before
    ``best``) and give the same ``fold{i}/...``, ``mean/miou`` and
    ``mean/fbiou`` keys within METRIC_ATOL; one fold's loader threads end
    with its ``Run``."""
    cfg = toy_validation(coco_root)
    params = tmp_path / "val.yaml"
    params.write_text(yaml_subset.dumps(cfg))
    flat = expand_experiment(cfg)[0]
    jdir, tdir = tmp_path / "jax_ckpt", tmp_path / "torch_ckpt"
    sd_latest, sd_best = _write_checkpoints(flat, jdir, tdir, tmp_path)

    taken = {}
    for mod, key in ((jeval, "jax"), (teval, "torch")):
        load = mod._load_model_params

        def recorded(checkpoint, run, load=load, key=key):
            out = load(checkpoint, run)
            taken.setdefault(key, out)
            return out

        monkeypatch.setattr(mod, "_load_model_params", recorded)
    jres = jeval.evaluate_checkpoint(str(params), str(jdir),
                                     out_dir=str(tmp_path / "jax_eval"),
                                     folds=[0, 1], reruns=2)
    threads = threading.active_count()
    out = tmp_path / "torch_eval"
    assert cli.main(["validate", "--parameters", str(params), "--checkpoint",
                     str(tdir), "--folds", "0,1", "--reruns", "2",
                     "--out-dir", str(out), "--device", "cpu"]) == 0
    for _ in range(100):       # a finished producer thread may be exiting
        if threading.active_count() <= threads:
            break
        time.sleep(0.01)
    assert threading.active_count() <= threads
    tres = json.loads((out / "results.json").read_text())

    # the same weights: latest, on both sides
    jlatest = state_dict_from_jax(jax.tree.map(np.asarray, taken["jax"]))
    for name, value in sd_latest.items():
        assert torch.equal(jlatest[name], value), name
        assert torch.equal(taken["torch"][name], value), name
    assert any(not torch.equal(sd_latest[k], sd_best[k]) for k in sd_best)

    assert sorted(tres) == sorted(jres)
    assert {"mean/miou", "mean/fbiou", "fold0/miou", "fold1/miou"} <= set(tres)
    for fold in (0, 1):
        for name in SETS:
            for metric in ("miou", "fbiou", "bmiou"):
                assert f"fold{fold}/{name}_{metric}" in tres
    for key, value in jres.items():
        assert np.isfinite(tres[key])
        assert abs(tres[key] - value) <= METRIC_ATOL, (key, tres[key], value)


def _toy_flat(coco_root, folds=1):
    cfg = toy_validation(coco_root)
    cfg["other_grids"] = cfg["other_grids"][:folds - 1]
    flat = expand_experiment(cfg)
    return cfg, flat


@pytest.fixture(scope="module")
def port_flat(coco_root, tmp_path_factory):
    """The toy validation file with two folds, written for the CLI, and a
    model of its architecture with seeded weights."""
    cfg, flats = _toy_flat(coco_root, folds=2)
    path = tmp_path_factory.mktemp("evalcfg") / "val.yaml"
    path.write_text(yaml_subset.dumps(cfg))
    model = dict(flats[0]["model"], custom_preprocess=False)
    return str(path), flats[0], LabelAnything(model, device="cpu", seed=3)


def _evaluate(path, checkpoint, out, **kw):
    return teval.evaluate_checkpoint(path, checkpoint, out_dir=str(out),
                                     folds=[0], reruns=1, device="cpu", **kw)


@pytest.fixture(scope="module")
def pretrained_metrics(port_flat, tmp_path_factory):
    """(the model's ``save_pretrained`` directory, the metrics it gives),
    made once for every checkpoint kind."""
    path, _, la = port_flat
    ref_dir = tmp_path_factory.mktemp("pretrained")
    la.save_pretrained(str(ref_dir))
    return ref_dir, _evaluate(path, str(ref_dir),
                              tmp_path_factory.mktemp("ref"))


@pytest.mark.parametrize("kind", ["save_pretrained", "tag_dir", "safetensors",
                                  "pth", "bin"])
def test_every_checkpoint_kind_gives_the_same_metrics(
        port_flat, pretrained_metrics, tmp_path, kind):
    """The same weights as a ``save_pretrained`` directory, a run's tag
    directory, and bare ``.safetensors`` / ``.pth`` / ``.bin`` files in the
    reference's names: each loads into the fold's model bit for bit and
    gives the metrics of the ``save_pretrained`` directory."""
    path, flat, la = port_flat
    ref_dir, ref = pretrained_metrics
    if kind == "save_pretrained":     # a second directory, evaluated anew
        ref_dir = tmp_path / "pretrained"
        la.save_pretrained(str(ref_dir))
    sd = la.model.state_dict()
    if kind == "save_pretrained":
        ckpt = ref_dir
    elif kind == "tag_dir":
        run = Run().init(flat, run_dir=str(tmp_path / "r"), device="cpu")
        run.state.model.load_state_dict(sd)
        CheckpointManager(str(tmp_path / "ck")).save_latest(run.state, 0)
        run.close()
        ckpt = tmp_path / "ck" / "latest"
    elif kind == "safetensors":
        ckpt = tmp_path / "model.safetensors"
        save_file(sd, str(ckpt))
    else:
        ckpt = tmp_path / f"model.{kind}"
        torch.save({"state_dict": sd} if kind == "pth" else sd, ckpt)
    loaded = {}
    load = teval._load_model_params

    def recorded(checkpoint, run):
        loaded.update(load(checkpoint, run))
        return loaded

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(teval, "_load_model_params", recorded)
        got = _evaluate(path, str(ckpt), tmp_path / "out")
    for name, value in sd.items():
        assert torch.equal(loaded[name], value), name
    assert got == ref and "fold0/miou" in got


def test_validate_one_records_batches_and_confusions(port_flat, tmp_path):
    """``Run._validate_one`` keeps each batch's loader wait, loop time and
    episodes, and the host copies of the matrices its metrics come from."""
    _, flat, la = port_flat
    run = Run().init(flat, run_dir=str(tmp_path / "r"), device="cpu")
    try:
        run.state.model.load_state_dict(la.model.state_dict())
        for name in SETS:
            results = run._validate_one(run.val_loaders[name], name)
            times = run.val_batch_times[name]
            assert sum(t[3] for t in times) == 4
            for (t_ask, wait, total, _), nxt in zip(times, times[1:] + [None]):
                assert 0 <= wait <= total
                assert nxt is None or nxt[0] >= t_ask + total
            cm, cm2 = run.confusions[name]
            assert cm.shape[0] == cm.shape[1] > 2 and cm2.shape == (2, 2)
            assert cm.sum() == cm2.sum() > 0
            assert results["miou"] == tm.strict_mean_iou_np(cm)
            assert results["fbiou"] == tm.fb_iou_np(cm2)
    finally:
        run.close()


def test_mismatched_architecture_and_orbax_raise(port_flat, tmp_path):
    """A checkpoint of another width raises ``ValueError`` naming keys, as
    does one of ``trainval/coco20i/mae.yaml`` in the validation file's
    model block; an orbax directory (a JAX run's checkpoints) says it is
    not readable."""
    path, flat, _ = port_flat
    wrong = LabelAnything(dict(flat["model"], embed_dim=16,
                               class_encoder={"name": "RandomMatrixEncoder",
                                              "bank_size": 10,
                                              "embed_dim": 16}),
                          device="cpu", seed=0)
    wrong.save_pretrained(str(tmp_path / "wrong"))
    with pytest.raises(ValueError, match="another shape"):
        _evaluate(path, str(tmp_path / "wrong"), tmp_path / "o1")
    sd = dict(wrong.model.state_dict())
    sd.pop(next(iter(sd)))
    sd["extra.weight"] = torch.zeros(1)
    save_file(sd, str(tmp_path / "partial.safetensors"))
    with pytest.raises(ValueError, match="1 missing .* 1 unexpected"):
        _evaluate(path, str(tmp_path / "partial.safetensors"), tmp_path / "o2")
    # a checkpoint of trainval/coco20i/mae.yaml's block in the validation
    # file's, which sets example_class_attention False
    trained = LabelAnything(dict(flat["model"], example_class_attention=True),
                            device="cpu", seed=0)
    trained.save_pretrained(str(tmp_path / "trained"))
    with pytest.raises(ValueError, match="unexpected .*class_example_att"):
        _evaluate(path, str(tmp_path / "trained"), tmp_path / "o4")
    orbax = tmp_path / "jax_run" / "checkpoints" / "latest"
    orbax.mkdir(parents=True)
    (orbax / "_METADATA").write_text("{}")
    for ckpt in (orbax.parent, orbax):
        with pytest.raises(ValueError, match="orbax"):
            _evaluate(path, str(ckpt), tmp_path / "o3")


def test_folds_compare_and_first_grid_validate(port_flat, tmp_path, capsys):
    """``--folds`` picks grids, ``--compare`` reports result - reference
    and its largest magnitude, ``results.json`` holds what is returned;
    without ``--checkpoint`` the first grid validates with seeded
    weights."""
    path, _, la = port_flat
    la.save_pretrained(str(tmp_path / "ckpt"))
    ref = {"mean/miou": 0.25, "fold1/val_coco20i_N1K1_miou": 0.5,
           "fold0/miou": 0.0}
    (tmp_path / "ref.json").write_text(json.dumps(ref))
    out = tmp_path / "out"
    assert cli.main(["validate", "--parameters", path, "--checkpoint",
                     str(tmp_path / "ckpt"), "--folds", "1", "--reruns", "1",
                     "--compare", str(tmp_path / "ref.json"), "--out-dir",
                     str(out), "--device", "cpu"]) == 0
    res = json.loads((out / "results.json").read_text())
    assert not any(k.startswith("fold0/") for k in res)
    deltas = res["deltas_vs_reference"]
    assert sorted(deltas) == ["fold1/val_coco20i_N1K1_miou", "mean/miou"]
    for key, value in deltas.items():
        assert value == pytest.approx(res[key] - ref[key])
    assert res["max_abs_delta"] == pytest.approx(
        max(abs(v) for v in deltas.values()))
    assert res["mean/miou"] == pytest.approx(res["fold1/miou"])
    capsys.readouterr()
    assert cli.main(["validate", "--parameters", path, "--reruns", "1",
                     "--out-dir", str(tmp_path / "plain"),
                     "--device", "cpu"]) == 0
    plain = json.loads(capsys.readouterr().out)
    assert {f"{s}_miou" for s in SETS} <= set(plain) and "miou" in plain
    assert cli.main(["validate", "--parameters", path, "--compare",
                     str(tmp_path / "none.json")]) == 2


# -- the test protocol --------------------------------------------------------- #

def _test_params(paths) -> dict:
    return {"instances_path": paths["instances_path"],
            "emb_dir": paths["emb_dir"], "image_size": 64, "seed": 5}


def test_test_protocol_class_count_c12(coco_root, tmp_path):
    """C12, shown on the JAX side: the ground truth indexes the background
    and every category with an image (0 .. len(cat2img)), but the JAX
    confusion matrix counts ``num_classes = len(cat2img)`` rows, so a
    perfect prediction loses the last category's pixels (its predictions
    would clip onto the one before). The port's ``num_classes`` counts
    bg + categories, and ``Run._test_one`` sizes its matrix by it. When
    a category has no image, the JAX ground truth's columns
    (``sorted(cat2img)``) part from the support batch's
    (``sorted(categories)``); the port's follow the support batch's."""
    jd = jtest.CocoLVISTestDataset(**_test_params(coco_root))
    td = ttest.CocoLVISTestDataset(**_test_params(coco_root))
    gts = np.stack([jd[i]["gt"] for i in range(len(jd))])
    for i in range(len(td)):
        np.testing.assert_array_equal(td[i]["gt"], gts[i])
    valid = int((gts != IGNORE_INDEX).sum())
    assert gts[gts != IGNORE_INDEX].max() == jd.num_classes
    assert td.num_classes == len(td.categories) + 1 == jd.num_classes + 1
    jcm = np.asarray(jmetrics.confusion_matrix(jnp.asarray(gts),
                                               jnp.asarray(gts),
                                               jd.num_classes))
    assert jcm.sum() < valid            # the last category's pixels dropped
    tcm = tm.confusion_matrix(torch.as_tensor(gts), torch.as_tensor(gts),
                              td.num_classes).numpy()
    assert tcm.sum() == valid and tm.strict_mean_iou_np(tcm) == 1.0

    # the support batches are the same draws, bit for bit
    support, jsupport = td.extract_prompts(), jd.extract_prompts()
    assert sorted(support) == sorted(jsupport)
    for key, value in jsupport.items():
        assert support[key].dtype == value.dtype, key
        np.testing.assert_array_equal(support[key], value, err_msg=key)

    # a category without an image (its annotations removed)
    inst = json.loads(pathlib.Path(coco_root["instances_path"]).read_text())
    gone = sorted(c["id"] for c in inst["categories"])[1]
    inst["annotations"] = [a for a in inst["annotations"]
                           if a["category_id"] != gone]
    path = tmp_path / "instances.json"
    path.write_text(json.dumps(inst))
    params = dict(_test_params(coco_root), instances_path=str(path))
    jd, td = (jtest.CocoLVISTestDataset(**params),
              ttest.CocoLVISTestDataset(**params))
    columns = [-1] + sorted(td.categories)      # the support batch's
    assert td.extract_prompts()[BatchKeys.FLAG_EXAMPLES].shape[-1] == len(
        columns) == td.num_classes
    assert jd.num_classes == len(columns) - 2
    later = max(td.categories)                  # a category after the gap
    jcolumns = [-1] + sorted(jd.cat2img)        # the JAX ground truth's
    for image_id in td.image_ids:
        gt = td.compute_ground_truths([image_id], columns)[0]
        seen = gt == columns.index(later)
        if seen.any():
            break
    assert seen.any()
    jgt = jd.compute_ground_truths([image_id], jcolumns)[0]
    assert (jgt[seen] == columns.index(later) - 1).all()


def test_run_test_one_matches_jax(coco_root, jax_side, tmp_path):
    """``Run._test_one`` against the JAX one from the same weights, C12
    taken out of the JAX side: 20 queries in chunks of 8 (the last padded
    with its own last item), metrics within METRIC_ATOL; then ``cli test``
    on the same file."""
    flat = {"seed": 42, "name": "t",
            "model": {"name": "lam_no_vit", **MODEL,
                      "class_encoder": {"name": "RandomMatrixEncoder",
                                        "bank_size": 10, "embed_dim": 32}},
            "train_params": {"memory_preflight": False},
            "dataset": {"datasets": {"test_coco": _test_params(coco_root)},
                        "common": {}},
            "dataloader": {}}
    jd = jtest.CocoLVISTestDataset(**_test_params(coco_root))
    jd.num_classes += 1
    jax_run = jrun.Run().init(flat, run_dir=str(tmp_path / "jax"))
    jres = jax_run._test_one(jd, "test_coco", 8)
    params = jax.tree.map(np.asarray, jax_run.state.params["model"])
    jax_run.close()

    run = Run().init(flat, run_dir=str(tmp_path / "torch"), device="cpu")
    run.state.model.load_state_dict(state_dict_from_jax(params))
    td = ttest.CocoLVISTestDataset(**_test_params(coco_root))
    assert len(td) == 20
    res = run._test_one(td, "test_coco", 8)
    assert run.test_times["test_coco"]["queries"] == 20
    cm, cm2 = run.confusions["test_coco"]
    valid = sum(int((td[i]["gt"] != IGNORE_INDEX).sum())
                for i in range(len(td)))
    assert cm.shape == (td.num_classes,) * 2 and cm2.shape == (2, 2)
    assert cm.sum() == cm2.sum() == valid     # no pad row, no pixel lost
    assert sorted(res) == sorted(jres) == ["fbiou", "miou"]
    for key, value in jres.items():
        assert np.isfinite(res[key])
        assert abs(res[key] - value) <= METRIC_ATOL, (key, res[key], value)
    # the CLI's test command, whole dataset, seeded weights
    path = tmp_path / "test.yaml"
    path.write_text(yaml_subset.dumps(
        {"parameters": jax.tree.map(lambda v: [v], flat,
                                    is_leaf=lambda v: not isinstance(v, dict))}))
    assert cli.main(["test", "--parameters", str(path), "--out-dir",
                     str(tmp_path / "cli"), "--device", "cpu"]) == 0
    assert cli.main(["test", "--parameters", str(path), "--batch-size", "3",
                     "--out-dir", str(tmp_path / "cli3"),
                     "--device", "cpu"]) == 0
    run.close()


# -- the metric classes -------------------------------------------------------- #

def _episode(n_cls=4, hw=24, seed=25, with_ignore=True):
    rng = np.random.default_rng(seed)
    pred = rng.integers(0, n_cls, (3, hw, hw))
    target = rng.integers(0, n_cls, (3, hw, hw))
    if with_ignore:
        target[:, :, -3:] = IGNORE_INDEX
    return pred, target


@pytest.mark.parametrize("seed", [25, 26, 27])
def test_metric_classes_match_jax(seed):
    """``PmIoU``, ``dm_iou``, ``ImIoU``, ``macro_f1`` and
    ``StreamingBinaryAUC`` against the JAX package's within 1e-7, as
    ``tests/test_metrics.py`` holds the JAX ones to the reference; the
    matrix functions on numpy and on tensors."""
    pred, target = _episode(seed=seed)
    ours, ref = tm.PmIoU(max_label=3), jmetrics.PmIoU(max_label=3)
    ours.update(pred, target)
    ref.update(pred, target)
    assert abs(ours.compute() - ref.compute()) < 1e-7
    assert abs(ours.compute([1, 3]) - ref.compute([1, 3])) < 1e-7

    pred, target = _episode(seed=seed, with_ignore=False)
    cm = tm.confusion_matrix(torch.as_tensor(pred), torch.as_tensor(target), 4)
    jcm = jmetrics.confusion_matrix(jnp.asarray(pred), jnp.asarray(target), 4)
    np.testing.assert_array_equal(cm.numpy(), np.asarray(jcm))
    for fn, jfn in ((tm.dm_iou, jmetrics.dm_iou),
                    (tm.macro_f1, jmetrics.macro_f1)):
        want = float(jfn(jcm))
        assert abs(float(fn(cm)) - want) < 1e-7
        assert abs(float(fn(cm.numpy())) - want) < 1e-7
    absent = cm.clone()
    absent[2] = 0
    absent[:, 2] = 0
    for fn, jfn in ((tm.dm_iou, jmetrics.dm_iou),
                    (tm.macro_f1, jmetrics.macro_f1)):
        assert abs(float(fn(absent)) - float(jfn(jnp.asarray(
            absent.numpy())))) < 1e-7

    rng = np.random.default_rng(seed)
    class_map = np.array([0, 7, 12])
    ours = tm.ImIoU(class_ids=list(range(1, 21)), nclass=20)
    ref = jmetrics.ImIoU(class_ids=list(range(1, 21)), nclass=20)
    for _ in range(3):
        p, t = rng.integers(0, 3, (20, 20)), rng.integers(0, 3, (20, 20))
        ours.update(p, t, class_map)
        ref.update(p, t, class_map)
    assert abs(ours.compute() - ref.compute()) < 1e-7

    scores, labels = rng.random(4000), rng.integers(0, 2, 4000)
    ours, ref = tm.StreamingBinaryAUC(bins=64), jmetrics.StreamingBinaryAUC(
        bins=64)
    ours.update(scores, labels)
    ref.update(scores, labels)
    assert abs(ours.compute() - ref.compute()) < 1e-7
    assert np.isnan(tm.StreamingBinaryAUC().compute())
