"""The ResNet / VGG baselines through the port's entry points, on the CPU:

* every one of the 14 files of ``parameters/validation`` that names
  ``bam``, ``hdmnet``, ``panet``, ``denet`` or ``ppnet`` builds in the
  port's registry (on the meta device), with as many parameters and
  running statistics as the JAX model has parameters and batch stats;
* ``cli validate`` of ``validation/COCO/{bam_1shot,hdmnet_1shot,panet}.yaml``
  on a synthetic COCO image root (tiny ResNets, 65 px, 2 episodes a set)
  gives the confusion matrices of the JAX ``Run.validate`` on the same
  episodes from the same weights (seeded values in place of the JAX
  model's compiled ``init``, which costs more than its forward). The
  faults of the JAX engine that the port repairs (ROADMAP C11) are taken
  out of the JAX side as ``tests/test_torch_evaluate.py`` does.
"""

import functools
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from labelanything_tpu.data import coco as jcoco
from labelanything_tpu.experiment import run as jrun
from labelanything_tpu.models.registry import model_registry as jregistry
from labelanything_tpu.parallel import mesh as jmesh
from labelanything_tpu_torch import cli
from labelanything_tpu_torch.api import build_from_config
from labelanything_tpu_torch.experiment import run as run_mod
from labelanything_tpu_torch.utils import yaml_subset
from labelanything_tpu_torch.utils.config import expand_experiment, load_yaml
from labelanything_tpu_torch.utils.weights import state_dict_from_jax_baseline
from tests.test_torch_baselines import seeded_variables
from tests.test_torch_data import JaxSamplerEpisodeTypesWhole
from tests.test_torch_images import image_root  # noqa: F401 (fixture)
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
BASELINE_FILES = sorted(
    str(p.relative_to(REPO)) for p in (REPO / "parameters/validation").rglob(
        "*.yaml")
    if p.stem.split("_")[0] in ("bam", "hdmnet", "panet", "denet", "ppnet"))
TINY = [1, 1, 1, 2]


def test_the_fourteen_files():
    assert len(BASELINE_FILES) == 14, BASELINE_FILES


def _jax_batch(model_block: dict) -> dict:
    """A 1-way 1-shot episode of 65 px (parameter shapes do not depend on
    the episode's size, except PPNet's batch of 1 and the shots)."""
    shots = model_block.get("shots", 1)
    b, m, c, s = 1, shots, 2, 65
    return {"images": jax.ShapeDtypeStruct((b, m + 1, s, s, 3), jnp.float32),
            "prompt_masks": jax.ShapeDtypeStruct((b, m, c, s, s),
                                                 jnp.float32),
            "flag_examples": jax.ShapeDtypeStruct((b, m, c), jnp.int32),
            "flag_gts": jax.ShapeDtypeStruct((b, c), jnp.bool_),
            "dims": jax.ShapeDtypeStruct((b, m + 1, 2), jnp.int32)}


@functools.lru_cache(maxsize=None)
def _jax_count(block: tuple) -> tuple:
    """(class name, parameters plus batch stats) of the JAX model of a
    model block (the JAX builders take no ``checkpoint``: ROADMAP C15)."""
    block = dict(block)
    args = {k: v for k, v in block.items()
            if k not in ("name", "checkpoint")}
    model = jregistry[block["name"]](**args)
    shapes = jax.eval_shape(model.init, jax.random.key(0), _jax_batch(block))
    return model.__class__.__name__, sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))


@pytest.mark.parametrize("path", BASELINE_FILES)
def test_registry_builds_every_baseline_file(path):
    """Each grid point's model block builds in the port (meta device) with
    the JAX model's count of parameters plus batch stats: the port's
    parameters plus its running means and variances."""
    blocks = {repr(sorted(flat["model"].items())): dict(flat["model"])
              for flat in expand_experiment(load_yaml(str(REPO / path)))}
    assert len(blocks) == 1, path
    for block in blocks.values():
        with torch.device("meta"):
            model = build_from_config(block)
        ours = sum(p.numel() for p in model.parameters()) + sum(
            b.numel() for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var")))
        key = tuple(sorted((k, tuple(v) if isinstance(v, list) else v)
                           for k, v in block.items()))
        assert (model.__class__.__name__, ours) == _jax_count(key), path


# ---- cli validate against the JAX Run.validate --------------------------- #

VALIDATE = {"bam_1shot.yaml": {"resnet_layers": [TINY]},
            "hdmnet_1shot.yaml": {"resnet_layers": [TINY]},
            "panet.yaml": {"image_size": [65]}}


def _validation_config(name: str, paths: dict) -> dict:
    """``validation/COCO/<name>`` on the image root: 65 px, 2 episodes a
    set, the model block's backbone cut (``VALIDATE``), the engine's seed
    set (C11), 2 loader threads."""
    cfg = load_yaml(str(REPO / "parameters/validation/COCO" / name))
    p = cfg["parameters"]
    p["model"].update(VALIDATE[name])
    p["train_params"] = {"memory_preflight": [False]}
    for params in p["dataset"]["datasets"].values():
        params.update(instances_path=[paths["instances_path"]],
                      img_dir=[paths["img_dir"]], val_num_samples=[2])
    p["dataset"]["common"].update(image_size=[65], seed=[42],
                                  remove_small_annotations=[False])
    p["dataloader"]["num_workers"] = [2]
    p["val_params"]["reruns"] = [1]
    return cfg


@pytest.mark.parametrize("name", sorted(VALIDATE))
def test_cli_validate_matches_jax(name, image_root, tmp_path,  # noqa: F811
                                  monkeypatch):
    cfg = _validation_config(name, image_root)
    flat = expand_experiment(cfg)[0]
    model_name = flat["model"]["name"]
    monkeypatch.setattr(jrun, "create_mesh", lambda: jmesh.create_mesh(
        devices=jax.devices()[:1]))
    monkeypatch.setattr(jrun, "VariableBatchSampler",
                        JaxSamplerEpisodeTypesWhole)
    monkeypatch.setattr(jcoco.CocoLVISDataset, "instances_path",
                        image_root["instances_path"], raising=False)
    initial, jax_cms = {}, []
    lazy_init = jrun.Run._lazy_init

    def keep_initial(self, *args):
        lazy_init(self, *args)
        initial["model"] = jax.tree.map(np.array, self.state.params["model"])

    monkeypatch.setattr(jrun.Run, "_lazy_init", keep_initial)
    strict, fb = jrun.strict_mean_iou_np, jrun.fb_iou_np
    monkeypatch.setattr(jrun, "strict_mean_iou_np",
                        lambda cm: (jax_cms.append([cm]), strict(cm))[1])
    monkeypatch.setattr(jrun, "fb_iou_np",
                        lambda cm2: (jax_cms[-1].append(cm2), fb(cm2))[1])
    jax_run = jrun.Run().init(flat, run_dir=str(tmp_path / "jax"))
    model_init = type(jax_run.model).init

    def seeded_init(self, rng, *args, **kwargs):
        return seeded_variables(jax.eval_shape(
            functools.partial(model_init, self), rng, *args, **kwargs))

    monkeypatch.setattr(type(jax_run.model), "init", seeded_init)
    try:
        jax_metrics = jax_run.validate(epoch=0)
    finally:
        jax_run.close()

    # the port: cli validate, its model given the JAX initial weights
    build = run_mod.build_on_device

    def with_jax_weights(config, device, seed):
        model = build(config, device, None)
        model.load_state_dict(state_dict_from_jax_baseline(
            model_name, initial["model"]), strict=True)
        return model

    records = []
    validate_one = run_mod.Run._validate_one

    def kept(self, loader, set_name, epoch=None):
        out = validate_one(self, loader, set_name, epoch)
        records.append((set_name, self.confusions[set_name], out))
        return out

    monkeypatch.setattr(run_mod, "build_on_device", with_jax_weights)
    monkeypatch.setattr(run_mod.Run, "_validate_one", kept)
    path = tmp_path / name
    path.write_text(yaml_subset.dumps(cfg))
    assert cli.main(["validate", "--parameters", str(path), "--out-dir",
                     str(tmp_path / "torch"), "--device", "cpu"]) == 0
    assert len(records) == len(jax_cms) == len(flat["dataset"]["datasets"])
    for (set_name, (cm, cm2), metrics), (jcm, jcm2) in zip(records, jax_cms):
        assert cm.sum() > 0
        np.testing.assert_array_equal(cm, jcm, err_msg=set_name)
        np.testing.assert_array_equal(cm2, jcm2, err_msg=set_name)
        for key, value in metrics.items():
            assert value == pytest.approx(jax_metrics[f"{set_name}_{key}"])
