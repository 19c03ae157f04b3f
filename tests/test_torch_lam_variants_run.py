"""One AdamW step through the port's ``Run`` on the model block of
``parameters/trainval/pascal/mae_chooser.yaml`` (the GuidedPooler's four
embeddings an example, two classification levels) with its loss, focal
0.8 plus the ``masks`` regularizer 0.2 on the pooler's choices, against the
JAX ``Run`` from the same weights, on the CPU at toy width.

The episodes come from the synthetic COCO root and the toy ``mae.yaml``
set-up of ``tests/test_torch_run.py`` (its data, sampler repairs and
tolerances); only the model block and the loss are mae_chooser.yaml's.
Both runs take one batch through ``train_epoch`` (no validation pass).
The JAX ``Run`` cannot train with the ``masks`` component as it stands:
it initializes its loss on a dummy result without the pooler's choices,
and ``mask_embedding_loss`` raises a KeyError there (ROADMAP C21); the
test gives that dummy call a zero (the component has no parameters to
initialize) and leaves every real call to the JAX function.
"""

import numpy as np

import jax
import jax.numpy as jnp

from labelanything_tpu.data import coco as jcoco
from labelanything_tpu.experiment import run as jrun
from labelanything_tpu.models import lam as jlam
from labelanything_tpu.parallel import mesh as jmesh
from labelanything_tpu.train import losses as jlosses
from labelanything_tpu.typing import ResultDict
from labelanything_tpu_torch.experiment import Run
from labelanything_tpu_torch.utils.config import expand_experiment, load_yaml
from labelanything_tpu_torch.utils.weights import state_dict_from_jax
from tests.test_torch_baselines import seed_jax_init
from tests.test_torch_data import JaxSamplerEpisodeTypesWhole
from tests.test_torch_run import (CHANGE_REL_L2, ELEMENT_STEPS, LOSS_RTOL,
                                  REPO, _rel_l2, coco_root,  # noqa: F401
                                  one_shape, read_metrics, toy_config)
from tests.torch_threads import one_torch_thread  # noqa: F401

LR = 1e-3


def chooser_config(paths) -> dict:
    """The toy mae.yaml run of ``tests/test_torch_run.py`` (one batch of
    2 episodes of 2 examples, mask prompts, a constant learning rate)
    with mae_chooser.yaml's model block at width 32 and its loss."""
    cfg = one_shape(toy_config(paths, substitute=False, num_steps=1, lr=LR))
    chooser = load_yaml(str(REPO / "parameters/trainval/pascal/"
                                   "mae_chooser.yaml"))["parameters"]
    model = dict(chooser["model"])
    model.update(image_embed_dim=[48], embed_dim=[32], image_size=[64],
                 dtype=["float32"])
    p = cfg["parameters"]
    p["model"] = model
    p["train_params"]["loss"] = chooser["train_params"]["loss"]
    return cfg


def test_chooser_adamw_step_through_run_matches_jax(coco_root, tmp_path,
                                                    monkeypatch):
    flat = expand_experiment(chooser_config(coco_root))[0]
    assert flat["model"]["embedding_extraction"] == "pooler"
    assert flat["model"]["classification_levels"] == 2
    assert sorted(flat["train_params"]["loss"]["components"]) == [
        "focal", "masks"]
    flat["train_params"]["check_nan"] = 0
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
    mask_loss = jlosses.mask_embedding_loss
    calls = []

    def without_c21(result, **cfg):
        if ResultDict.MASK_EMBEDDINGS not in result:    # the init's dummy
            return jnp.zeros(())
        calls.append(1)
        return mask_loss(result, **cfg)

    monkeypatch.setattr(jlosses, "mask_embedding_loss", without_c21)
    seed_jax_init(monkeypatch, jlam.Lam)

    jdir = tmp_path / "jax"
    jax_run = jrun.Run().init(flat, run_dir=str(jdir))
    try:
        jax_run.train_epoch(0)
        final = state_dict_from_jax(jax.tree.map(
            np.asarray, jax_run.state.params["model"]))
        jax_steps = int(jax_run.state.step)
    finally:
        jax_run.close()
    assert calls, "the JAX step did not reach the masks loss"
    start = state_dict_from_jax(initial["model"])

    tdir = tmp_path / "torch"
    run = Run().init(flat, run_dir=str(tdir), device="cpu")
    try:
        run.state.model.load_state_dict(start, strict=True)
        run.train_epoch(0)
        got = run.state.model.state_dict()
        assert run.state.step == jax_steps == 1
    finally:
        run.close()

    def losses(run_dir):
        return [(r["train/loss"]) for r in read_metrics(run_dir)
                if "train/loss" in r]

    jloss, tloss = losses(jdir), losses(tdir)
    assert len(jloss) == len(tloss) == 1 and np.isfinite(tloss).all()
    np.testing.assert_allclose(tloss, jloss, rtol=LOSS_RTOL)
    assert sorted(got) == sorted(final)
    # the pooler's choosers and the level reducer are among those moved
    moved = set()
    for name, ref in final.items():
        ref = ref.numpy()
        if not np.array_equal(ref, start[name].numpy()):
            moved.add(name.split(".")[1])
        np.testing.assert_allclose(got[name].numpy(), ref, rtol=0,
                                   atol=ELEMENT_STEPS * LR, err_msg=name)
    assert {"embedding_extraction_module", "level_reducer"} <= moved
    whole = lambda sd: np.concatenate([sd[k].numpy().ravel() for k in final])
    assert _rel_l2(whole(got) - whole(start),
                   whole(final) - whole(start)) <= CHANGE_REL_L2
