"""Training on precomputed embeddings: the port's ``make_train_step`` on a
toy ``lam_no_vit`` (the flagship configuration of
``parameters/trainval/coco20i/mae.yaml``, as the JAX ``bench_train`` drives
it) and on a toy affinity ``lam_no_vit`` (the model block of
``parameters/trainval/other/Affinity/4.2_Affinity_SAM.yaml``), against the
JAX ``make_train_step`` from the same weights and batch, on the CPU.

The rules are ``tests/test_torch_train.py::test_train_step_matches_jax``'s:
loss to 1e-5 relative, every gradient within 1e-3 of its tensor's largest
element plus 1e-8, then the parameters after AdamW. JAX draws the class rows
of ``RandomMatrixEncoder`` from its own random stream: the rows are read
off the bank's gradient, their order off the loss, and the port is pinned
to them. Also here: the flash backward's blocked recompute against the
unblocked one.
"""

import itertools

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from labelanything_tpu.models import build_lam as jbl
from labelanything_tpu.parallel import train_step as jts
from labelanything_tpu.train import losses as jl
from labelanything_tpu.train import optim as jo
from labelanything_tpu_torch.data.synthetic import (flag_every_class,
                                                    random_full_batch)
from labelanything_tpu_torch.models.registry import model_registry
from labelanything_tpu_torch.ops import flash_attention as fa
from labelanything_tpu_torch.parallel.train_step import (init_train_state,
                                                         make_train_step)
from labelanything_tpu_torch.train import losses as tl
from labelanything_tpu_torch.train import substitutor as ts
from labelanything_tpu_torch.typing import BatchKeys, LossDict
from labelanything_tpu_torch.utils.weights import state_dict_from_jax
from tests.test_torch_train import _assert_adamw_close

LR = 5e-5
# mae.yaml's model block at toy width: 64 px (a 4 x 4 grid), embeddings 48
# wide, LAM width 32, bank 10
TOY_FLAGSHIP = dict(image_embed_dim=48, embed_dim=32, image_size=64,
                    spatial_convs=3, class_attention=False,
                    example_attention=False, example_class_attention=True,
                    fusion_transformer="TwoWayTransformer",
                    class_encoder={"name": "RandomMatrixEncoder",
                                   "bank_size": 10})
# 4.2_Affinity_SAM.yaml's model block at toy width: 96 px (a 6 x 6 grid)
TOY_AFFINITY = dict(image_embed_dim=48, embed_dim=32, image_size=96,
                    spatial_convs=3, class_attention=True,
                    example_attention=True, few_type="Affinity",
                    class_fusion="mul",
                    class_encoder={"name": "RandomMatrixEncoder",
                                   "bank_size": 10})


def episode(config: dict, ways: int, shots: int, examples: int,
            include_masks: bool = True, seed: int = 3):
    """``batch_size`` 2 episodes through ``Substitutor(num_points=1,
    substitute=False)``, as ``bench_train`` feeds its step."""
    full = random_full_batch(
        batch_size=2, num_examples=examples, num_classes=ways + 1,
        image_size=config["image_size"], embed_dim=config["image_embed_dim"],
        include_masks=True, seed=seed)
    full = flag_every_class(full, shots)
    if not include_masks:
        full = {k: v for k, v in full.items()
                if k not in (BatchKeys.PROMPT_MASKS, BatchKeys.FLAG_MASKS)}
    sub = ts.Substitutor(num_points=1, substitute=False)
    sub.reset({k: torch.as_tensor(v) for k, v in full.items()})
    return next(sub)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def jax_steps(config: dict, batch, gt, params0=None) -> dict:
    """The JAX step, as ``tests/test_torch_train.py``'s ``jax_run``: the
    gradients g of one pass (scaled by 0.5, ``apply_update=False``), then
    the parameters after one AdamW update on g, made by the optimizer the
    step applies (``tx.update`` on a fresh state), so the step is compiled
    once. ``params0``: start from these parameters, not a fresh init."""
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    jgt = jnp.asarray(gt.numpy())
    model = jbl.build_lam_no_vit(**config)
    loss = jl.LabelAnythingLoss(components={"focal": {"weight": 1.0}},
                                class_weighting=True)
    if params0 is None:
        params0 = _np_tree({"model": jax.jit(model.init)(
            jax.random.key(0), jbatch), "loss": {}})
    params = jax.tree.map(jnp.asarray, params0)
    tx = jo.build_optimizer(params0, name="AdamW", learning_rate=LR)
    step = jts.make_train_step(model, loss, tx)
    # the step donates its state: it gets a copy of the parameters
    state, aux = step(jts.init_train_state(
        jax.tree.map(jnp.asarray, params0), tx), jbatch, jgt,
                      jax.random.key(7), 0.5, apply_update=False)
    half_grads = _np_tree(state.accum)
    grads = jax.tree.map(lambda g: 2.0 * jnp.asarray(g), half_grads)
    updates, _ = tx.update(grads, tx.init(params), params)
    bank = half_grads["model"]["params"]["prompt_encoder"]["class_encoder"][
        "pos_embedding"][0, 0]
    rows = [int(r) for r in np.nonzero(np.abs(bank).sum(axis=-1))[0]]
    return dict(batch=batch, gt=gt, params0=params0, loss=float(aux["loss"]),
                half_grads=half_grads, rows=rows,
                after=_np_tree(optax.apply_updates(params, updates)))


def port_state(config: dict, params0, rows, **extra):
    model = model_registry["lam_no_vit"](**dict(config, **extra))
    model.load_state_dict(state_dict_from_jax(params0["model"]), strict=True)
    model.prompt_encoder.class_encoder.rows = tuple(rows)
    loss = tl.LabelAnythingLoss({"focal": {"weight": 1.0}},
                                class_weighting=True)
    return init_train_state(model, loss, "cpu", name="AdamW",
                            learning_rate=LR)


def pin_rows(config: dict, run: dict) -> tuple:
    """The class rows in class order: background row 0, then the order of
    the other rows whose pass gives the JAX loss."""
    bg, *fg = run["rows"]
    assert bg == 0 and len(fg) == run["batch"][
        BatchKeys.FLAG_EXAMPLES].shape[-1] - 1, run["rows"]
    best = None
    for order in itertools.permutations(fg):
        state = port_state(config, run["params0"], (0,) + order)
        with torch.no_grad():
            result = state.model(run["batch"])
            loss = float(state.loss(result, run["gt"])[LossDict.VALUE])
        gap = abs(loss - run["loss"])
        if best is None or gap < best[0]:
            best = (gap, (0,) + order)
    assert best[0] <= 1e-5 * abs(run["loss"]), best
    return best[1]


def check_step(config: dict, run: dict, rel_l2=None, **extra) -> None:
    """The port's two accumulation passes against the JAX run. With
    ``rel_l2`` each gradient is held to that relative L2 distance instead
    of 1e-3 of its largest element, and the update to the JAX one only
    where the two gradients agree to 1e-3 of each element (the AdamW step
    of a small gradient follows its relative error)."""
    rows = pin_rows(config, run)
    before = state_dict_from_jax(run["params0"]["model"])
    ref_grads = state_dict_from_jax(run["half_grads"]["model"])
    state = port_state(config, run["params0"], rows, **extra)
    step = make_train_step()
    state, aux = step(state, run["batch"], run["gt"], None, 0.5,
                      apply_update=False)
    np.testing.assert_allclose(float(aux["loss"]), run["loss"], rtol=1e-5)
    named = dict(state.model.named_parameters())
    assert set(named) <= set(ref_grads)
    grads = {}
    for key, param in named.items():
        ref = ref_grads[key].numpy()
        got = (np.zeros_like(ref) if param.grad is None
               else param.grad.numpy())
        scale = np.abs(ref).max()
        if rel_l2 is None or scale < 1e-5:
            np.testing.assert_allclose(got, ref, rtol=0,
                                       atol=1e-3 * scale + 1e-8, err_msg=key)
        else:
            assert np.linalg.norm(got - ref) <= rel_l2 * np.linalg.norm(ref), \
                key
        grads[key] = 2.0 * torch.as_tensor(ref)
        if rel_l2 is not None:      # AdamW held where the gradients agree
            grads[key][torch.as_tensor(np.abs(got - ref)
                                       > 1e-3 * np.abs(ref))] = 0.0
    state, _ = step(state, run["batch"], run["gt"], None, 0.5,
                    apply_update=True)
    assert state.step == 1
    _assert_adamw_close(state, before,
                        state_dict_from_jax(run["after"]["model"]), grads)


@pytest.fixture(scope="module")
def flagship_runs():
    """The JAX runs of the toy flagship step, 2 episodes of 2-way 1-shot
    (one example image showing both classes, as ``bench_train``'s 5-way
    1-shot episodes), with and without mask prompts."""
    runs = {True: jax_steps(TOY_FLAGSHIP, *episode(
        TOY_FLAGSHIP, ways=2, shots=2, examples=1))}
    # the same weights: the mask path's parameters get no gradient
    runs[False] = jax_steps(TOY_FLAGSHIP, *episode(
        TOY_FLAGSHIP, ways=2, shots=2, examples=1, include_masks=False),
        runs[True]["params0"])
    return runs


@pytest.mark.parametrize("masks,extra", [
    (True, {}), (False, {}), (True, {"shared_keys": True})],
    ids=["masks", "no_masks", "masks_shared_keys"])
def test_flagship_step_matches_jax(flagship_runs, masks, extra):
    """The toy ``lam_no_vit`` step; ``shared_keys=True`` runs the prompt
    encoder's fusion on the shared-keys form (``ops/twoway_shared.py``),
    whose gradient is the expanded form's."""
    check_step(TOY_FLAGSHIP, flagship_runs[masks], **extra)


@pytest.fixture(scope="module")
def affinity_run():
    """The JAX run of the toy affinity step: 2 episodes of 2-way 1-shot
    (2 example images, every class flagged)."""
    return jax_steps(TOY_AFFINITY, *episode(TOY_AFFINITY, ways=2, shots=1,
                                            examples=2, seed=4))


def test_affinity_step_matches_jax(affinity_run):
    """Gradients to a relative L2 distance of 5e-3: the decoder's MLPs are
    ReLU units, and some pre-activations of its last MLP lie within 1e-5
    of zero (counted here), where fp32 rounding in the two packages
    switches a unit on in one and off in the other. That moves a few
    elements of ``lin1``'s gradient by a few % of the tensor's largest
    element (the rest of the model agrees to about 1e-3 of it); the AdamW
    step is held where the two gradients agree to 1e-3."""
    state = port_state(TOY_AFFINITY, affinity_run["params0"],
                       pin_rows(TOY_AFFINITY, affinity_run))
    lin1 = state.model.mask_decoder.transformer.layers[-1].attention.mlp.lin1
    seen = []
    hook = lin1.register_forward_hook(lambda m, i, o: seen.append(o))
    with torch.no_grad():
        state.model(affinity_run["batch"])
    hook.remove()
    assert int((seen[0].abs() < 1e-5).sum()) > 0
    check_step(TOY_AFFINITY, affinity_run, rel_l2=5e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_flash_blocked_recompute_matches_unblocked(dtype):
    """The flash backward over blocks of query rows (a ragged last block)
    against the recompute at once: dq equal, dk and dv summed over blocks
    within rounding of the other order."""
    gen = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(s, generator=gen, dtype=dtype)
               for s in ((2, 3, 320, 32), (2, 3, 200, 32), (2, 3, 200, 32)))
    dout = torch.randn(q.shape, generator=gen, dtype=dtype)
    whole = fa.flash_attention_bwd_plain(q, k, v, dout, 0.2)
    blocked = fa.flash_attention_bwd_plain(q, k, v, dout, 0.2, rows=128)
    tol = 1e-6 if dtype == torch.float32 else 1e-12
    for got, want in zip(blocked, whole):
        assert got.dtype == want.dtype == dtype
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    assert torch.equal(blocked[0][:, :, :128], whole[0][:, :, :128]) or \
        dtype == torch.float32
    # the rows rule: all rows while the scores fit, else multiples of 64
    assert fa.recompute_rows(q, k, fa.RECOMPUTE_BYTES) == 320
    assert fa.recompute_rows(q, k, 4 * 2 * 3 * 200 * 320) == 320
    assert fa.recompute_rows(q, k, 4 * 2 * 3 * 200 * 130) == 128
    assert fa.recompute_rows(q, k, 1) == 64


def test_plain_attention_fp64_scores():
    """``plain_attention(scores=torch.float64)``: the twin on fp32 operands
    computes its scores and softmax in fp64 (the fp64 twin's output, cast),
    and fp32 again after the block."""
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(1, 2, 64, 32, generator=gen) for _ in range(3))
    fp32 = fa.flash_attention_plain(q, k, v, 0.2)
    with fa.plain_attention(scores=torch.float64):
        fp64 = fa.flash_attention(q, k, v, 0.2)
    want = fa.flash_attention_plain(q.double(), k.double(), v.double(), 0.2)
    assert fp64.dtype == torch.float32
    assert torch.equal(fp64, torch.matmul(
        torch.softmax(torch.matmul(q.double(), k.double().transpose(-1, -2))
                      * 0.2, dim=-1).float(), v))
    torch.testing.assert_close(fp64, want.float(), rtol=1e-5, atol=1e-6)
    assert not torch.equal(fp64, fp32)
    assert torch.equal(fa.flash_attention_plain(q, k, v, 0.2), fp32)


def test_flash_backward_takes_the_blocks(monkeypatch):
    """Through the autograd function: with ``RECOMPUTE_BYTES`` under the
    scores' size the gradient is the blocked recompute's."""
    gen = torch.Generator().manual_seed(2)
    leaves = [torch.randn(s, generator=gen, requires_grad=True)
              for s in ((1, 2, 256, 32), (1, 2, 192, 32), (1, 2, 192, 32))]
    dout = torch.randn(1, 2, 256, 32, generator=gen)
    whole = torch.autograd.grad(fa.flash_attention(*leaves, 0.3), leaves,
                                dout)
    monkeypatch.setattr(fa, "RECOMPUTE_BYTES", 4 * 2 * 192 * 64)
    blocked = torch.autograd.grad(fa.flash_attention(*leaves, 0.3), leaves,
                                  dout)
    want = fa.flash_attention_bwd_plain(*(x.detach() for x in leaves), dout,
                                        0.3, rows=64)
    for got, ref, one in zip(blocked, want, whole):
        assert torch.equal(got, ref)
        torch.testing.assert_close(got, one, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", [(8, 6, 32, 24), (30, 30, 480, 480),
                                   (64, 64, 1024, 1024), (17, 9, 5, 4),
                                   (7, 7, 7, 7)])
def test_resize_gradient_is_the_interpolation_adjoint(shape):
    """``ops.resize.resize_bilinear``'s gradient (the transposed
    interpolation matmuls, which repeat bit for bit on the card) against
    ``F.interpolate``'s own backward in fp64, upsampling and downsampling;
    the forward is ``F.interpolate``'s."""
    import torch.nn.functional as F

    from labelanything_tpu_torch.ops.resize import (interpolation_matrix,
                                                    resize_bilinear)

    hi, wi, ho, wo = shape
    gen = torch.Generator().manual_seed(hi + ho)
    x = torch.randn(2, 3, hi, wi, generator=gen, dtype=torch.float64,
                    requires_grad=True)
    g = torch.randn(2, 3, ho, wo, generator=gen, dtype=torch.float64)
    y = resize_bilinear(x, (ho, wo))
    ours, = torch.autograd.grad(y, x, g)
    x2 = x.detach().requires_grad_()
    y2 = F.interpolate(x2, size=(ho, wo), mode="bilinear",
                       align_corners=False)
    ref, = torch.autograd.grad(y2, x2, g)
    assert torch.equal(y, y2)
    torch.testing.assert_close(ours, ref, rtol=0, atol=1e-12)
    wh = interpolation_matrix(hi, ho, dtype=torch.float64)
    ww = interpolation_matrix(wi, wo, dtype=torch.float64)
    torch.testing.assert_close(wh @ x.detach() @ ww.t(), y2, rtol=0,
                               atol=1e-12)
