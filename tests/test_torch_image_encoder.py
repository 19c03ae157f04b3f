"""The port's SAM ViT image encoder against the JAX package's, on the CPU.

Toy size: 128 px, patch 16 (an 8 x 8 grid), depth 2 with block 1 global,
window 3 (so windows are padded from 8 to 9 and pad tokens are attended),
embed 128 with 2 heads of width 64 (the kernels' width; on the CPU the
wrappers take their plain twins). JAX initializes the weights, the
relative-position tables are then filled with nonzero values, and
``utils/weights.py`` carries them across with ``strict=True``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from labelanything_tpu.models import image_encoder as jie
from labelanything_tpu_torch.models import image_encoder as tie
from labelanything_tpu_torch.models.build_encoder import build_vit_b
from labelanything_tpu_torch.utils.weights import state_dict_from_jax
from tests.golden import CASES, load_fixture, make_weights
from tests.test_torch_baselines import jax_init
from tests.torch_threads import one_torch_thread  # noqa: F401

TOY_VIT = dict(img_size=128, patch_size=16, embed_dim=128, depth=2,
               num_heads=2, window_size=3, global_attn_indexes=(1,),
               out_chans=32)


def nonzero_rel_pos(params, seed=0, std=0.05):
    """JAX params with every rel_pos_h / rel_pos_w table drawn from
    N(0, std): zero tables (the init) would hide bias indexing bugs."""
    rng = np.random.default_rng(seed)

    def fill(path, x):
        if path[-1].key in ("rel_pos_h", "rel_pos_w"):
            return jnp.asarray(rng.normal(0.0, std, x.shape).astype(np.float32))
        return x

    return jax.tree_util.tree_map_with_path(fill, params)


def test_window_partition_roundtrip_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 8, 7, 5)).astype(
        np.float32)
    ours, pad_hw = tie.window_partition(torch.from_numpy(x), 3)
    ref, ref_pad = jie.window_partition(jnp.asarray(x), 3)
    assert pad_hw == ref_pad == (9, 9)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    back = tie.window_unpartition(ours, 3, pad_hw, (8, 7))
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("q_size,k_size,table", [(8, 8, 15), (3, 3, 5),
                                                 (5, 5, 15), (7, 7, 9)])
def test_get_rel_pos_matches_jax(q_size, k_size, table):
    rel = np.random.default_rng(1).standard_normal((table, 16)).astype(
        np.float32)
    ours = tie.get_rel_pos(q_size, k_size, torch.from_numpy(rel)).numpy()
    ref = np.asarray(jie.get_rel_pos(q_size, k_size, jnp.asarray(rel)))
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("neck", [False, True])
def test_image_encoder_matches_jax(neck):
    x = np.random.default_rng(2).standard_normal((2, 128, 128, 3)).astype(
        np.float32)
    jm = jie.ImageEncoderViT(use_rel_pos=True, project_last_hidden=neck,
                             **TOY_VIT)
    params = nonzero_rel_pos(jax_init(jm, jnp.asarray(x)))
    ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))

    tm = tie.ImageEncoderViT(project_last_hidden=neck, **TOY_VIT)
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        ours = tm(torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape == ((2, 8, 8, 32) if neck
                                       else (2, 8, 8, 128))
    np.testing.assert_allclose(ours, ref, rtol=1e-3, atol=5e-4)


def test_golden_sam_vit_replay():
    """The original PyTorch SAM encoder's committed outputs (tests/golden.py
    ``sam_vit``: reference-layout weights from a seed) through the port."""
    case = CASES["sam_vit"]
    shapes, outputs = load_fixture("sam_vit")
    weights = make_weights(case, shapes)
    tm = tie.ImageEncoderViT(img_size=64, patch_size=16, embed_dim=32,
                             depth=2, num_heads=2, out_chans=16,
                             window_size=2, global_attn_indexes=(1,))
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()},
                       strict=True)
    x = case._inputs().transpose(0, 2, 3, 1)
    with torch.no_grad():
        y = tm(torch.from_numpy(np.ascontiguousarray(x))).numpy()
    case.compare({"y": y.transpose(0, 3, 1, 2)}, outputs)


def test_vit_b_layout_matches_jax():
    """ViT-B at 1024 px, the slice's encoder: built on the meta device and
    traced abstractly on the JAX side (no memory, no compute)."""
    from labelanything_tpu.models.build_encoder import build_vit_b as j_vit_b

    with torch.device("meta"):
        vit = build_vit_b(project_last_hidden=False)
    shapes = jax.eval_shape(j_vit_b(project_last_hidden=False).init,
                            jax.random.key(0),
                            jax.ShapeDtypeStruct((1, 1024, 1024, 3),
                                                 jnp.float32))
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    assert vit.pos_embed.shape == (1, 64, 64, 768)
    windowed = [b.window_size for b in vit.blocks]
    assert windowed == [14, 14, 0, 14, 14, 0, 14, 14, 0, 14, 14, 0]
    assert vit.blocks[2].attn.rel_pos_h.shape == (127, 64)
    assert vit.blocks[0].attn.rel_pos_h.shape == (27, 64)
    assert vit.neck is None
    assert sum(p.numel() for p in vit.parameters()) == n_jax
