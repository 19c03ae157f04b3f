"""The baselines' resizes (``labelanything_tpu_torch/ops/resize.py``)
against the JAX package's on odd sizes, on the CPU: bilinear with aligned
corners, torch's floor-rule nearest, ``jax.image.resize``'s half-pixel
nearest as XLA computes it (which neither torch mode nor the exact
integer rule is) and adaptive average pooling."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from labelanything_tpu.ops import resize as jresize
from labelanything_tpu_torch.ops import resize as tresize

SIZES = [(65, 9), (60, 473), (60, 237), (417, 53), (9, 65), (256, 53),
         (473, 60)]


def _image(n_in: int, channels: int = 3) -> np.ndarray:
    rng = np.random.default_rng(n_in)
    return rng.standard_normal((2, channels, n_in, n_in - 2)).astype(
        np.float32)


@pytest.mark.parametrize("n_in,n_out", SIZES)
def test_bilinear_align_corners_matches_jax(n_in, n_out):
    x = _image(n_in)
    ref = np.asarray(jresize.resize_bilinear_ac(
        jnp.asarray(x.transpose(0, 2, 3, 1)), (n_out, n_out + 3)))
    got = tresize.resize_bilinear_ac(torch.from_numpy(x), (n_out, n_out + 3))
    # the source positions round apart in the last float bits
    np.testing.assert_allclose(got.numpy(), ref.transpose(0, 3, 1, 2),
                               rtol=1e-4, atol=1e-4)
    # (..., H, W) of any rank
    got3 = tresize.resize_bilinear_ac(torch.from_numpy(x[0]),
                                      (n_out, n_out + 3))
    np.testing.assert_array_equal(got3.numpy(), got[0].numpy())


@pytest.mark.parametrize("n_in,n_out", SIZES)
def test_nearest_rules_match_jax(n_in, n_out):
    x = _image(n_in, 1)[:, 0]
    size = (n_out, n_out + 3)
    ref_torch = np.asarray(jresize.resize_nearest_torch(jnp.asarray(x), size))
    got_torch = tresize.resize_nearest_torch(torch.from_numpy(x), size)
    np.testing.assert_array_equal(got_torch.numpy(), ref_torch)
    ref = np.asarray(jresize.resize_nearest(jnp.asarray(x), size))
    got = tresize.resize_nearest(torch.from_numpy(x), size)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("n_in,n_out,rule", [(60, 237, "nearest-exact"),
                                             (60, 473, "exact")])
def test_other_nearest_rules_are_not_jax(n_in, n_out, rule):
    """From 60 rows to 237 ``F.interpolate``'s "nearest-exact" parts from
    ``jax.image.resize`` compiled by XLA at three rows, and from 60 to 473
    the exact rule ``floor((2 dst + 1) in / (2 out))`` at one;
    ``resize_nearest`` follows XLA."""
    x = np.arange(n_in, dtype=np.float32)[None, :, None].repeat(2, 2)
    ref = np.asarray(jresize.resize_nearest(jnp.asarray(x), (n_out, 2)))
    got = tresize.resize_nearest(torch.from_numpy(x), (n_out, 2)).numpy()
    np.testing.assert_array_equal(got, ref)
    if rule == "nearest-exact":
        other = F.interpolate(torch.from_numpy(x)[None], size=(n_out, 2),
                              mode="nearest-exact")[0].numpy()
    else:
        other = ((2 * np.arange(n_out) + 1) * n_in // (2 * n_out)).astype(
            np.float32)[None, :, None].repeat(2, 2)
    parted = (other != ref).any(axis=(0, 2)).sum()
    assert parted == (3 if rule == "nearest-exact" else 1)


@pytest.mark.parametrize("n_in,bins", [(60, 6), (65, 3), (9, 6), (53, 2),
                                       (7, 1)])
def test_adaptive_avg_pool_matches_jax(n_in, bins):
    x = _image(n_in)
    ref = np.asarray(jresize.adaptive_avg_pool(jnp.asarray(x),
                                               (bins, bins + 1)))
    got = tresize.adaptive_avg_pool(torch.from_numpy(x), (bins, bins + 1))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
