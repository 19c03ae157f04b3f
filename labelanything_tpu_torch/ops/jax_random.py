"""``jax.random.categorical`` of the default threefry key, reproduced bit
for bit without JAX, for FPTrans's seed point (``models/fptrans.py``).

JAX (0.9, ``jax_threefry_partitionable`` on) draws 32 random bits for
element ``i`` of a shape as the XOR of the two words of
threefry2x32(key, (hi(i), lo(i))), the 64-bit flat index split in two;
``uniform`` keeps the top 23 bits as a float in [1, 2), subtracts 1 and
clamps at the smallest normal float; ``gumbel`` is -log(-log(u)) and
``categorical`` the argmax of logits plus Gumbel noise along the last axis.
The noise depends only on the key and the shape, so it is made once per
shape on the host and the argmax runs where the logits are.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: Tuple[int, int], x0: np.ndarray, x1: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 with 20 rounds (JAX ``prng.threefry2x32``) of uint32
    counter pairs under ``key`` (two uint32 words)."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0, x1 = x0.astype(np.uint32) + ks[0], x1.astype(np.uint32) + ks[1]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def key_of_seed(seed: int) -> Tuple[int, int]:
    """The raw key of ``jax.random.key(seed)``: the seed's high and low 32
    bits."""
    return (seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF


def random_bits(key: Tuple[int, int], shape: Tuple[int, ...]) -> np.ndarray:
    """``jax.random.bits(key, shape)`` as uint32 (partitionable threefry)."""
    n = int(np.prod(shape))
    index = np.arange(n, dtype=np.uint64)
    hi = (index >> np.uint64(32)).astype(np.uint32)
    lo = (index & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b0, b1 = threefry2x32(key, hi, lo)
    return (b0 ^ b1).reshape(shape)


def gumbel(key: Tuple[int, int], shape: Tuple[int, ...]) -> np.ndarray:
    """``jax.random.gumbel(key, shape)`` in float32 (mode "low")."""
    tiny = np.finfo(np.float32).tiny
    bits = (random_bits(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    u = np.maximum(np.float32(tiny),
                   floats * np.float32(1.0 - tiny) + np.float32(tiny))
    return -np.log(-np.log(u))


@functools.lru_cache(maxsize=16)
def _gumbel_on(seed: int, shape: Tuple[int, ...], device: torch.device
               ) -> torch.Tensor:
    return torch.as_tensor(gumbel(key_of_seed(seed), shape), device=device)


def categorical_valid(seed: int, valid: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(jax.random.key(seed), where(valid, 0,
    -inf))`` over the last axis of a (rows, n) boolean: the index of the
    largest noise among a row's valid elements, 0 for a row with none."""
    noise = _gumbel_on(seed, tuple(valid.shape), valid.device)
    return noise.masked_fill(~valid, float("-inf")).argmax(dim=-1)
