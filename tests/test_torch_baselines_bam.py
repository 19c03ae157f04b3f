"""BAM and HDMNet of the port against the JAX package on the CPU, as
``tests/test_torch_baselines.py`` holds the other baselines: the
registry's episode wrappers on the same seeded episodes and weights,
1-way 1-shot and 2-way 2-shot (every class's supports in one grouped
forward on the port's side, a forward a class on the JAX side), tiny
ResNets at 65 px, logits within rtol 1e-3, atol 5e-4."""

import pytest

from tests.test_torch_baselines import compare_with_jax
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("name", ["bam", "hdmnet"])
@pytest.mark.parametrize("ways,shots", [(1, 1), (2, 2)])
def test_model_matches_jax(name, ways, shots):
    compare_with_jax(name, ways, shots)
