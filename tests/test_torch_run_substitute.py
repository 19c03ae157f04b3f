"""The port's ``Run`` against the JAX package's with substitution on (at lr
1e-6 and ``num_points: 0``; see ``tests/test_torch_run.py``, which holds
the comparison and the case without substitution). A file of its own, so
that the two JAX runs can go to two test workers."""

import pytest

from tests.test_torch_run import check_run_matches_jax, coco_root  # noqa: F401


@pytest.mark.parametrize("substitute", [True])
def test_run_matches_jax(coco_root, tmp_path, monkeypatch, substitute):
    check_run_matches_jax(coco_root, tmp_path, monkeypatch, substitute)
