"""One torch thread for the port's tests on the CPU.

The test suite runs under pytest-xdist, several worker processes sharing
the host's cores. torch's intra-op pool holds a thread a core in every
worker, and each parallel op waits at its barrier for threads that the
scheduler has parked while the other workers run: a small CPU test then
takes several times as long as alone. The port's test modules import this
autouse fixture, which runs each module on one torch thread and restores
the count afterwards. What the tests compare, and to what tolerance, does
not change. Two modules keep torch's default count:
``tests/test_torch_resize.py`` and ``tests/test_torch_train_embeddings.py``
hold the resizes bit for bit across ranks and a step's gradients at their
rounding noise, and the thread count moves both (on one thread the rank-3
and rank-4 resizes part in the last bit).
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
