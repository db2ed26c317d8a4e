"""One intra-op torch thread for a test file of the port's CPU parity tests.

A file pulls the fixture in with ``from torch_threads import one_thread``.
The reduced models and small fits run tiny ops: under the suite's xdist
workers, torch's default intra-op threads only contend with the other
workers (a step took 30–60× longer with them, and the L-BFGS parity fit
2.4× longer on idle CPUs)."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
