"""One intra-op thread for the port's CPU tests.

The suite runs under pytest-xdist, several workers to a machine. Each
worker's torch would otherwise start an OpenMP team as wide as the
machine, and the port's CPU tests run many small operations: with more
threads than cores every parallel region waits at its barrier for
threads the scheduler has put aside, and a file that takes half a
minute alone takes tens of minutes beside five others. One thread per
worker keeps the workers within the cores.

Each ``tests/test_torch_*.py`` imports ``one_torch_thread`` into its
namespace, which makes it an autouse fixture of that module; the
worker's thread count comes back when the module is done.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
