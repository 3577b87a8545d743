"""One intra-op thread for the port's CPU tests.

Usage in a ``tests/test_torch_*.py`` file:
``from _torch_threads import one_torch_thread  # noqa: F401``.

The suite runs under ``pytest -n 6``: six workers, each of whose torch
would start an OpenMP team as wide as the machine.  The teams spin for
the same cores, and the port's many small tensor ops run tens to hundreds
of times slower than alone (a reduced model's train step: 0.3 s alone,
up to 92 s in the suite).  The fixture holds torch to one thread for a
module and gives the old count back after it.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
