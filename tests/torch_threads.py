"""One torch thread for each test of a file that uses it:

    from torch_threads import single_thread  # noqa: F401
    pytestmark = pytest.mark.usefixtures("single_thread")

The suite runs six worker processes on the host's cores, and torch in
each worker would otherwise start a thread per core: the workers then
oversubscribe the cores many times over. Six runs of one DeepLab trainer
test at once took 509 s at 8 threads each and 29 s at one thread on an
8-core host. The tests' shapes are small, so one thread loses little when
a test runs alone."""

import pytest
import torch


@pytest.fixture
def single_thread():
    """torch on one thread for the test (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
