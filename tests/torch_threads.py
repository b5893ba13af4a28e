"""One torch thread for the port's parity tests.

The suite runs in several xdist workers on the machine's cores; torch's
intra-op thread pool in each of them would oversubscribe the cores, and
the port's many small CPU ops then wait on one another's threads.  A test
file imports ``one_torch_thread`` to run its module on one thread."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
