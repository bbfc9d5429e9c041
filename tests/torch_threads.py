"""One PyTorch intra-op thread for the port's heavy CPU tests.

The tier-1 command runs six pytest-xdist workers, each a process of its own,
and PyTorch sizes its intra-op thread pool to every core of the machine: six
processes of many small operations (scipy loops over the loss, the Hessian's
double backward) then oversubscribe the cores, and their threads wait on one
another.  Such a file took ten times as long beside five others as alone; with
one thread it runs at its own pace.  A module that imports ``one_torch_thread``
gets it for all its tests, and the previous count back after them.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
