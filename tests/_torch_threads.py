"""One torch thread for the port's CPU tests.

The suite runs several pytest workers on the machine's cores. With
torch's default of one thread per core in every worker the cores are
oversubscribed, and the plain kernel versions' many small operations
then stall on their threads' barriers (a 2,000-point f64 brute-force run
took 20× longer). A test module imports the fixture to run on one
thread::

    from _torch_threads import one_torch_thread  # noqa: F401

One thread also makes the CPU results independent of the machine's core
count (a reduction's order follows the thread count).
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Yields torch's thread count from before the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield n
    torch.set_num_threads(n)
