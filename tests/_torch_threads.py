"""One torch CPU thread for a port test file's tests.

The suite runs several pytest workers on the host's cores, and torch's
thread pool in each would oversubscribe them (tiny ops then wait on the
scheduler). A heavy ``test_torch_*.py`` file imports the fixture::

    from _torch_threads import one_cpu_thread  # noqa: F401 (autouse)

and every test of that file then runs on one thread.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
