"""One torch CPU thread for the benchmark's tests: the suite runs several
pytest workers on the host's cores, and torch's thread pool in each
would oversubscribe them."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
