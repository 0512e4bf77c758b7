import os
import sys

# Tests see the default single CPU device; ONLY the dry-run forces 512.
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (the port's kernels); skipped without one"
    )
