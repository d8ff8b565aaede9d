"""The benchmark's own tests (CPU; those marked `cuda` need the card and
skip without one). Run from the repository's root:

    python -m pytest silt_bench/tests -q
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card and nvcc; skips without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)
