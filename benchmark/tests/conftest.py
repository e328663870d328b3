"""The benchmark's own tests: CPU unless marked `card`.

A `card` test decides in its fixture whether this host has a CUDA card
and skips without one, never while the module is imported.
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this host")
    return torch.cuda.get_device_name(0)
