"""The benchmark's own tests (``python -m pytest portbench/tests``), on
the CPU; those marked ``cuda`` need a card and skip without one."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
