"""The benchmark's tests: on the CPU at tiny sizes; tests marked `cuda`
need the card and skip without one (decided inside the fixture)."""
import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible")
    return "cuda"
