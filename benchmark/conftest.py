"""Test settings of the benchmark: the ``card`` marker, for tests that
need a CUDA card; the ``card`` fixture skips them without one (decided
when the test runs, never at import)."""
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
