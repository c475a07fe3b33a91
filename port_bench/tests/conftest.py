"""The benchmark's CPU tests, and its card tests (marker `gpu`, skipped
without a CUDA card): `python -m pytest port_bench/tests -q` from the
root of the repository; on the card the same command runs them all."""
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible")
    return torch.device("cuda:0")
