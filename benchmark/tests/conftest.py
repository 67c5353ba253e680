"""The benchmark's own tests: `python -m pytest benchmark/tests -q` from
the root of the repository.  Tests marked `gpu` run the cells on a card
and skip elsewhere."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU and nvcc; skipped elsewhere")


@pytest.fixture
def card():
    """Skips the test where there is no CUDA device (decided here, not
    while the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
