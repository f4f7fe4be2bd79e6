"""The benchmark's own tests (python -m pytest portbench/tests from the
root of the repo). Tests that need the CUDA card carry the `card` marker
and take the `card` fixture, which decides at run time."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs the CUDA card; skips where there is none")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    return torch.device("cuda", 0)
