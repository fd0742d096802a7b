"""The benchmark's own tests (run here with ``python -m pytest
benchmark/tests``).  Tests that need the card carry the ``card`` marker and
skip, with a reason, from inside the ``card`` fixture where torch sees no
CUDA device."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (the benchmark's card tests)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return torch.device("cuda")
