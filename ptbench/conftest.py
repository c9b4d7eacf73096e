"""pytest settings of the benchmark's own tests (ptbench/tests/).

    python -m pytest ptbench/tests -q                 # CPU, ~3 minutes
    python -m pytest ptbench/tests -q -m card          # on the card

Tests marked `card` need a CUDA device; the `card` fixture decides that
when the test runs and skips it elsewhere.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
