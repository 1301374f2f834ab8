"""The benchmark's own tests: ``python -m pytest gpubench/tests -q`` from
the root of the repository. Tests marked ``card`` need a CUDA device and
skip without one (the check is made in the ``card`` fixture, never at
import)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
