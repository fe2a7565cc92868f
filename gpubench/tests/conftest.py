"""The benchmark's own tests (run as ``python -m pytest gpubench/tests``):
the plain reference against the port at toy sizes on the CPU, discovery by
name, the run's guards, and the planted faults that ``correct`` must catch.
Tests marked ``card`` need a CUDA card and skip without one; whether a card
is there is decided in a fixture, never while a module is imported."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
