"""pytest settings of the benchmark's own tests (``python -m pytest
benchmark/tests -q`` from the repository's root; the repository's
``pytest tests/`` does not collect them).

``@pytest.mark.card`` marks a test that needs a CUDA card; its ``card``
fixture skips it, with the reason, where there is none. The decision is
taken when the test runs, never while a module is imported."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the chip")
    return torch.device("cuda")
