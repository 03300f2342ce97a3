"""Pytest settings of the benchmark's own tests (``benchmark/tests``).

Run them from the repository root: ``python -m pytest benchmark/tests
-q`` on the CPU; on a card, ``python -m pytest benchmark/tests -m cuda
-q`` runs the ones marked ``cuda``. Whether a card is there is decided
in the ``cuda_device`` fixture, never while a module is imported.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
