"""The benchmark's own tests: ``python -m pytest -q bench/tests`` from the
root of the repository (card-only tests carry the ``cuda`` marker and skip
themselves where torch sees no card)."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for path in (BENCH, ROOT / "src"):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))


@pytest.fixture
def card():
    """Skip unless torch sees a CUDA device (decided inside the test)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
