"""Shared set-up of the benchmark's tests: the checkout's root and ``src``
on the path, and the ``cuda`` fixture that skips a ``chip`` test where
torch sees no CUDA device."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is false")
    return "cuda"
