"""Shared set-up of the benchmark's own tests (``python -m pytest
perfbench/tests -q``): the harness's modules import as the benchmark's
command imports them, and tests marked ``cuda`` skip without a card."""

import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
for p in (str(ROOT), str(BENCH_DIR)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    """The card, or a skip: decided when the test runs, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return "cuda"
