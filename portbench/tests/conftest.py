"""Tests of the benchmark harness. Run from the repository root:

    python -m pytest portbench/tests -q -p no:cacheprovider

Tests marked ``cuda`` need the card and skip without one.
"""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (BENCH, os.path.dirname(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def cuda_device():
    """The card; skips the test where there is none (decided here, not at
    import, so every worker collects the same tests)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
