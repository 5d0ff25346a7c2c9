"""Shared pieces of the benchmark's own tests (``python -m pytest
mfbench/tests``).  They run on the CPU at a narrow size; the tests marked
``cuda`` need the card and skip here."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the narrow size the CPU tests drive a cell at
SMALL = {"batch": 2, "height": 96, "width": 320, "pool": 2, "check_calls": 2, "frames": 6,
         "frame_size": [310, 94], "trace_seconds": 0.5}


@pytest.fixture
def card():
    """Skips the test without a CUDA card (decided here, at run time)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
