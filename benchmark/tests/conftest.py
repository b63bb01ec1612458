"""The benchmark's own CPU tests: ``python -m pytest benchmark/tests -q``
from the root of the repo. Tests marked ``cuda`` need the card and skip
elsewhere; each decides inside a fixture."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the control runs at the cell's "
                    "size on the card)")
    return torch.device("cuda", 0)
