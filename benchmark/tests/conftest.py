"""The benchmark's own tests: run from the repository's root with
``python -m pytest benchmark/tests -q``; those marked ``cuda`` need the
card and skip without one."""

import pathlib
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
