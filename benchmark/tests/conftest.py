"""The benchmark's CPU tests: ``python -m pytest benchmark/tests -q`` from
the root of the repository.  Tests marked ``cuda`` skip without a card."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def tiny(cell, horizon=8, lanes=4, **traffic):
    """The cell's spec at a small horizon and lane count, for the CPU."""
    import harness

    spec = harness.load_cell(cell)
    spec["config"] = dict(spec["config"], horizon=horizon)
    traffic = dict(dict(lanes=lanes, pool=3, warm=1), **traffic)
    spec["traffic"] = dict(spec["traffic"], **traffic)
    return spec
