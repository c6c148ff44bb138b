"""A cell's whole run on the card, at the CPU tests' sizes: the harness
drives the CUDA path, reads a device trace and judges the run. Marked
``cuda``; it skips without a card:

    python -m pytest -m cuda benchmark/tests/test_bench_card.py
"""
from __future__ import annotations

import pytest
import torch

from benchmark import run as R
from benchmark.tests.tiny import SEED, tiny


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the benchmark measures the card)")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["planck6.evidence", "gauss30.loop",
                                  "planck6.loop"])
def test_traced_run_on_the_card(cuda, name):
    cell, cfg = tiny(name)
    out = R.run_cell(name, SEED, 0.0, 1, cuda, cell=cell, cfg=cfg)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
