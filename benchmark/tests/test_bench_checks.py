"""The check that decides ``correct``, at CPU size: sound runs pass it, the
control (the float32 reference in the program's place) fails it, and so
does a run whose timed path is broken underneath, once for each fault the
cell can have."""
from __future__ import annotations

import pytest

from benchmark import run as R
from benchmark.tests import faults as F
from benchmark.tests.tiny import SEED, run_tiny, tiny

CELLS = ["planck6.evidence", "gauss30.loop", "planck6.loop"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_correct_and_control_not(name):
    cell, cfg = tiny(name)
    line = R.calibrate(name, [SEED], 0.0, "cpu", cell=cell, cfg=cfg)[0]
    _, ok = R.checks(line["program"], cell["limits"])
    assert ok, line["program"]
    _, ok = R.checks(line["control"], cell["limits"])
    assert not ok, line["control"]


# ------------------------------------------------------------------ faults

CASES = [(name, fault) for name, faults in F.FAULTS.items()
         for fault in faults]


@pytest.mark.parametrize("name,fault", CASES,
                         ids=[f"{n}-{f.__name__}" for n, f in CASES])
def test_fault_makes_run_incorrect(name, fault, monkeypatch):
    fault(monkeypatch)
    out = run_tiny(name)
    assert out["correct"] is False, out["checks"]
