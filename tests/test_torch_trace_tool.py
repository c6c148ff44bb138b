"""tools/torch_port_trace.py on the benchmark's cells cut to a CPU test's
size (benchmark/tests/tiny.py): with the port's tracer on, every reading of
the cell's kind returns a number (the idle share over a slice in which, on
the CPU, no device operation runs), and a run without the program's trace
returns none."""
import sys
from pathlib import Path

import pytest
import torch

from benchmark.tests.tiny import SEED, tiny

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import torch_port_trace as tool  # noqa: E402

READINGS = {
    "planck6.loop": {"iter_self_s.loop", "mc_refresh_s.loop",
                     "mc_wasted_share.loop", "acq_refine_s.loop",
                     "fit_evals.loop", "idle_named.loop"},
    "planck6.evidence": {"ns_inner_self_ms.evidence",
                         "ns_outside_inner_share.evidence",
                         "idle_named.evidence"},
}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("name", sorted(READINGS))
def test_every_reading_of_a_traced_tiny_run(name, monkeypatch):
    from benchmark.drivers import common

    cell, cfg = tiny(name)
    kept = {}
    result = tool.readings

    def keep(run):
        kept["run"] = dict(run)
        return result(run)

    monkeypatch.setattr(tool, "readings", keep)
    out, got = tool.run_traced(name, SEED, 0.0, 1, "cpu", cell=cell,
                               cfg=cfg)
    assert out["correct"], out["checks"]
    assert set(got) == READINGS[name]
    for key, (value, detail) in got.items():
        assert isinstance(value, float) and value == value, key
        assert isinstance(detail, dict), key
    assert common.profile_slice.__module__ == "benchmark.drivers.common"
    run = kept["run"]
    if name == "planck6.evidence":
        d = got["ns_outside_inner_share.evidence"][1]
        assert d["outside_parts_share"] < 1.0 and d["draws_per_live"] >= 1
    run.pop("program_trace")
    assert tool.readings(run) == {}
