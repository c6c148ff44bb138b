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
        # on the CPU every inner iteration runs eagerly: no graph, no capture
        d = got["ns_inner_self_ms.evidence"][1]
        assert d["inner"] > 0 and d["graph_share"] == 0.0
        assert d["captures_per_evidence"] == 0 and d["capture_s"] == 0
    run.pop("program_trace")
    assert tool.readings(run) == {}


def test_graph_readings_of_evidence_spans():
    """The evidence detail's graph readings on spans laid out by hand: the
    share of ``ns.inner`` spans counted as graph replays, the captures
    counted on ``ns.run`` per evidence and the seconds of ``ns.capture``."""
    from bobe_tpu_torch.utils.trace import SpanRecord

    ms = 1_000_000

    def rec(i, name, parent, t0, t1, counts=None):
        return SpanRecord(i, name, parent, "MainThread", "evidence 1", t0,
                          t1, counts)

    spans = [rec(1, "ns.evidence", None, 0, 100 * ms),
             rec(2, "ns.run", 1, 1 * ms, 90 * ms, {"captures": 1}),
             rec(3, "ns.outer", 2, 2 * ms, 80 * ms),
             rec(4, "ns.inner", 3, 2 * ms, 3 * ms),
             rec(5, "ns.capture", 6, 3 * ms, 7 * ms),
             rec(6, "ns.inner", 3, 3 * ms, 8 * ms, {"graph": 1})]
    spans += [rec(7 + i, "ns.inner", 3, (8 + i) * ms, (9 + i) * ms,
                  {"graph": 1}) for i in range(2)]
    run = {"kind": "evidence", "program_window_ns": (0, 200 * ms),
           "program_trace": {"spans": spans, "dropped": 0, "cap": 100}}
    value, detail = tool.readings(run)["ns_inner_self_ms.evidence"]
    assert value == 8.0 / 4
    assert detail["graph_share"] == 75.0
    assert detail["captures_per_evidence"] == 1.0
    assert detail["capture_s"] == 0.004
