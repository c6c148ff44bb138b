"""The harness finds every cell, configuration and metric by name, picks up
a new workload file with no edit, keeps its bound arithmetic equal to
chip_smoke.py's, and loads nothing of JAX or the JAX package."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys

import numpy as np
import pytest

from benchmark import run as R
from benchmark.counts import bounds
from benchmark.tests.tiny import SEED, run_tiny

BENCH = R.load_json(R.ROOT / "BENCHMARK.json")
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(name):
    cell, cfg = R.load_cell(name)
    entry = {w["name"]: w for w in BENCH["workloads"]}[name]
    assert cfg["name"] == entry["config"] == cell["config"]
    assert cell["kind"] in ("loop", "evidence")
    files = {c["name"]: c["file"] for c in BENCH["configs"]}
    assert (R.ROOT / files[cfg["name"]]).exists()


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_driver_and_toy_found_by_name(name):
    from benchmark.drivers.common import make_toy

    cell, cfg = R.load_cell(name)
    driver = R.load_driver(cell["kind"])
    assert callable(driver.run) and callable(driver.judge)
    loglike, bounds, names, logz_true, draws = make_toy(cfg["likelihood"])
    assert bounds.shape == (2, int(cfg["likelihood"]["d"])) == (2, len(names))
    assert np.isfinite(logz_true)


def _slice(kinds, shapes):
    return {"kind": "loop", "slice": {"gram": [(k, 1e-4) for k in kinds],
                                      "shapes": shapes}}


def test_roofline_names_what_binds():
    from benchmark.metrics._device import roofline

    run = _slice(["forward"] * 2, [("forward", 1152, 30, 4, False)] * 2)
    r = roofline(run, "forward")
    assert r["launches"] == 2 and r["bound_by"] == "bytes"
    assert r["bound_s"] == 2e-3 * bounds.bound_ms("forward", 1152, 30, 4)[0]
    assert roofline(run, "backward") is None


def test_roofline_refuses_unpaired_launches():
    from benchmark.metrics._device import roofline

    run = _slice(["forward"] * 2, [("forward", 1152, 30, 4, False)])
    with pytest.raises(RuntimeError):
        roofline(run, "forward")


def test_loop_host_time_leaves_out_the_harness():
    run = {"kind": "loop", "window_s": 10.0, "iterations": 5,
           "harness_s": 0.5, "ledger": {"GP Training": 2.0,
                                        "MCMC Sampling (overlapped)": 3.0}}
    assert R.load_reader("loop_host_s.loop")(run) == pytest.approx(1.5)


@pytest.mark.parametrize("name", METRICS)
def test_metric_reader_found_by_name(name):
    read = R.load_reader(name)
    if name == "setup_s":
        assert read({"setup_s": 1.5}) == 1.5
    else:
        # a reader that finds nothing to read returns nothing
        assert read({"kind": "none"}) is None


def test_new_workload_file_is_picked_up(tmp_path):
    """A cell added as data alone (a workload file and its BENCHMARK.json
    entry) runs, with every metric that names it, and nothing edited."""
    for sub in ("configs", "workloads", "metrics"):
        shutil.copytree(R.HERE / sub, tmp_path / sub)
    shutil.copy(tmp_path / "workloads" / "planck6.evidence.json",
                tmp_path / "workloads" / "planck6.evidence_new.json")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "planck6.evidence_new",
                               "config": "planck6", "traffic": "new",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "planck6.evidence" in m.get("workloads", []):
            m["workloads"].append("planck6.evidence_new")
    out = run_tiny("planck6.evidence_new", root=tmp_path, bench=bench)
    assert out["correct"]
    assert set(out["metrics"]) == {"evidence_s", "setup_s"}


# PERF.md section 6's ten shapes (cap, d, lanes), the warp fit's three
SHAPES = [(cap, d, lanes) for cap, d in ((128, 8), (1024, 8), (1280, 8),
                                          (2048, 8), (1280, 30))
          for lanes in (1, 4)]
WARP = [(256, 6, 8), (384, 6, 8), (1280, 30, 4)]


@pytest.mark.parametrize("kind", ["forward", "backward"])
@pytest.mark.parametrize("shape", SHAPES)
def test_bounds_equal_chip_smoke(kind, shape):
    import chip_smoke

    assert bounds.bound_ms(kind, *shape) == chip_smoke.bound_ms(kind, *shape)


@pytest.mark.parametrize("kind", ["forward", "backward_x"])
@pytest.mark.parametrize("shape", WARP)
def test_warp_bounds_equal_chip_smoke(kind, shape):
    import chip_smoke

    assert bounds.bound_ms(kind, *shape, per_lane=True) == \
        chip_smoke.bound_ms(kind, *shape, per_lane=True)


def _modules_after(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=R.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax_module():
    """Top-level names compared whole: bobe_tpu_torch is not bobe_tpu."""
    mods = _modules_after(
        "import json, sys\n"
        "from benchmark.tests.tiny import run_tiny\n"
        f"run_tiny('planck6.evidence', trace=1, seed={SEED})\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "bobe_tpu_torch" in mods
    assert not set(mods) & R.FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    mods = _modules_after(
        "import json, sys\n"
        "import benchmark.reference.judge, benchmark.reference.gp\n"
        "import benchmark.toys.gaussian, benchmark.toys.planck_like\n"
        "import benchmark.counts.bounds\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not set(mods) & (R.FORBIDDEN | {"bobe_tpu_torch"})
