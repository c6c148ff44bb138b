"""The benchmark of bobe_tpu_torch on one NVIDIA card.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything is found by name: the cell's traffic in
``benchmark/workloads/<cell>.json`` (its ``config``, its ``kind``, its
sizes and the limits of its checks), the driver of its kind in
``benchmark/drivers/<kind>.py`` (a ``run`` and a ``judge``), the
configuration in ``benchmark/configs/<config>.json``, its likelihood in
``benchmark/toys/<toy>.py``, and each metric that BENCHMARK.json lists for
the cell in ``benchmark/metrics/<metric>.py`` (a ``read(run)`` that returns
a number, or None where it finds nothing to read, and optionally a
``detail(run)`` whose dict the line carries under ``details``). With
``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, from a run with a profiled slice.

The run prints, as the last line of its standard output, one JSON object:
correct, metrics, device, attempted, failed, set-up's parts, each unit's
seconds, the harness's own seconds inside the window, (traced) breakdown
and details, and last the numbers compared with their limits; the same
numbers end its standard error. It exits non-zero with no result line
without a CUDA card, or where JAX or the JAX package was loaded.

``--control 1`` is the calibration of the checks, never part of a timed
run: for each seed of a comma-separated ``--seed`` it runs set-up and a
window, then prints one JSON line with the program's numbers, those of the
control (the float32 reference in the program's place) and those of the
witness (the float64 reference with its rows reversed, in the program's
place: the roundoff of the state's conditioning).
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "bobe_tpu"}


def _caches():
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = ROOT / "build" / "benchmark_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_cell(name, root=HERE):
    cell = load_json(root / "workloads" / f"{name}.json")
    cfg = load_json(root / "configs" / f"{cell['config']}.json")
    return cell, cfg


def load_metric(name, root=HERE):
    """The module ``metrics/<name>.py`` (its ``read``, maybe ``detail``)."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "__"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(name, root=HERE):
    """The ``read`` of ``metrics/<name>.py``."""
    return load_metric(name, root).read


def load_driver(kind):
    """The driver of a cell's kind: ``drivers/<kind>.py``."""
    return importlib.import_module(f"{__package__ or 'benchmark'}.drivers."
                                   f"{kind}")


def metrics_for(bench, cell_name, trace):
    """BENCHMARK.json's metrics of this cell: end-to-end without tracing,
    per-layer with it; a metric without ``workloads`` is every cell's."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if cell_name in m.get("workloads", [cell_name])]


def drive(cell, cfg, seed, seconds, trace, device):
    """The run of one cell: the driver of its kind."""
    return load_driver(cell["kind"]).run(cfg, cell, seed, seconds, trace,
                                         device)


def judge(run, cell, cfg, device, stand_in=None):
    """The cell's numbers; with ``stand_in`` ("control", "witness") those
    of a reference in the program's place (reference/judge.py)."""
    return load_driver(cell["kind"]).judge(run, cell, cfg, device, stand_in)


def checks(numbers, limits):
    """{name: {"value", "limit"}} and whether every number is within its
    limit (a number without a limit, or NaN, fails)."""
    out, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name)
        out[name] = {"value": value, "limit": limit}
        ok = ok and limit is not None and value <= limit
    return out, ok


def free(run):
    """Drop the program's state before the reference runs."""
    import torch

    run.pop("bobe", None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def result(run, cell_name, cell, cfg, bench, trace, device, root=HERE):
    """The result line's object (the timed numbers, then the check)."""
    import torch

    run["setup_s"] = run["setup_end"] - T_START
    metrics, details = {}, {}
    for m in metrics_for(bench, cell_name, trace):
        mod = load_metric(m["name"], root)
        value = mod.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            if hasattr(mod, "detail"):
                details[m["name"]] = mod.detail(run)
    dev = torch.device(device)
    if dev.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    t_state, t_built = run["setup_marks"]
    out = {"metrics": metrics, "device": info,
           "attempted": run["attempted"], "failed": run["failed"],
           # set-up's parts: imports; the state (CUDA, the kernel library,
           # the rows, the constructor's fit and gate); the warm-up
           "setup_split": {"imports_s": t_state - T_START,
                           "state_s": t_built - t_state,
                           "warmup_s": run["setup_end"] - t_built},
           # each episode's or evidence's seconds, in the window's order
           "unit_s": run["unit_s"]}
    if "harness_s" in run:
        # the harness's restores and records inside the window
        out["harness_s"] = run["harness_s"]
    s = run.get("slice")
    if trace and s is not None:
        info["busy_s"] = s.get("busy_s", 0.0)
        info["window_s"] = s["wall_s"]
        out["breakdown"] = {
            "device_ops": [[n[:120], t] for n, t in s.get("device_ops", [])],
            "idle_gaps": s.get("idle_gaps", [])}
        if details:
            details["power_limit_w"] = power_limit_w()
            out["details"] = details
    free(run)
    numbers = judge(run, cell, cfg, device)
    out["checks"], ok = checks(numbers, cell["limits"])
    out["correct"] = bool(ok and run["failed"] == 0)
    return out


def power_limit_w():
    """The card's power limit in watts, as nvidia-smi reads it (None where
    it cannot): a roofline's peaks hold at the card's full limit."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run_cell(cell_name, seed, seconds, trace, device, bench=None,
             cell=None, cfg=None, root=HERE):
    """A whole run, as the command line makes it; returns the result
    object. ``cell``/``cfg`` override the files, ``root`` the folder they
    and the metrics' readers are found in (the harness's tests)."""
    if cell is None:
        cell, cfg = load_cell(cell_name, root)
    if bench is None:
        bench = load_json(ROOT / "BENCHMARK.json")
    run = drive(cell, cfg, seed, seconds, trace, device)
    return result(run, cell_name, cell, cfg, bench, trace, device, root)


def calibrate(cell_name, seeds, seconds, device, cell=None, cfg=None,
              stand_ins=("control", "witness")):
    """The program's numbers and those of each stand-in, seed by seed (one
    JSON line each, and the lines' objects returned)."""
    import torch

    if cell is None:
        cell, cfg = load_cell(cell_name)
    lines = []
    for seed in seeds:
        run = drive(cell, cfg, seed, seconds, False, device)
        free(run)
        line = {"seed": seed, "units": run["units"],
                "program": judge(run, cell, cfg, device)}
        for who in stand_ins:
            line[who] = judge(run, cell, cfg, device, who)
        if run["kind"] == "evidence":
            line["logz_minus_truth"] = [
                [r["logz"] - run["info"]["logz_true"], r["err_total"]]
                for r in run["evidences"]]
        print(json.dumps(line), flush=True)
        lines.append(line)
        del run
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return lines


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _caches()
    import torch

    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        sys.exit(f"benchmark: no cell '{args.workload}' in BENCHMARK.json")
    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        sys.exit(f"benchmark: needs {chips} CUDA card(s), found "
                 f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    if args.control:
        calibrate(args.workload, [int(s) for s in args.seed.split(",")],
                  args.seconds, "cuda")
        return
    out = run_cell(args.workload, int(args.seed), args.seconds, args.trace,
                   "cuda", bench=bench)
    bad = forbidden_modules()
    if bad:
        sys.exit("benchmark: modules of JAX or the JAX package were loaded: "
                 + ", ".join(bad))
    checks_ = out.pop("checks")
    line = {"correct": out.pop("correct"), **out, "checks": checks_}
    for name, c in checks_.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
