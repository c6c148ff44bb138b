"""A benchmark cell run with the port's tracer on, and its spans read.

    python tools/torch_port_trace.py --workload planck6.loop --seed N \
        [--seconds 51] [--trace 0|1] [--device cuda|cpu] \
        [--chrome trace.json] [--ab 1|2]

Runs the cell as ``python -m benchmark.run`` does (the cell's driver, state,
window and, with ``--trace 1``, its profiled slice), with the tracer of
bobe_tpu_torch (utils/trace.py) on from set-up to the end of the slice.
Prints one JSON line: the benchmark's own result object (its metrics, checks,
breakdown) and, under ``program``, the readings of the program's spans over
the window (and the slice) with their details:

- ``iter_self_s.loop``: ``bo.iteration`` self time per iteration, less the
  harness's seconds per iteration (the program's ``loop_host_s.loop``);
- ``mc_refresh_s.loop``: ``mc.refresh`` seconds per iteration;
- ``mc_wasted_share.loop``: seconds of ``mc.warm`` runs rejected after they
  ran, over ``mc.refresh`` seconds, in %;
- ``acq_refine_s.loop``: ``acq.refine`` seconds per iteration;
- ``fit_evals.loop``: objective evaluations counted on ``gp.fit`` per
  iteration;
- ``ns_inner_self_ms.evidence``: the mean ``ns.inner`` span, in ms; its
  detail gives the share of them replayed from a CUDA graph (count
  ``graph``), the graphs captured per evidence (``ns.run``'s count
  ``captures``) and the seconds of their captures (``ns.capture``);
- ``ns_outside_inner_share.evidence``: the share of ``ns.evidence`` seconds
  outside ``ns.inner``, in %;
- ``idle_named.loop`` / ``idle_named.evidence`` (``--trace 1`` on a card):
  the share of the slice's device-idle seconds that falls inside a program
  span below ``bo.iteration`` / ``ns.evidence``, the device trace placed on
  the program's clock by its origin on the Unix clock
  (``kineto_results.trace_start_ns``) and an anchor of the two clocks.

A reading returns None where the run has none to read (another kind of
cell, the tracer off, no device trace) and refuses a trace that dropped
spans.

``--ab 1`` (``2``) measures the tracer's cost instead: the tracer is on for
the window's even (odd) units, an episode or an evidence, and off for the
others, and the line's ``ab`` gives each unit's seconds and whether the
tracer was on. A unit's work depends on the seed and its index alone, so
the runs ``--ab 1`` and ``--ab 2`` of one seed pair every unit traced with
itself untraced, and their ratios cancel the two processes' host speeds.
"""
from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# ------------------------------------------------------ the program's spans

def trace_of(run, kind):
    """The program's spans of the run, or None."""
    pt = run.get("program_trace")
    if run.get("kind") != kind or not pt:
        return None
    if pt["dropped"]:
        raise RuntimeError(f"the program's trace dropped {pt['dropped']} "
                           f"spans (cap {pt['cap']})")
    return pt["spans"]


def window_spans(run, kind):
    """The spans that lie inside the window, or None."""
    spans = trace_of(run, kind)
    if spans is None:
        return None
    w0, w1 = run["program_window_ns"]
    return [s for s in spans if s.start_ns >= w0 and s.end_ns <= w1]


def seconds(span):
    return (span.end_ns - span.start_ns) * 1e-9


def total(spans, name):
    """Summed seconds of the spans of one name."""
    return sum(seconds(s) for s in spans if s.name == name)


def counted(spans, name, key):
    """Summed count ``key`` of the spans of one name."""
    return sum((s.counts or {}).get(key, 0) for s in spans if s.name == name)


def self_seconds(spans):
    """{span id: its seconds less those of its children}."""
    out = {s.id: seconds(s) for s in spans}
    for s in spans:
        if s.parent in out:
            out[s.parent] -= seconds(s)
    return out


def self_total(spans, name):
    own = self_seconds(spans)
    return sum(own[s.id] for s in spans if s.name == name)


def below(spans, root):
    """The spans under a ``root`` span: those whose parents lead to one,
    and the spans of another thread that carry a root's request id (the
    overlapped MC-pool refresh carries its iteration's)."""
    by_id = {s.id: s for s in spans}
    roots = {s.id: s for s in spans if s.name == root}
    requests = {s.request for s in roots.values()}
    threads = {s.thread for s in roots.values()}
    out = []
    for s in spans:
        if s.id in roots:
            continue
        top = s
        while top.parent is not None and top.parent not in roots:
            nxt = by_id.get(top.parent)
            if nxt is None:
                break
            top = nxt
        if top.parent in roots or (top.parent is None
                                   and top.thread not in threads
                                   and top.request in requests):
            out.append(s)
    return out


# ------------------------------------------------ the shared clock's slice

def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(first, second):
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    n = i = j = 0
    while i < len(first) and j < len(second):
        a, b = first[i]
        x, y = second[j]
        n += max(0, min(b, y) - max(a, x))
        if b < y:
            i += 1
        else:
            j += 1
    return n


def unix_to_program_ns(anchor):
    """What to add to a Unix-clock time (ns) to place it on the program's
    clock (perf_counter_ns), by an anchor of the two clocks
    (bobe_tpu_torch.utils.trace.clock_anchor)."""
    return anchor["perf_ns"] - anchor["unix_ns"]


def device_on_program_clock(s):
    """The slice's device operations as (start, end, name) on the program's
    clock: the trace's origin on the Unix clock, the anchor of the slice."""
    shift = s["trace_start_ns"] + unix_to_program_ns(s["anchor"])
    return [(shift + int(a * 1e3), shift + int(b * 1e3), name)
            for a, b, name in s["device_intervals"]]


def idle_named(run, kind, root):
    """The slice's device-idle time, and the share of it that the shared
    clock puts inside a program span below ``root``; the ten longest idle
    gaps, each named by the innermost open span and request id of each
    thread, and the device operation that ends it. None without a slice's
    device trace."""
    s = run.get("slice")
    spans = trace_of(run, kind)
    if spans is None or not s or "device_intervals" not in s:
        return None
    h0, h1 = s["host_ns"]
    ops = sorted(device_on_program_clock(s))
    busy = _merge([(max(a, h0), min(b, h1)) for a, b, _ in ops
                   if b > h0 and a < h1])
    gaps, t = [], h0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if h1 > t:
        gaps.append((t, h1))
    idle = sum(b - a for a, b in gaps)
    if idle <= 0:
        return None
    inside = [x for x in spans if x.start_ns < h1 and x.end_ns > h0]
    named = _merge([(x.start_ns, x.end_ns) for x in below(inside, root)])
    share = 100.0 * _overlap(gaps, named) / idle
    starts = [a for a, _, _ in ops]
    longest = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = (a + b) // 2
        threads = {}
        for x in sorted((x for x in inside if x.start_ns <= mid < x.end_ns),
                        key=lambda x: x.start_ns):
            threads[x.thread] = x   # the latest opened is the innermost
        i = bisect.bisect_left(starts, b)
        longest.append({
            "gap_s": (b - a) * 1e-9, "at_s": (a - h0) * 1e-9,
            "spans": {th: {"span": x.name, "request": x.request}
                      for th, x in threads.items()},
            "next_op": ops[i][2][:60] if i < len(ops) else None})
    return {"share": share, "idle_s": idle * 1e-9,
            "named_idle_s": share * idle * 1e-11, "gaps": longest,
            "anchor_width_ns": s["anchor"]["width_ns"]}


# ---------------------------------------------------------------- readings

def _loop(run):
    spans = window_spans(run, "loop")
    if spans is None:
        return {}
    n = run["iterations"]
    picks = sum(s.name == "acq.pick" for s in spans)
    evals = counted(spans, "gp.fit", "evals")
    refresh = total(spans, "mc.refresh")
    wasted = [s for s in spans if s.name == "mc.warm" and (s.counts or {})
              .get("outcome") in ("rejected_accept", "rejected_divergence")]
    outcomes = {}
    for s in spans:
        if s.name == "mc.warm":
            o = (s.counts or {}).get("outcome")
            outcomes[o] = outcomes.get(o, 0) + 1
    colds = [s for s in spans if s.name == "mc.cold"]
    return {
        "iter_self_s.loop": (
            (self_total(spans, "bo.iteration") - run["harness_s"]) / n,
            {"bo_iterations": sum(s.name == "bo.iteration" for s in spans),
             "self_s": self_total(spans, "bo.iteration"),
             "harness_s": run["harness_s"]}),
        "mc_refresh_s.loop": (
            refresh / n,
            {"refreshes": sum(s.name == "mc.refresh" for s in spans),
             "warm_s": total(spans, "mc.warm") / n,
             "cold_s": total(spans, "mc.cold") / n}),
        "mc_wasted_share.loop": (
            100.0 * sum(seconds(s) for s in wasted) / refresh
            if refresh > 0 else None,
            # the cold runs' warmup: their seconds by the warmup's share of
            # their leapfrog steps
            {"outcomes": outcomes, "cold": len(colds),
             "cold_s": sum(seconds(s) for s in colds),
             "cold_warmup_s": sum(
                 seconds(s) * s.counts.get("leapfrog_warmup", 0)
                 / max(1, s.counts.get("leapfrog", 0))
                 for s in colds if s.counts)}),
        "acq_refine_s.loop": (
            total(spans, "acq.refine") / n,
            {**{name: total(spans, name) / n for name in (
                "acq.batch", "acq.pick", "acq.mc_points", "acq.sweep",
                "acq.refine", "acq.hallucinate")},
             "refine_evals_per_pick": (
                 counted(spans, "acq.refine", "evals") / picks
                 if picks else None)}),
        "fit_evals.loop": (
            evals / n,
            {"refits": sum(s.name == "gp.fit" for s in spans),
             "restarts": counted(spans, "gp.fit", "restarts"),
             "s_per_eval": total(spans, "gp.fit") / evals if evals else None,
             "extend_s": total(spans, "gp.extend") / n,
             "clf_train_s": total(spans, "clf.train") / n}),
    }


def _evidence(run):
    spans = window_spans(run, "evidence")
    if spans is None:
        return {}
    n = sum(s.name == "ns.evidence" for s in spans)
    whole = total(spans, "ns.evidence")
    if not n or whole <= 0:
        return {}
    inner = [seconds(s) for s in spans if s.name == "ns.inner"]
    parts = sum(total(spans, name)
                for name in ("ns.seed", "ns.outer", "ns.bounds"))
    live = counted(spans, "ns.seed", "live")
    return {
        "ns_inner_self_ms.evidence": (
            1e3 * sum(inner) / len(inner) if inner else None,
            {"inner": len(inner), "inner_per_evidence": len(inner) / n,
             # inner iterations replayed from the run's CUDA graph
             "graph_share": (100.0 * counted(spans, "ns.inner", "graph")
                             / len(inner) if inner else None),
             "captures_per_evidence": counted(spans, "ns.run", "captures")
             / n,
             "capture_s": total(spans, "ns.capture") / n}),
        "ns_outside_inner_share.evidence": (
            100.0 * (1.0 - sum(inner) / whole),
            {"evidences": n, "evidence_s": whole / n,
             "seed_s": total(spans, "ns.seed") / n,
             "outer_self_s": self_total(spans, "ns.outer") / n,
             "bounds_s": total(spans, "ns.bounds") / n,
             # what ns.seed, ns.outer and ns.bounds leave of the evidence
             "outside_parts_s": (whole - parts) / n,
             "outside_parts_share": 100.0 * (1.0 - parts / whole),
             "draws_per_live": (counted(spans, "ns.seed", "draws") / live
                                if live else None)}),
    }


def readings(run):
    """{reading: (value, detail)} of the run's program trace."""
    out = {**_loop(run), **_evidence(run)}
    for kind, root in (("loop", "bo.iteration"), ("evidence", "ns.evidence")):
        r = idle_named(run, kind, root)
        if r is not None:
            out[f"idle_named.{kind}"] = (
                r["share"], {k: v for k, v in r.items() if k != "share"})
    return out


# --------------------------------------------------------------- the run

def _keep_slice_clock(common, torch):
    """Let the drivers' profile_slice keep what places the program's spans
    on its device trace: the slice's host window on the program's clock, an
    anchor of the clocks, the trace's origin on the Unix clock and its
    device operations (none on the CPU, where no device trace is read)."""
    from torch.autograd import DeviceType

    from bobe_tpu_torch.utils import trace

    base, profile = common.profile_slice, torch.profiler.profile
    kept = {}

    class Keeping(profile):
        def __exit__(self, *exc):
            out = super().__exit__(*exc)
            kept["prof"] = self
            return out

    def profile_slice(fn, device, spans):
        clock = {"anchor": trace.clock_anchor()}

        def timed():
            t0 = time.perf_counter_ns()
            try:
                return fn()
            finally:
                clock["host_ns"] = (t0, time.perf_counter_ns())

        torch.profiler.profile = Keeping
        try:
            s = base(timed, device, spans)
        finally:
            torch.profiler.profile = profile
        s.update(clock)
        prof = kept.pop("prof", None)
        if prof is None:
            s.update(trace_start_ns=0, device_intervals=[])
        else:
            s["trace_start_ns"] = prof.profiler.kineto_results.trace_start_ns()
            s["device_intervals"] = sorted(
                (e.time_range.start, e.time_range.end, e.name)
                for e in prof.events() if e.device_type == DeviceType.CUDA)
        return s

    common.profile_slice = profile_slice


def _alternate(kind, parity, flags):
    """Turn the tracer on for the window's units of one parity and off for
    the others (``flags`` gets each unit's); returns what undoes it."""
    from bobe_tpu_torch import samplers
    from bobe_tpu_torch.utils import trace

    from benchmark.drivers import loop

    def toggle():
        on = len(flags) % 2 == parity
        flags.append(on)
        if on:
            trace.enable()
        else:
            trace.disable()

    if kind == "loop":
        base = loop.restore      # called before each episode of the window

        def restore(*args, **kwargs):
            toggle()
            return base(*args, **kwargs)

        loop.restore = restore
        return lambda: setattr(loop, "restore", base)
    base = samplers.nested_sampling

    def nested_sampling(*args, **kwargs):
        if "maxcall" not in kwargs:   # the warm-up and the slice pass one
            toggle()
        return base(*args, **kwargs)

    samplers.nested_sampling = nested_sampling
    return lambda: setattr(samplers, "nested_sampling", base)


def run_ab(name, seed, seconds_, device, parity):
    """The cell's untraced run with the tracer on for every other unit;
    returns (the benchmark's result object, [[unit seconds, on], ...])."""
    from benchmark import run as R
    from bobe_tpu_torch.utils import trace

    cell, cfg = R.load_cell(name)
    bench = R.load_json(R.ROOT / "BENCHMARK.json")
    flags = []
    undo = _alternate(cell["kind"], parity, flags)
    try:
        run = R.drive(cell, cfg, seed, seconds_, 0, device)
    finally:
        undo()
        trace.disable()
    units = [[t, on] for t, on in zip(run["unit_s"], flags)]
    return R.result(run, name, cell, cfg, bench, 0, device), units


def run_traced(name, seed, seconds_, trace_, device, cell=None, cfg=None,
               chrome=None):
    """The benchmark's run of one cell with the program's tracer on; returns
    (the benchmark's result object, the readings)."""
    import torch

    from benchmark import run as R
    from benchmark.drivers import common
    from bobe_tpu_torch.utils import trace

    if cell is None:
        cell, cfg = R.load_cell(name)
    bench = R.load_json(R.ROOT / "BENCHMARK.json")
    base = common.profile_slice
    _keep_slice_clock(common, torch)
    trace.enable()
    try:
        run = R.drive(cell, cfg, seed, seconds_, trace_, device)
    finally:
        common.profile_slice = base
        snap = trace.snapshot()
        trace.disable()
    run["program_trace"] = snap
    t0 = round(run["setup_end"] * 1e9)
    run["program_window_ns"] = (t0, t0 + round(run["window_s"] * 1e9))
    if chrome:
        trace.write_chrome_trace(chrome, snap)
    got = readings(run)
    out = R.result(run, name, cell, cfg, bench, trace_, device)
    return out, got


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=1)
    p.add_argument("--device", default="cuda")
    p.add_argument("--chrome", default=None)
    p.add_argument("--ab", type=int, choices=(0, 1, 2), default=0)
    args = p.parse_args(argv)
    if args.ab:
        out, units = run_ab(args.workload, args.seed, args.seconds,
                            args.device, args.ab - 1)
        out.update(workload=args.workload, seed=args.seed, ab=units)
        print(json.dumps(out, default=str), flush=True)
        return
    out, got = run_traced(args.workload, args.seed, args.seconds, args.trace,
                          args.device, chrome=args.chrome)
    out["program"] = {k: v for k, (v, _) in got.items()}
    out["program_details"] = {k: d for k, (_, d) in got.items()}
    out.update(workload=args.workload, seed=args.seed, trace=args.trace)
    print(json.dumps(out, default=str), flush=True)


if __name__ == "__main__":
    main()
