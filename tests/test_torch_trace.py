"""The port's tracer (bobe_tpu_torch/utils/trace.py) on the CPU: spans nest
and carry their parent, thread and request id; a second thread keeps its own
stack; with tracing off nothing is recorded and nothing synchronises; the
buffer counts what it drops; the timing ledger's phases are the tracer's
spans on the same clock readings; a BO run's refresh outcomes agree with its
samples' diagnostics; an evidence's spans account for its seconds; and the
spans land on a torch.profiler trace's clock (tools/torch_port_trace.py)."""
import json
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from bobe_tpu_torch import bo, samplers
from bobe_tpu_torch.models import toys
from bobe_tpu_torch.models.gp import GP
from bobe_tpu_torch.utils import trace
from bobe_tpu_torch.utils.results import BOBEResults

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import torch_port_trace as tool  # noqa: E402


@pytest.fixture(autouse=True)
def _tracer_off():
    trace.disable()
    yield
    trace.disable()


def _names(snap):
    return [s.name for s in snap["spans"]]


def test_spans_nest_and_carry_their_parent():
    trace.enable()
    with trace.span("a", request=7) as a:
        with trace.span("b") as b:
            b.count("evals", 2)
            b.count("evals")
            trace.count("draws", 5)
        c = trace.span("c")
        c.set("outcome", "kept")
        c.close()
        c.close()  # a second close records nothing more
    snap = trace.snapshot()
    by = {s.name: s for s in snap["spans"]}
    assert _names(snap) == ["b", "c", "a"]
    assert by["a"].parent is None and by["a"].id == a.id
    assert by["b"].parent == by["c"].parent == a.id
    assert {s.request for s in snap["spans"]} == {7}
    assert by["b"].counts == {"evals": 3, "draws": 5}
    assert by["c"].counts == {"outcome": "kept"}
    assert snap["counters"] == {"b.evals": 3, "b.draws": 5}
    for s in snap["spans"]:
        assert s.thread == threading.current_thread().name
        assert s.start_ns <= s.end_ns
    assert by["a"].start_ns <= by["b"].start_ns <= by["b"].end_ns \
        <= by["c"].start_ns <= by["a"].end_ns


def test_a_parent_closes_the_spans_left_open_inside_it():
    trace.enable()
    outer = trace.span("outer")
    trace.span("left_open")
    end = outer.close()
    with trace.span("next"):
        pass
    by = {s.name: s for s in trace.snapshot()["spans"]}
    assert by["left_open"].end_ns == by["outer"].end_ns == end
    assert by["next"].parent is None


def test_fresh_requests_number_each_kind():
    trace.enable()
    for _ in range(2):
        with trace.span("ns.evidence", fresh="evidence"):
            with trace.span("ns.run"):
                pass
    got = [(s.name, s.request) for s in trace.snapshot()["spans"]]
    assert got == [("ns.run", "evidence 1"), ("ns.evidence", "evidence 1"),
                   ("ns.run", "evidence 2"), ("ns.evidence", "evidence 2")]


def test_a_second_thread_keeps_its_own_stack_and_request():
    trace.enable()
    started, release = threading.Event(), threading.Event()

    def refresh(request):
        trace.adopt(request)
        with trace.span("mc.refresh"):
            started.set()
            release.wait(10)
            with trace.span("mc.cold"):
                pass

    with trace.span("bo.iteration", request=3):
        t = threading.Thread(target=refresh, args=(trace.current_request(),),
                             name="bobe-refresh")
        t.start()
        started.wait(10)
        with trace.span("mc.join_wait"):
            release.set()
            t.join()
    by = {s.name: s for s in trace.snapshot()["spans"]}
    assert by["mc.refresh"].parent is None
    assert by["mc.cold"].parent == by["mc.refresh"].id
    assert by["mc.join_wait"].parent == by["bo.iteration"].id
    assert by["mc.refresh"].thread == by["mc.cold"].thread == "bobe-refresh"
    assert by["bo.iteration"].thread != "bobe-refresh"
    assert {s.request for s in by.values()} == {3}
    below = {s.name for s in tool.below(list(by.values()), "bo.iteration")}
    assert below == {"mc.join_wait", "mc.refresh", "mc.cold"}


def test_self_time_is_the_span_less_its_children():
    trace.enable()
    with trace.span("parent"):
        time.sleep(0.002)
        with trace.span("child"):
            time.sleep(0.003)
            with trace.span("grandchild"):
                time.sleep(0.001)
    spans = trace.snapshot()["spans"]
    by = {s.name: s for s in spans}
    own = tool.self_seconds(spans)
    sec = tool.seconds
    assert own[by["parent"].id] == pytest.approx(
        sec(by["parent"]) - sec(by["child"]), abs=1e-12)
    assert own[by["child"].id] == pytest.approx(
        sec(by["child"]) - sec(by["grandchild"]), abs=1e-12)
    assert own[by["grandchild"].id] == sec(by["grandchild"])
    assert own[by["parent"].id] >= 0.002 and own[by["child"].id] >= 0.003


class _Stream:
    def __init__(self, calls):
        self.calls = calls

    def synchronize(self):
        self.calls.append("stream")


def _fake_card(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a, **k: _Stream(calls))
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: calls.append("device"))
    return calls


def _tiny_gp():
    loglike, bounds, _ = toys.make_gaussian(2, sigma=0.15)
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(30, 2))
    y = np.array([loglike(xi) for xi in x])
    gp = GP(x, y, device="cpu")
    gp.fit(n_restarts=2, maxiter=30, rng=rng)
    return gp


def _traced_work(gp):
    rm = BOBEResults("t", save_dir=".")
    rm.start_timing("Nested Sampling")
    samplers.nested_sampling(gp, mode="convergence", dlogz=0.5, nlive=50,
                             rng=np.random.default_rng(1))
    rm.end_timing("Nested Sampling")
    gp.fit(n_restarts=2, maxiter=5, rng=np.random.default_rng(2))
    return rm


def test_tracing_off_records_nothing_and_never_synchronises(monkeypatch):
    gp = _tiny_gp()
    calls = _fake_card(monkeypatch)
    rm = _traced_work(gp)
    assert rm.last_timing("Nested Sampling") > 0
    assert calls == []
    assert trace.span("x") is trace.NULL and trace.current_request() is None
    trace.enable()
    trace.disable()
    _traced_work(gp)
    assert trace.snapshot()["spans"] == [] and calls == []
    # the positive control: on, the spans that close device work do
    trace.enable()
    _traced_work(gp)
    names = set(_names(trace.snapshot()))
    assert {"Nested Sampling", "ns.evidence", "ns.bounds", "gp.fit"} <= names
    assert calls and set(calls) == {"stream"}


def test_the_buffer_cap_counts_its_drops():
    trace.enable(cap=3)
    for _ in range(5):
        with trace.span("x"):
            pass
    snap = trace.snapshot()
    assert len(snap["spans"]) == 3 and snap["dropped"] == 2 \
        and snap["cap"] == 3
    run = {"kind": "loop", "program_trace": snap,
           "program_window_ns": (0, 2**62)}
    with pytest.raises(RuntimeError, match="dropped 2"):
        tool.window_spans(run, "loop")
    trace.enable()
    assert trace.snapshot()["dropped"] == 0


def test_the_anchor_pairs_the_clocks():
    a = trace.clock_anchor()
    u, p = time.time_ns(), time.perf_counter_ns()
    assert 0 <= a["width_ns"] < 1_000_000
    # the two clocks, read again, keep the anchor's offset
    assert abs((u - p) - (a["unix_ns"] - a["perf_ns"])) < 5_000_000


def test_an_evidence_spans_account_for_its_seconds():
    gp = _tiny_gp()
    trace.enable()
    smp, _, _ = samplers.nested_sampling(gp, mode="convergence", dlogz=0.5,
                                         nlive=50,
                                         rng=np.random.default_rng(3))
    spans = trace.snapshot()["spans"]
    ev = [s for s in spans if s.name == "ns.evidence"]
    assert len(ev) == 1 and ev[0].request == "evidence 1"
    kids = sorted(s.name for s in spans if s.parent == ev[0].id)
    assert kids == ["ns.bounds", "ns.run"]   # a plain GP seeds no live set
    inner = [s for s in spans if s.name == "ns.inner"]
    outer = [s for s in spans if s.name == "ns.outer"]
    assert len(inner) == smp["n_inner"] and len(outer) == smp["n_iter"] + 1
    assert {s.request for s in spans} == {"evidence 1"}
    parts = sum(tool.total(spans, n) for n in ("ns.outer", "ns.bounds"))
    assert parts <= tool.seconds(ev[0])
    assert tool.total(spans, "ns.inner") < tool.total(spans, "ns.outer")


def _bobe(tmp_path, **kw):
    loglike, bounds, _ = toys.make_gaussian(2, sigma=0.15)
    args = dict(loglikelihood=loglike, param_list=["a", "b"],
                param_bounds=bounds, likelihood_name="gauss_trace",
                n_sobol_init=16, seed=5, save_dir=str(tmp_path),
                verbosity="WARNING", pool="serial", device="cpu", save=False)
    args.update(kw)
    return bo.BOBE(**args)


def test_a_bo_run_ledger_is_its_phase_spans(tmp_path, monkeypatch):
    """A short EHMC-pool run with the tracer on from the constructor: every
    ledger phase sums to its spans, the refresh outcomes agree with the
    samples' diagnostics, and each iteration's spans carry it."""
    monkeypatch.setattr(bo, "FINAL_NUTS", {"num_chains": 2,
                                           "warmup_steps": 16,
                                           "samples_per_dim": 16,
                                           "thinning": 1})
    warm = []
    base = bo.BOBE._refresh_mc_samples

    def recording(self, *a, **k):
        base(self, *a, **k)
        warm.append(bool(self.mc_samples["diagnostics"]["warm"]))

    monkeypatch.setattr(bo.BOBE, "_refresh_mc_samples", recording)
    trace.enable()
    bobe = _bobe(tmp_path)
    bobe.run(acq="wipstd", min_evals=1000, max_evals=28, max_gp_size=60,
             logz_threshold=0.5, fit_n_points=4, batch_size=4, ns_n_points=4,
             num_hmc_samples=128)
    snap = trace.snapshot()
    spans = snap["spans"]
    phases = bobe.results_manager.get_timing_summary()["phase_times"]
    for phase, t in phases.items():
        got = sum(s.end_ns - s.start_ns for s in spans if s.name == phase)
        assert got * 1e-9 == pytest.approx(t, rel=1e-12, abs=1e-15), phase
    assert phases["MCMC Sampling (overlapped)"] > 0
    # the refreshes: the entry's (cold) and one per iteration; the final
    # NUTS fallback runs cold outside any refresh
    refresh = {s.id for s in spans if s.name == "mc.refresh"}
    kept = [s for s in spans if s.name == "mc.warm"
            and s.counts["outcome"] == "kept"]
    cold = [s for s in spans if s.name == "mc.cold" and s.parent in refresh]
    assert len(warm) == len(refresh)
    assert all(s.parent in refresh for s in kept)
    assert len(kept) == sum(warm) and len(cold) == len(warm) - sum(warm)
    for s in kept + cold:
        assert s.counts["leapfrog"] > 0
    iters = [s for s in spans if s.name == "bo.iteration"]
    assert [s.request for s in iters] == [1, 2, 3]
    below = tool.below(spans, "bo.iteration")
    for name in ("acq.batch", "acq.pick", "acq.refine", "gp.update",
                 "gp.fit", "mc.join_wait", "mc.refresh"):
        assert any(s.name == name for s in below), name
    fits = [s for s in spans if s.name == "gp.fit"]
    assert all(s.counts["evals"] > 0 and s.counts["restarts"] > 0
               for s in fits)
    refine = [s for s in spans if s.name == "acq.refine"]
    assert refine and all(s.counts["evals"] > 0 for s in refine)
    path = tmp_path / "trace.json"
    trace.write_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    assert sum(e["ph"] == "X" for e in events) == len(spans)


def test_spans_land_on_the_profilers_clock():
    """A span closed right after a record_function marker ends within 50 us
    of the marker's end once placed on the profiler's clock (the marker's
    start is not used: entering it costs ~100 us under the CPU profiler)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    anchor = trace.clock_anchor()
    trace.enable()
    x = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(5):
            sp = trace.span(f"s{i}")
            with record_function(f"mark{i}"):
                x = x @ x / 64
            sp.close()
    start = prof.profiler.kineto_results.trace_start_ns() \
        + tool.unix_to_program_ns(anchor)
    marks = {e.name: e for e in prof.events() if e.name.startswith("mark")}
    for s in trace.snapshot()["spans"]:
        end = start + marks["mark" + s.name[1:]].time_range.end * 1e3
        assert 0 <= s.end_ns - end < 50_000, (s.name, s.end_ns - end)


def _slice_run(spans, ops, host):
    return {"kind": "loop",
            "program_trace": {"spans": spans, "dropped": 0, "cap": 10},
            "slice": {"host_ns": host, "trace_start_ns": 1_000,
                      "anchor": {"unix_ns": 1_000, "perf_ns": 0,
                                 "width_ns": 10},
                      "device_intervals": ops}}


def test_idle_named_places_gaps_in_program_spans():
    """Device operations at 10-20 and 50-60 us of a 0-100 us slice on the
    program's clock; idle 0-10, 20-50, 60-100 us. The iteration's child
    covers 20-60 us, its own time 0-20 and 60-100 us is not named."""
    R = trace.SpanRecord
    spans = [R(1, "bo.iteration", None, "main", 1, 0, 100_000, None),
             R(2, "acq.batch", 1, "main", 1, 20_000, 60_000, None),
             R(3, "mc.refresh", None, "refresh", 1, 5_000, 8_000, None)]
    ops = [(10.0, 20.0, "k1"), (50.0, 60.0, "k2")]
    r = tool.idle_named(_slice_run(spans, ops, (0, 100_000)), "loop",
                        "bo.iteration")
    assert r["idle_s"] == pytest.approx(80e-6)
    # 20-50 us inside acq.batch, 5-8 us inside the refresh of iteration 1
    assert r["share"] == pytest.approx(100 * 33 / 80)
    first = r["gaps"][0]
    assert first["gap_s"] == pytest.approx(40e-6) and first["next_op"] is None
    assert r["gaps"][1]["spans"] == {"main": {"span": "acq.batch",
                                              "request": 1}}
    assert r["gaps"][1]["next_op"] == "k2"
    assert tool.idle_named({"kind": "loop"}, "loop", "bo.iteration") is None


@pytest.mark.cuda
def test_a_span_around_a_synchronised_kernel_holds_its_device_interval():
    """On the card: each matrix product launched a millisecond into a span
    that waits a millisecond after synchronising runs, on the program's
    clock, inside that span (the clocks' placement errs by tens of us)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the device trace is the card's)")
    x = torch.randn(1024, 1024, dtype=torch.float64, device="cuda")
    (x @ x).sum().item()
    anchor = trace.clock_anchor()
    trace.enable()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(3):
            with trace.span(f"s{i}", sync=True):
                time.sleep(1e-3)
                y = x @ x
                torch.cuda.synchronize()
                time.sleep(1e-3)
    del y
    shift = prof.profiler.kineto_results.trace_start_ns() \
        + tool.unix_to_program_ns(anchor)
    ops = [(shift + e.time_range.start * 1e3, shift + e.time_range.end * 1e3)
           for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = trace.snapshot()["spans"]
    assert len(ops) >= 3
    for a, b in ops:
        assert any(s.start_ns <= a and b <= s.end_ns for s in spans), \
            ((a, b), [(s.start_ns, s.end_ns) for s in spans])


def test_threads_at_a_fast_switch_lose_no_span_and_share_no_id():
    """More threads than cores open spans and fresh request ids at once,
    the interpreter switching threads every microsecond: every span is
    kept, every id and request is distinct, every parent is its thread's."""
    n_threads, n_spans = 16, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        trace.enable()

        def work():
            for _ in range(n_spans):
                with trace.span("outer", fresh="evidence"):
                    with trace.span("inner"):
                        pass

        threads = [threading.Thread(target=work, name=f"w{i}")
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    snap = trace.snapshot()
    spans = snap["spans"]
    assert snap["dropped"] == 0 and len(spans) == 2 * n_threads * n_spans
    assert len({s.id for s in spans}) == len(spans)
    outer = {s.id: s for s in spans if s.name == "outer"}
    assert len({s.request for s in outer.values()}) == n_threads * n_spans
    for s in spans:
        if s.name == "inner":
            assert outer[s.parent].thread == s.thread
            assert outer[s.parent].request == s.request
