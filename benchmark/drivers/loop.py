"""Loop cells: episodes of the BO loop's own iterations on a restored state.

Set-up builds the state from the seed (drivers/common.build_state), runs the
loop's entry, whose MC-pool refresh is the cold pool, and takes a snapshot
of the state there: the GP (and its gate), the pool, the pool's adapted
kernel. One warm-up iteration follows, so that every shape the window uses
has run once. Each episode of the window then restores the snapshot (a
device-side state is shared, never refit) and calls ``BOBE.run``, whose
entry takes the restored pool and whose loop runs ``iterations`` of its own
bodies (acquisition, likelihood batch, overlapped refresh and its join, the
GP update with the refit schedule, the classifier) until
``check_max_evals_and_gpsize`` ends the episode by raising. The run's
epilogue (final NS or NUTS) is never reached. Every episode draws its own
random streams from the run's seed and its index, so a window averages the
loop's random work (restarts, chains, draws) over its episodes while the
state and the sizes stay those of the snapshot.

Records of what the timed path produced (batches, acquisition values, their
pools, the fits' starts and gradients there, basins and objective values,
the pools' values) are kept for a sample of episodes drawn from the seed
before each episode runs, and judged once the window has closed. A record
holds references to what the program made and device copies of its
hyperparameters, read on the host only after the window. The restore and
the records are the harness's work inside the window: their seconds are
counted (``harness_s``) and left out of the loop's own host time.
"""
from __future__ import annotations

import time

import numpy as np

from . import common


class EpisodeEnd(Exception):
    """Raised by the loop's end-of-iteration check when an episode is
    complete."""


def _episode_class():
    from bobe_tpu_torch.bo import BOBE

    class EpisodeBOBE(BOBE):
        """BOBE whose run is one episode: its entry takes the restored MC
        pool, and its end-of-iteration check raises after ``episode_len``
        iterations. What the loop produces is recorded into ``bench_rec``;
        ``bench_spans`` gets host spans of its layers when a list;
        ``bench_mc`` is the list the pools the acquisition draws go to, and
        ``bench_warm`` gets, for each refresh of the loop, whether it kept
        its warm start; ``bench_harness_s`` sums the seconds spent
        recording; ``bench_starts["last"]`` holds the starts of the latest
        fit and its gradient there (drivers/common.record_fit_gradients)."""

        episode_len = 1
        bench_pool = None
        bench_iter = 0
        bench_rec = None
        bench_snapshot = None
        bench_spans = None
        bench_harness_s = 0.0
        bench_starts = None

        def _span(self, name, fn, *a, **k):
            if self.bench_spans is None:
                return fn(*a, **k)
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.bench_spans.append((name, t0, time.perf_counter()))

        def _refresh_mc_samples(self, np_rng=None, generator=None,
                                phase="MCMC Sampling"):
            entry = phase == "MCMC Sampling" and self.bench_iter == 0
            if entry and self.bench_pool is not None:
                self.mc_samples = dict(self.bench_pool)
                return
            super()._refresh_mc_samples(np_rng, generator, phase)
            if not entry:
                self.bench_warm.append(bool(
                    self.mc_samples.get("diagnostics", {}).get("warm")))
            if self.bench_rec is not None:
                t0 = time.perf_counter()
                self.bench_rec["pool"].append({
                    "rows_upto": 0 if entry else self.bench_iter - 1,
                    "log_params": common.log_params_ref(self.gp),
                    "x": self.mc_samples["x"],
                    "logp": self.mc_samples["logp"]})
                self.bench_harness_s += time.perf_counter() - t0
            if entry and self.bench_snapshot is None:
                self.bench_snapshot = snapshot(self)

        def get_next_batch(self, acq_kwargs, *a, **k):
            self.bench_iter += 1
            t0 = time.perf_counter()
            lp = (common.log_params_ref(self.gp)
                  if self.bench_rec is not None else None)
            gp_size = int(self.gp.gp_size)
            self.bench_mc.clear()
            self.bench_harness_s += time.perf_counter() - t0
            pts, vals = self._span("acquisition", super().get_next_batch,
                                   acq_kwargs, *a, **k)
            if self.bench_rec is not None:
                t0 = time.perf_counter()
                self.bench_rec["acq"].append({
                    "k": self.bench_iter, "log_params": lp,
                    "gp_size": gp_size, "picks": np.array(pts),
                    "vals": np.array(vals), "mc_sets": list(self.bench_mc)})
                self.bench_harness_s += time.perf_counter() - t0
            return pts, vals

        def evaluate_likelihood(self, *a, **k):
            return self._span("likelihood", super().evaluate_likelihood,
                              *a, **k)

        def _join_refresh(self, holder):
            return self._span("mc_join_wait", super()._join_refresh, holder)

        def update_gp(self, *a, **k):
            before = self.gp._fit_basins
            out = self._span("gp_update_fit_clf", super().update_gp, *a, **k)
            if self.bench_rec is not None and self.gp._fit_basins is not before:
                t0 = time.perf_counter()
                self.bench_rec["fit"].append({
                    "rows_upto": self.bench_iter,
                    "basins": list(self.gp._fit_basins),
                    "starts": self.bench_starts["last"]})
                self.bench_harness_s += time.perf_counter() - t0
            return out

        def check_max_evals_and_gpsize(self, current_evals):
            if self.bench_iter >= self.episode_len:
                raise EpisodeEnd
            return super().check_max_evals_and_gpsize(current_evals)

    return EpisodeBOBE


def snapshot(bobe):
    """What an episode restores, shared and not copied: the GP's attributes
    (its state tensors and the gate's parameters are replaced, never
    written, by the program's updates and the SVM's training), the cold pool
    and its adapted kernel (read through copies by the sampler), the
    incumbent."""
    gp = bobe.gp
    return {"gp": dict(gp.__dict__),
            "pool": {k: v for k, v in bobe.mc_samples.items()
                     if k != "_mode_labels"},
            "warm": getattr(bobe, "_nuts_warm", None),
            "best": (bobe.best_f, np.array(bobe.best_pt), dict(bobe.best),
                     bobe.best_pt_iteration)}


def restore(bobe, snap, seed, episode):
    from bobe_tpu_torch.utils.seed import set_global_seed

    gp = bobe.gp
    gp.__dict__.clear()
    gp.__dict__.update(snap["gp"])
    bobe._nuts_warm = snap["warm"]
    bobe.best_f, bp, best, bobe.best_pt_iteration = snap["best"]
    bobe.best_pt, bobe.best = np.array(bp), dict(best)
    bobe.bench_pool = snap["pool"]
    bobe.bench_iter = 0
    bobe.prev_samples = None
    bobe.np_rng = np.random.default_rng(common.sub_seed(seed, 3, episode))
    set_global_seed(common.program_seed(seed, 4, episode))


def _new_rec():
    return {"acq": [], "fit": [], "pool": []}


def run(cfg, cell, seed, seconds, trace, device):
    """One run of a loop cell. Returns the run's raw record (window, units,
    ledger, records for the check, the profiled slice when traced)."""
    from bobe_tpu_torch import acquisition

    draws, starts = [], {}
    get_mc_points = acquisition.get_mc_points

    def recording(*a, **k):
        out = get_mc_points(*a, **k)
        draws.append(out)
        return out

    acquisition.get_mc_points = recording
    try:
        with common.record_fit_gradients(starts):
            return _run(draws, starts, cfg, cell, seed, seconds, trace,
                        device)
    finally:
        acquisition.get_mc_points = get_mc_points


def judge(run, cell, cfg, device, stand_in=None):
    """The loop cell's numbers (reference/judge.py)."""
    from ..reference.judge import judge_loop

    return judge_loop(run, cfg["reference"], device, stand_in)


def _run(draws, starts, cfg, cell, seed, seconds, trace, device):
    t_state = time.perf_counter()
    bobe, info = common.build_state(cfg, cell, seed, device,
                                    _episode_class())
    common.sync(device)
    t_built = time.perf_counter()
    bobe.bench_starts = starts
    bobe.bench_mc = draws
    bobe.bench_warm = []
    setup_rec = _new_rec()
    setup_rec["fit"].append({"rows_upto": 0,
                             "basins": list(bobe.gp._fit_basins),
                             "starts": starts["last"]})
    run_kw = dict(cfg["run"])
    run_kw.update(cell.get("run", {}))
    E = int(cell["episode_iterations"])

    def episode(rec):
        bobe.bench_rec = rec
        try:
            bobe.run(**run_kw)
        except EpisodeEnd:
            pass
        else:
            raise RuntimeError("the loop ended before its episode did")

    # the loop's entry: the cold pool, the snapshot; one warm-up iteration
    bobe.episode_len = 1
    episode(setup_rec)
    snap = bobe.bench_snapshot
    bobe.episode_len = E
    common.sync(device)

    rm = bobe.results_manager
    rng = np.random.default_rng(common.sub_seed(seed, 5))
    kept, n_ep, durations, restore_s = [None, None], 0, [], 0.0
    del bobe.bench_warm[:]
    bobe.bench_harness_s = 0.0
    phases0 = rm.get_timing_summary()["phase_times"]
    t0 = time.perf_counter()
    setup_end = t0
    while True:
        t_h = time.perf_counter()
        restore(bobe, snap, seed, n_ep)
        # a reservoir of two episodes' records, drawn from the seed before
        # the episode, so that only a kept episode records
        slot = n_ep if n_ep < 2 else int(rng.integers(n_ep + 1))
        rec = _new_rec() if slot < 2 else None
        t_ep = time.perf_counter()
        restore_s += t_ep - t_h
        episode(rec)
        durations.append(time.perf_counter() - t_ep)
        if rec is not None:
            kept[slot] = rec
        n_ep += 1
        if time.perf_counter() - t0 >= seconds:
            break
    common.sync(device)
    window = time.perf_counter() - t0
    phases1 = rm.get_timing_summary()["phase_times"]
    ledger = {p: t - phases0.get(p, 0.0) for p, t in phases1.items()}
    out = {"kind": "loop", "setup_end": setup_end,
           "setup_marks": (t_state, t_built), "window_s": window,
           "units": n_ep, "iterations": n_ep * E, "ledger": ledger,
           "harness_s": restore_s + bobe.bench_harness_s,
           "unit_s": durations, "warm": list(bobe.bench_warm),
           "attempted": n_ep * E, "failed": 0, "bobe": bobe, "info": info,
           "setup_rec": setup_rec,
           "records": [r for r in kept if r is not None]}
    if trace:
        spans = []
        bobe.bench_spans = spans
        restore(bobe, snap, seed, n_ep)
        bobe.episode_len = int(cell.get("profile_iterations", E))
        out["slice"] = common.profile_slice(lambda: episode(None),
                                            device, spans)
        bobe.bench_spans = None
    return out
