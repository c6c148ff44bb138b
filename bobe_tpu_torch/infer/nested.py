"""Batched nested sampling over a device-resident surrogate.

Counterpart of ``bobe_tpu/infer/nested.py``. The JAX package runs the whole
sampler as one jitted ``while_loop`` nest; here the two loops are host loops
over batched tensor ops with the same semantics:

* Batch kill: each outer step retires the K worst live points at once; the
  r-th retired point gets the expected log-volume shrinkage
  ``-sum_{m<=r} 1/(nlive - m)``.
* Batch replace: K clones of random survivors are evolved by hit-and-run
  slice sampling constrained to logL > L*, with directions from the live-set
  covariance (whitened), the full unit-cube chord as the first bracket, and
  ``spec`` speculative shrink candidates per lane in one batched likelihood
  call. Every lane runs its n_repeats slice updates back to back.
* Stopping: remaining-evidence criterion dlogz, plus call and buffer budgets.
* Dynamic runs (``run_nested_dynamic``): a base run, then a second live set
  seeded in the posterior bulk, decorrelated by constrained slice sampling
  and run to the end, merged with the base run by the varying-live-count
  volume schedule (``merge_runs``).

Each outer iteration reads the stopping quantities from the device once, and
each inner iteration reads whether any lane is still active once: the host
synchronises about (outer + inner) times per run (``NSResult.n_inner``).
On a card without a mesh the inner iteration, which updates the lanes'
buffers in place (``_slice_step``), is captured once per run as a CUDA graph
(``_SliceGraph``) and replayed: one launch where the eager step makes about
a hundred, with the same draws and the same arithmetic.

With a ``mesh`` (parallel/mesh.py) every likelihood batch, the proposal
batch of each inner iteration above all, is split over the mesh's devices,
the GP state replicated on each; the draws stay on the generator's device,
so only where the batch runs changes.
"""
from __future__ import annotations

import math
import threading
from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import config
from ..ops import chol as chol_ops
from ..utils import trace
from ..utils.log import get_logger
from ..utils.seed import split_generator
from . import integrals

log = get_logger("nested")


class NSResult(NamedTuple):
    dead_x: np.ndarray      # (n_total, d) dead + final live, sampling order
    dead_logl: np.ndarray   # (n_total,)
    logvol: np.ndarray      # (n_total,) assigned log prior volumes
    logz: float             # quick accumulated estimate (use integrals for final)
    n_calls: int
    n_iter: int
    nlive: int
    success: bool
    nlive_schedule: np.ndarray = None  # (n_total,) own live count per death
    logvol0: float = 0.0    # log prior volume the live set was seeded in
    n_inner: int = 0        # slice-sampling iterations over all outer steps


def _live_cov_chol(live_x):
    """Cholesky of the live-set empirical covariance (whitened sampling)."""
    nlive, d = live_x.shape
    mean = torch.mean(live_x, dim=0)
    xc = (live_x - mean) / math.sqrt(nlive)
    cov = xc.T @ xc + 1e-10 * torch.eye(d, dtype=live_x.dtype,
                                        device=live_x.device)
    return chol_ops.cholesky(cov)


def _chord_bounds(x, e):
    """Intersection of the lines x + t*e (rows) with the unit cube:
    (t_lo, t_hi), each (n,)."""
    eps = 1e-30
    e_safe = torch.where(torch.abs(e) < eps, torch.full_like(e, eps), e)
    t0 = (0.0 - x) / e_safe
    t1 = (1.0 - x) / e_safe
    lo = torch.amax(torch.minimum(t0, t1), dim=-1)
    hi = torch.amin(torch.maximum(t0, t1), dim=-1)
    return lo, hi


def _spec_candidates(u, lo, hi, spec):
    """Speculative shrink chain: the ``spec`` candidate positions a lane's
    slice loop would draw if every previous candidate were rejected. A
    rejection shrinks the bracket toward 0 by the sign of the rejected t
    only, so the chain follows from the uniforms alone. u: (spec, n);
    lo/hi: (n,). Returns (ts (n, spec), lo_end, hi_end)."""
    ts = []
    for s in range(spec):
        t = lo + (hi - lo) * u[s]
        ts.append(t)
        lo = torch.where(t < 0, t, lo)
        hi = torch.where(t >= 0, t, hi)
    return torch.stack(ts, dim=1), lo, hi


def _resolve_spec(spec, d: int) -> int:
    """Speculative slice-shrink depth: the given ``spec``, else 4 for
    d >= 10 and 1 below."""
    if spec is None:
        spec = 4 if d >= 10 else 1
    return max(1, int(spec))


class _Lanes:
    """The slice sampler's state over n lanes, updated in place by
    :func:`_slice_step`: each lane's point ``x`` and value ``l``, direction
    ``e`` and bracket [``lo``, ``hi``] along it, completed updates ``rep``
    and shrinks of the current one ``shrink``; the surrogate calls ``nev``,
    the threshold ``lstar``, and whether each lane (``active``) and any lane
    (``any_active``) has updates left. The same buffers serve every
    iteration, so a CUDA graph of the step replays on them."""

    def __init__(self, n: int, d: int, spec: int, dtype, device):
        f = dict(dtype=dtype, device=device)
        i = dict(dtype=torch.int64, device=device)
        b = dict(dtype=torch.bool, device=device)
        self.x, self.e = torch.empty((n, d), **f), torch.empty((n, d), **f)
        self.l, self.lo, self.hi = (torch.empty(n, **f) for _ in range(3))
        self.lstar = torch.empty((), **f)
        self.rep, self.shrink = torch.empty(n, **i), torch.empty(n, **i)
        self.nev = torch.empty((), **i)
        self.active = torch.empty(n, **b)
        self.any_active = torch.empty((), **b)
        self.lanes = torch.arange(n, device=device)
        self.steps = torch.arange(spec, device=device)

    def load(self, x, l, lstar, n_repeats: int, draw_dirs):
        """Start every lane at (x, l) above ``lstar``, its first direction
        drawn at x and its bracket the direction's chord of the cube."""
        self.x.copy_(x)
        self.l.copy_(l)
        self.lstar.copy_(lstar)
        self.e.copy_(draw_dirs(self.x))
        lo, hi = _chord_bounds(self.x, self.e)
        self.lo.copy_(lo)
        self.hi.copy_(hi)
        self.rep.zero_()
        self.shrink.zero_()
        self.nev.zero_()
        self.active.fill_(n_repeats > 0)
        self.any_active.fill_(n_repeats > 0)


def _slice_step(s: _Lanes, loglike_fn, gen, n_repeats: int, max_shrink: int,
                spec: int, draw_dirs):
    """One inner iteration of every lane, in place on ``s``: ``spec``
    speculative candidates per active lane in one likelihood batch, the
    first one above lstar accepted (or the bracket shrunk past them all),
    and a lane that completed an update takes a new direction. Reads
    nothing back to the host."""
    n, d = s.x.shape
    active = s.active
    u = torch.rand((spec, n), generator=gen, dtype=s.x.dtype,
                   device=s.x.device)
    ts, lo_end, hi_end = _spec_candidates(u, s.lo, s.hi, spec)
    x_try = torch.clamp(s.x[:, None, :] + ts[..., None] * s.e[:, None, :],
                        0.0, 1.0).reshape(n * spec, d)
    l_try = loglike_fn(x_try).reshape(n, spec)
    # candidate s is reachable only while the shrink budget lasts
    reachable = s.shrink[:, None] + s.steps[None, :] < max_shrink
    acc = (l_try > s.lstar) & reachable
    any_acc = torch.any(acc, dim=1)
    first = torch.argmax(acc.to(torch.int8), dim=1)
    ok = any_acc & active
    # exact eval accounting: draws up to acceptance, or all reachable
    # draws on full rejection
    n_reach = torch.clamp(max_shrink - s.shrink, 0, spec)
    used = torch.where(any_acc, first + 1, n_reach)
    s.nev += torch.sum(torch.where(active, used, torch.zeros_like(used)))
    x_acc = x_try.reshape(n, spec, d)[s.lanes, first]
    l_acc = l_try[s.lanes, first]
    torch.where(ok[:, None], x_acc, s.x, out=s.x)
    torch.where(ok, l_acc, s.l, out=s.l)
    nok = active & ~any_acc
    torch.where(nok, lo_end, s.lo, out=s.lo)
    torch.where(nok, hi_end, s.hi, out=s.hi)
    torch.where(nok, s.shrink + n_reach, s.shrink, out=s.shrink)
    complete = ok | (nok & (s.shrink >= max_shrink))
    s.rep += complete.to(s.rep.dtype)
    e_new = draw_dirs(s.x)
    lo_new, hi_new = _chord_bounds(s.x, e_new)
    torch.where(complete[:, None], e_new, s.e, out=s.e)
    torch.where(complete, lo_new, s.lo, out=s.lo)
    torch.where(complete, hi_new, s.hi, out=s.hi)
    s.shrink.masked_fill_(complete, 0)
    torch.lt(s.rep, n_repeats, out=s.active)
    torch.any(s.active, out=s.any_active)


class _SliceGraph:
    """One run's CUDA graph of :func:`_slice_step` (``run_nested`` on a
    card, without a mesh): the lanes' buffers and the live set's Cholesky
    factor are the run's (``lanes``, ``hold_chol``), loaded anew at each
    outer step. The step's first ``WARMUP`` calls run eagerly on a side stream,
    the next is captured there (capture runs nothing) and then replayed, as
    is every later call. The run's generator is registered with the graph,
    so a replay draws the numbers an eager call would draw. ``close()``
    frees the graph and its memory pool.

    The side stream is one per device for the process, as
    ``torch.cuda.graph``'s capture stream is: cuBLAS keeps a workspace for
    every stream it has run on, so a stream per run would leave one behind
    per run. One thread at a time warms up or captures on it."""

    WARMUP = 1
    _side_streams: dict = {}
    _side_lock = threading.Lock()

    def __init__(self, generator: torch.Generator):
        self.gen = generator
        self.device = generator.device
        self.graph = None
        self.warm = 0
        self.captures = 0
        self._lanes = None
        self._chol = None

    def lanes(self, n: int, d: int, spec: int, dtype) -> _Lanes:
        if self._lanes is None:
            self._lanes = _Lanes(n, d, spec, dtype, self.device)
        return self._lanes

    def hold_chol(self, chol):
        """The live set's Cholesky factor, copied into the run's buffer."""
        if self._chol is None:
            self._chol = torch.empty_like(chol)
        return self._chol.copy_(chol)

    def run(self, step) -> bool:
        """One call of ``step``; returns whether it was a graph replay."""
        with torch.cuda.device(self.device):
            if self.graph is None and self.warm < self.WARMUP:
                self._on_side(step)
                self.warm += 1
                return False
            if self.graph is None:
                with trace.span("ns.capture"):
                    self._on_side(step, capture=True)
            self.graph.replay()
        return True

    def _on_side(self, step, capture: bool = False):
        main = torch.cuda.current_stream()
        with self._side_lock:
            side = self._side_streams.get(self.device)
            if side is None:
                side = self._side_streams[self.device] = torch.cuda.Stream(
                    device=self.device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                if not capture:
                    step()
                else:
                    g = torch.cuda.CUDAGraph()
                    g.register_generator_state(self.gen)
                    g.capture_begin(capture_error_mode="thread_local")
                    try:
                        step()
                    finally:
                        g.capture_end()
                    self.graph = g
                    self.captures += 1
            main.wait_stream(side)

    def close(self):
        if self.graph is not None:
            self.graph.reset()
            self.graph = None


def _slice_lanes(loglike_fn, gen, x_cur, l_cur, lstar, n_repeats: int,
                 max_shrink: int, spec: int, draw_dirs, graph=None):
    """``n_repeats`` constrained slice updates (logL > lstar) of every lane,
    the lanes in lockstep, each running its updates back to back; a lane's
    next direction comes from ``draw_dirs(x)`` ((n, d) directions at the
    lanes' current points). The host reads whether any lane is active once
    an iteration. ``graph`` (a :class:`_SliceGraph`): the iterations run on
    its buffers, replayed from its graph. Returns (x, logl, n_evals
    (device), iterations)."""
    n, d = x_cur.shape
    if graph is None:
        s = _Lanes(n, d, spec, x_cur.dtype, x_cur.device)
    else:
        s = graph.lanes(n, d, spec, x_cur.dtype)
    s.load(x_cur, l_cur, lstar, n_repeats, draw_dirs)

    def step():
        _slice_step(s, loglike_fn, gen, n_repeats, max_shrink, spec,
                    draw_dirs)

    it = 0
    # an inner iteration's span runs from after one host read of the lanes'
    # activity to the next, which ends its device work
    inner = trace.NULL
    while it < n_repeats * max_shrink:
        stop = not bool(s.any_active)
        inner.close()
        if stop:
            break
        inner = trace.span("ns.inner")
        if graph is None:
            step()
        elif graph.run(step):
            inner.count("graph")
        it += 1
    inner.close()
    if graph is None:
        return s.x, s.l, s.nev, it
    # the run's buffers are loaded again at the next outer step
    return s.x.clone(), s.l.clone(), s.nev.clone(), it


def _replace_batch(loglike_fn, gen, live_x, live_logl, survivor_idx, lstar,
                   K: int, n_repeats: int, max_shrink: int, spec: int, *,
                   graph=None):
    """Evolve K clones of random survivors above lstar by slice sampling,
    with directions from the live set's covariance (fixed within the outer
    step); ``graph``: the run's :class:`_SliceGraph`, or None for eager
    iterations. Returns (x_new, l_new, n_evals (device),
    n_inner_iterations)."""
    nlive, d = live_x.shape
    dev, dt = live_x.device, live_x.dtype
    pick = torch.randint(0, nlive - K, (K,), generator=gen, device=dev)
    idx = survivor_idx[pick]
    chol = _live_cov_chol(live_x)
    if graph is not None:
        chol = graph.hold_chol(chol)

    def draw_dirs(x):
        z = torch.randn((K, d), generator=gen, dtype=dt, device=dev)
        return z @ chol.T

    return _slice_lanes(loglike_fn, gen, live_x[idx], live_logl[idx], lstar,
                        n_repeats, max_shrink, spec, draw_dirs, graph=graph)


def _loglike_fn(loglike_apply: Callable, ctx, mesh):
    """x (m, d) -> logL (m,); with a ``mesh`` (parallel/mesh.py) each batch
    is split over its devices, the GP state replicated on each."""
    if mesh is None:
        return lambda x: loglike_apply(ctx, x)
    from ..parallel.mesh import split_map

    apply = lambda c, x, _: loglike_apply(c, x)
    return lambda x: split_map(apply, ctx, x, mesh)[0]


def run_nested(loglike_apply: Callable, ctx, d: int, generator: torch.Generator,
               nlive: int = 500, dlogz: float = 0.01, maxcall: int = int(5e6),
               kill_frac: float = 0.1, n_repeats: int | None = None,
               max_shrink: int = 40, max_dead: int | None = None,
               live_x=None, live_logl=None, rng=None,
               logvol0: float = 0.0, warn_truncation: bool = True,
               spec: int | None = None, mesh=None) -> NSResult:
    """Run nested sampling; ``loglike_apply(ctx, x)`` maps (m, d) -> (m,)
    on ``generator``'s device.

    live_x/live_logl optionally seed the live set; ``logvol0`` is the log
    prior volume the seeded live set covers. ``mesh``: the likelihood
    batches (the proposal batch of every inner iteration) are split over
    its devices."""
    dt = config.DTYPE
    dev = generator.device
    if live_x is None:
        rng = rng if rng is not None else np.random.default_rng()
        live_x = torch.as_tensor(rng.uniform(size=(nlive, d)), dtype=dt,
                                 device=dev)
    else:
        live_x = torch.as_tensor(live_x, dtype=dt, device=dev)
        nlive = live_x.shape[0]
    loglike_fn = _loglike_fn(loglike_apply, ctx, mesh)
    if live_logl is None:
        live_logl = loglike_fn(live_x)
    live_logl = torch.as_tensor(live_logl, dtype=dt, device=dev)

    K = max(1, int(round(nlive * kill_frac)))
    if n_repeats is None:
        n_repeats = max(3, int(math.ceil(1.5 * d)))
    spec = _resolve_spec(spec, d)
    if max_dead is None:
        max_dead = int(min(1_000_000, max(20_000, nlive * 80)))
    max_dead = ((max_dead + K - 1) // K) * K  # multiple of K

    hs = torch.cumsum(1.0 / (nlive - torch.arange(K, dtype=dt, device=dev)),
                      dim=0)
    logvol = torch.tensor(float(logvol0), dtype=dt, device=dev)
    logz = torch.tensor(-1e300, dtype=dt, device=dev)
    calls = torch.zeros((), dtype=torch.int64, device=dev)
    dead_x, dead_logl, dead_lv = [], [], []
    n_dead = n_iter = n_inner = 0
    # on a card, without a mesh, the inner iterations replay a CUDA graph
    graph = _SliceGraph(generator) if dev.type == "cuda" and mesh is None \
        else None
    while True:
        # one outer step: the stopping read, the kill, the replacement
        with trace.span("ns.outer"):
            delta = torch.logaddexp(logz, torch.max(live_logl) + logvol) - logz
            delta_h, calls_h = torch.stack([delta, calls.to(dt)]).tolist()
            if not (delta_h > dlogz and n_dead + K <= max_dead
                    and calls_h < maxcall):
                break
            order = torch.argsort(live_logl, stable=True)
            kill_idx = order[:K]
            lstar = live_logl[order[K - 1]]
            lv_batch = logvol - hs
            dl = live_logl[kill_idx]
            dead_x.append(live_x[kill_idx])
            dead_logl.append(dl)
            dead_lv.append(lv_batch)
            # quick rectangle logz accumulation (stopping rule only)
            lv_prev = torch.cat([logvol[None], lv_batch[:-1]])
            logdvol = lv_prev + torch.log1p(
                -torch.exp(torch.clamp(lv_batch - lv_prev, max=-1e-12)))
            logz = torch.logaddexp(logz, torch.logsumexp(dl + logdvol, dim=0))
            x_new, l_new, rep_calls, inner = _replace_batch(
                loglike_fn, generator, live_x, live_logl, order[K:], lstar, K,
                int(n_repeats), int(max_shrink), spec, graph=graph)
            live_x = live_x.index_copy(0, kill_idx, x_new)
            live_logl = live_logl.index_copy(0, kill_idx, l_new)
            n_dead += K
            logvol = logvol - hs[-1]
            calls = calls + rep_calls
            n_iter += 1
            n_inner += inner
    if graph is not None:
        trace.count("captures", graph.captures)
        graph.close()

    cat = lambda parts, shape: (torch.cat(parts).cpu().numpy() if parts
                                else np.zeros(shape))
    dead_x = cat(dead_x, (0, d))
    dead_logl = cat(dead_logl, (0,))
    dead_lv = cat(dead_lv, (0,))
    logvol = float(logvol)
    logz = float(logz)
    calls = int(calls)
    live_x = live_x.cpu().numpy()
    live_logl = live_logl.cpu().numpy()

    # append the final live set: remaining volume split uniformly
    # X_i = X_end * (nlive - i)/nlive for the i-th in ascending logl
    live_order = np.argsort(live_logl)
    lx = live_x[live_order]
    ll = live_logl[live_order]
    frac = (nlive - np.arange(1, nlive + 1)) / nlive
    lv_live = logvol + np.log(np.clip(frac, 1e-300, None))

    all_x = np.concatenate([dead_x, lx])
    all_logl = np.concatenate([dead_logl, ll])
    all_lv = np.concatenate([dead_lv, lv_live])
    # own live-count schedule: within each kill batch the count decays
    # nlive, ..., nlive-K+1; the final unwind decays nlive..1
    sched_dead = np.tile(nlive - np.arange(K), n_dead // K)[:n_dead]
    sched_live = nlive - np.arange(nlive)
    schedule = np.concatenate([sched_dead, sched_live]).astype(float)

    if calls >= maxcall and warn_truncation:
        log.warning(
            f"NS terminated on maxcall={maxcall} before reaching dlogz="
            f"{dlogz} (n_iter={n_iter}); logZ is truncated low — raise "
            "maxcall (samplers.nested_sampling scales it automatically)")
    elif n_dead + K > max_dead and warn_truncation:
        delta_end = float(np.logaddexp(logz, np.max(live_logl) + logvol) - logz)
        if delta_end > dlogz:
            log.warning(
                f"NS terminated on the max_dead={max_dead} buffer before "
                f"reaching dlogz={dlogz} (n_iter={n_iter}, remaining "
                f"delta={delta_end:.3g}); logZ is truncated low — pass a "
                "larger max_dead")
    success = bool(n_dead > 0 and not np.all(all_logl == all_logl[0]))
    return NSResult(all_x, all_logl, all_lv, logz, calls, n_iter, nlive,
                    success, schedule, float(logvol0), n_inner)


def merge_runs(runs, logvol0: float = 0.0):
    """Merge NS runs with dynesty's varying-live-count combine.

    runs: list of (dead_x, dead_logl, nlive_schedule, logl_bound), where
    nlive_schedule[i] is the run's own live count at its i-th death and
    logl_bound is -inf for a full run. At the i-th merged death the combined
    live count is n_i = sum_r [L_i >= bound_r] * alive_r(L_i), and volumes
    shrink as logvol_i = logvol0 + sum_{k<=i} log(n_k / (n_k + 1)).

    Returns (x, logl, logvol, n_at_death) sorted by ascending likelihood.
    """
    xs = np.concatenate([r[0] for r in runs], axis=0)
    logls = np.concatenate([r[1] for r in runs], axis=0)
    order = np.argsort(logls, kind="stable")
    xs, logls = xs[order], logls[order]

    n_at_death = np.zeros(logls.shape[0])
    for dead_x, dead_logl, schedule, bound in runs:
        o = np.argsort(dead_logl, kind="stable")
        sorted_l = dead_logl[o]
        sorted_n = np.asarray(schedule, dtype=float)[o]
        idx = np.searchsorted(sorted_l, logls, side="left")
        alive = np.where(idx < len(sorted_l),
                         sorted_n[np.minimum(idx, len(sorted_l) - 1)], 0.0)
        alive = np.where(logls >= bound, alive, 0.0)
        n_at_death += alive
    n_at_death = np.maximum(n_at_death, 1.0)

    logvol = logvol0 + np.cumsum(np.log(n_at_death / (n_at_death + 1.0)))
    return xs, logls, logvol, n_at_death


def _decorrelate(loglike_fn, gen, x0, l0, lstar, n_repeats: int,
                 max_shrink: int, spec: int):
    """Constrained slice sampling of every point (n_repeats updates each,
    above ``lstar``): turns volume-weighted resamples of dead points into
    fresh draws before a dynamic batch, since duplicated deaths would
    shrink the merged volume schedule twice. Directions come from the
    evolving points' covariance, refreshed every iteration. Returns (x,
    logl, n_evals (device), iterations)."""
    n, d = x0.shape

    def draw_dirs(x):
        z = torch.randn((n, d), generator=gen, dtype=x.dtype, device=x.device)
        return z @ _live_cov_chol(x).T

    return _slice_lanes(loglike_fn, gen, x0, l0, lstar, n_repeats,
                        max_shrink, spec, draw_dirs)


def _batch_seed_probs(logvol, above, logvol0: float) -> np.ndarray:
    """Volume-shell weights for seeding a dynamic batch from the base run's
    dead points above the bound. The first shell starts at the crossing
    volume, the ledger value of the last death below the bound (the run's
    initial volume ``logvol0`` when none is below)."""
    lv = logvol[above]
    crossing = float(np.min(logvol[~above], initial=logvol0))
    lv_prev = np.concatenate([[crossing], lv[:-1]])
    dvol = np.exp(lv_prev) - np.exp(lv)
    dvol = np.clip(dvol, 1e-300, None)
    return dvol / dvol.sum()


def run_nested_dynamic(loglike_apply: Callable, ctx, d: int,
                       generator: torch.Generator, nlive: int = 500,
                       dlogz: float = 0.01, maxcall: int = int(5e6),
                       batch_frac: float = 1.0, wt_threshold: float = 0.01,
                       live_x=None, live_logl=None, rng=None,
                       logvol0: float = 0.0, **ns_kwargs) -> NSResult:
    """Dynamic nested sampling: a static base run, then a batch of
    ``batch_frac * nlive`` live points devoted to the likelihood range whose
    importance weight exceeds ``wt_threshold`` of the peak, merged with the
    base run by the varying-live-count schedule (:func:`merge_runs`). The
    batch is seeded by volume-weighted resampling of the base run's dead
    points above the bound (``rng``), decorrelated first."""
    rng = rng if rng is not None else np.random.default_rng()
    g_base, g_batch, g_dec = split_generator(generator, 3)
    base = run_nested(loglike_apply, ctx, d, g_base, nlive=nlive, dlogz=dlogz,
                      maxcall=maxcall, live_x=live_x, live_logl=live_logl,
                      rng=rng, logvol0=logvol0, **ns_kwargs)
    if not base.success:
        return base

    # the posterior bulk's lower bound: the first dead point whose weight
    # exceeds wt_threshold of the largest
    logwt = integrals.logwt_from(base.dead_logl, base.logvol,
                                 lv_start=base.logvol0)
    keep = logwt >= logwt.max() + np.log(wt_threshold)
    l_lo = float(base.dead_logl[np.argmax(keep)])

    nlive_batch = max(8, int(round(batch_frac * nlive)))
    above = base.dead_logl > l_lo
    if above.sum() < 2:
        return base
    p = _batch_seed_probs(base.logvol, above, base.logvol0)
    pick = rng.choice(np.sum(above), size=nlive_batch, replace=True, p=p)
    dt, dev = config.DTYPE, generator.device
    bx = torch.as_tensor(base.dead_x[above][pick], dtype=dt, device=dev)
    bl = torch.as_tensor(base.dead_logl[above][pick], dtype=dt, device=dev)
    # the decorrelation depth is the runs' slice depth
    n_rep = ns_kwargs.get("n_repeats") or max(3, int(math.ceil(1.5 * d)))
    bx, bl, dec_calls, dec_iter = _decorrelate(
        _loglike_fn(loglike_apply, ctx, ns_kwargs.get("mesh")), g_dec, bx, bl,
        torch.tensor(l_lo, dtype=dt, device=dev), int(n_rep), 40,
        _resolve_spec(ns_kwargs.get("spec"), d))

    batch = run_nested(loglike_apply, ctx, d, g_batch, nlive=nlive_batch,
                       dlogz=dlogz, maxcall=maxcall, live_x=bx, live_logl=bl,
                       rng=rng, **ns_kwargs)

    xs, logls, logvol, sched = merge_runs([
        (base.dead_x, base.dead_logl, base.nlive_schedule, -np.inf),
        (batch.dead_x, batch.dead_logl, batch.nlive_schedule, l_lo),
    ], logvol0=logvol0)
    from scipy.special import logsumexp

    logz = float(logsumexp(integrals.logwt_from(logls, logvol,
                                                lv_start=logvol0)))
    return NSResult(xs, logls, logvol, logz,
                    base.n_calls + batch.n_calls + int(dec_calls),
                    base.n_iter + batch.n_iter, base.nlive + batch.nlive,
                    bool(base.success and batch.success), sched,
                    float(logvol0), base.n_inner + batch.n_inner + dec_iter)
