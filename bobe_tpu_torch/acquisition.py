"""Acquisition functions: EI / LogEI and the evidence-weighted WIPV / WIPStd.

Counterpart of ``bobe_tpu/acquisition.py`` (same classes and methods):

* EI/LogEI restarts are lanes of one lockstep L-BFGS on the unit cube
  (half from random points, classifier-aware for a gated GP, half from the
  incumbent, all jittered);
* the WIP sweep over the MC pool is one batched computation
  (ops/fantasy.wip_sweep): one triangular solve and one matrix product for
  all candidates, split over the devices of the production mesh when there
  is one (parallel/mesh.py);
* the best pool candidate is polished by batched L-BFGS on the fantasy
  variance below ``REFINE_MAX_N`` GP points;
* a batch is chosen greedily: by GP-mean hallucination below
  ``REFINE_MAX_N``, by rank-1 downdates of the pool covariance above it.

Under the GP's input warp the kernel math runs in warp space; the points
the functions return stay raw.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from . import config
from .models import gp as gpm
from .ops import optimize as opt_ops
from .ops.special import ei_helper, log_ei_helper
from .ops.fantasy import (
    fantasy_var_single,
    posterior_batch,
    wip_greedy_batch,
    wip_sweep,
)
from .parallel.mesh import (production_mesh, sharded_posterior,
                            sharded_posterior_cov, sharded_wip_core)
from .utils import trace
from .utils.log import get_logger
from .utils.seed import get_numpy_rng

log = get_logger("acq")

# local refinement of pool candidates is skipped above this GP size; the
# fused single-dispatch greedy batch applies in the same regime
REFINE_MAX_N = 500


def _ei_objective_core(gp, x0, best_y: float, zeta: float, use_log: bool,
                       maxiter: int):
    """Minimize -EI (or -logEI) from each restart x0 (R, d) as lanes of one
    bounded L-BFGS on the unit cube. Returns (best_x (d,), best_f)."""
    st, cfg = gp.state, gp.cfg
    floor = 1e-18 if use_log else 1e-20

    def neg_ei(X):
        mean, var = gpm.predict_raw(st, cfg, X)
        sigma = torch.sqrt(torch.clamp(var, min=floor))
        u = (mean - zeta - best_y) / sigma
        if use_log:
            return -(log_ei_helper(u) + torch.log(sigma))
        return -(ei_helper(u) * sigma)

    return opt_ops.minimize_restarts(neg_ei, x0, bounds=(0.0, 1.0),
                                     method="lbfgs", maxiter=maxiter)


def _wip_sweep_core(gp, mc_points, use_std: bool, mesh=None):
    """Full-pool WIP sweep in warp space (the identity unless the GP warps
    its inputs). Returns (acq_vals, V, var). With a ``mesh`` the pool is
    split over its devices (parallel/mesh.py)."""
    if mesh is not None:
        return sharded_wip_core(gp, mc_points, use_std, mesh)
    st, cfg = gp.state, gp.cfg
    ls, amp = torch.exp(st.log_ls), torch.exp(st.log_amp)
    mc_w = gpm.query_coords(st, cfg, mc_points)
    V, var = posterior_batch(cfg.kernel, gpm.train_coords(st, cfg), st.mask(),
                             st.chol, mc_w, ls, amp, cfg.noise)
    acq = wip_sweep(cfg.kernel, mc_w, V, var, ls, amp, cfg.noise,
                    st.y_std, use_std)
    return acq, V, var


def _wip_batch_core(gp, mc_points, use_std: bool, n_batch: int, mesh=None):
    """Fused greedy batch: posterior solve + n_batch rank-1 downdate
    selections, in warp space; the points returned are raw (the likelihood
    evaluates them). With a ``mesh`` the posterior solve and the pool
    covariance are split over its devices and the selection runs on the
    GP's."""
    st, cfg = gp.state, gp.cfg
    ls, amp = torch.exp(st.log_ls), torch.exp(st.log_amp)
    C = None
    if mesh is not None:
        mc_w, V, var, n = sharded_posterior(gp, mc_points, mesh)
        C = sharded_posterior_cov(gp, mc_w, V, var, mesh)[:n, :n]
        mc_w, V, var = mc_w[:n], V[:, :n], var[:n]
    else:
        mc_w = gpm.query_coords(st, cfg, mc_points)
        V, var = posterior_batch(cfg.kernel, gpm.train_coords(st, cfg),
                                 st.mask(), st.chol, mc_w, ls, amp, cfg.noise)
    idx, vals = wip_greedy_batch(cfg.kernel, mc_w, V, var, ls, amp,
                                 cfg.noise, st.y_std, use_std, n_batch, C=C)
    return mc_points[idx], vals


def _wip_refine_core(gp, x0, mc_points, V, var, use_std: bool, maxiter: int):
    """Local polish of the best pool candidate by L-BFGS on the fantasy
    variance (differentiated through with autograd). V, var and the
    Cholesky factor live in warp space, so the candidate is warped too; the
    optimization variable stays raw and the warp is differentiated."""
    st, cfg = gp.state, gp.cfg
    ls, amp = torch.exp(st.log_ls), torch.exp(st.log_amp)
    mask = st.mask()
    x_tr = gpm.train_coords(st, cfg)
    mc_w = gpm.query_coords(st, cfg, mc_points)

    def objective(x):
        x_w = gpm.query_coords(st, cfg, x[None, :])[0]
        fv = fantasy_var_single(cfg.kernel, x_tr, mask, st.chol, x_w,
                                mc_w, V, var, ls, amp, cfg.noise)
        if use_std:
            return torch.mean(torch.sqrt(fv)) * st.y_std
        return torch.mean(fv) * st.y_std**2

    obj = lambda X: torch.stack([objective(x) for x in X])
    return opt_ops.minimize_restarts(obj, x0, bounds=(0.0, 1.0),
                                     method="lbfgs", maxiter=maxiter)


# ======================================================================
# Acquisition classes
# ======================================================================

class AcquisitionFunction:
    """Base class; subclasses implement fun() and get_next_point()."""

    name: str = "BaseAcquisitionFunction"

    def __init__(self, optimizer: str = "lbfgs",
                 optimizer_options: Optional[Dict[str, Any]] = None):
        self.optimizer = optimizer
        self.optimizer_options = dict(optimizer_options or {})

    def fun(self, x, gp, **kwargs):
        raise NotImplementedError

    def get_next_point(self, gp, acq_kwargs=None, maxiter=500, n_restarts=8,
                       verbose=True, early_stop_patience=25, rng=None):
        raise NotImplementedError

    def get_next_batch(self, gp, n_batch: int = 1, acq_kwargs=None,
                       maxiter: int = 500, n_restarts: int = 8,
                       verbose: bool = True, early_stop_patience: int = 25,
                       rng=None) -> Tuple[np.ndarray, np.ndarray]:
        """Greedy batch via GP-mean hallucination: after each pick, a
        private copy of the GP is updated with the GP mean at the pick."""
        rng = rng if rng is not None else get_numpy_rng()
        acq_kwargs = dict(acq_kwargs or {})

        x_next, v_next = self.get_next_point(
            gp, acq_kwargs=acq_kwargs, maxiter=maxiter, n_restarts=n_restarts,
            verbose=verbose, early_stop_patience=early_stop_patience, rng=rng)
        x_batch, acq_vals = [np.asarray(x_next)], [float(v_next)]

        if n_batch > 1:
            with trace.span("acq.hallucinate"):
                dummy = gpm.GP.dummy_like(gp)
                mu = dummy.predict_mean_single(x_next)
                dummy.update(np.asarray(x_next)[None, :], mu[None])
            for _ in range(1, n_batch):
                x_next, v_next = self.get_next_point(
                    dummy, acq_kwargs=acq_kwargs, maxiter=maxiter,
                    n_restarts=n_restarts, verbose=verbose,
                    early_stop_patience=early_stop_patience, rng=rng)
                x_batch.append(np.asarray(x_next))
                acq_vals.append(float(v_next))
                with trace.span("acq.hallucinate"):
                    mu = dummy.predict_mean_single(x_next)
                    dummy.update(np.asarray(x_next)[None, :], mu[None])

        return np.array(x_batch), np.array(acq_vals)


class EI(AcquisitionFunction):
    """Expected Improvement: EI(x) = E[max(f(x) - best - zeta, 0)]."""

    name = "EI"
    _use_log = False

    def fun(self, x, gp, best_y, zeta):
        mean, var = gp.predict_single(x)
        sigma = torch.sqrt(torch.clamp(var, min=1e-20))
        u = (mean - zeta - best_y) / sigma
        return (-(ei_helper(u) * sigma)).reshape(())

    def get_next_point(self, gp, acq_kwargs=None, maxiter=250, n_restarts=20,
                       verbose=True, early_stop_patience=25, rng=None):
        rng = rng if rng is not None else get_numpy_rng()
        acq_kwargs = dict(acq_kwargs or {})
        zeta = float(acq_kwargs.get("zeta", 0.0))
        train_y = gp.train_y.reshape(-1).cpu().numpy()
        best_y = acq_kwargs.get("best_y")
        if best_y is None:
            best_y = float(train_y.max()) if gp.npoints > 0 else 0.0
        best_x = gp.train_x[int(np.argmax(train_y))].cpu().numpy()

        # restart seeding: half random (classifier-aware for a gated GP),
        # half the incumbent, all jittered
        if n_restarts > 1:
            n_rand = n_restarts // 2
            x0 = np.vstack([gp.get_random_point(rng, nstd=5)
                            for _ in range(n_rand)])
            x0 = np.vstack([x0, np.tile(best_x, (n_restarts - n_rand, 1))])
        else:
            x0 = best_x[None, :]
        x0 = np.clip(x0 + rng.normal(0.0, 0.005, size=x0.shape), 0.0, 1.0)

        x, f = _ei_objective_core(
            gp, torch.as_tensor(x0, dtype=config.DTYPE, device=gp.device),
            float(best_y), zeta, self._use_log, int(maxiter))
        return x.cpu().numpy(), -float(f)


class LogEI(EI):
    """Log Expected Improvement (Ament et al. 2023, arXiv:2310.20708)."""

    name = "LogEI"
    _use_log = True

    def fun(self, x, gp, best_y, zeta):
        mean, var = gp.predict_single(x)
        sigma = torch.sqrt(torch.clamp(var, min=1e-18))
        u = (mean - zeta - best_y) / sigma
        return (-(log_ei_helper(u) + torch.log(sigma))).reshape(())


class WeightedIntegratedPosteriorBase(AcquisitionFunction):
    """Shared machinery for WIPV / WIPStd."""

    _use_std = False

    def get_next_batch(self, gp, n_batch: int = 1, acq_kwargs=None,
                       maxiter: int = 500, n_restarts: int = 8,
                       verbose: bool = True, early_stop_patience: int = 25,
                       rng=None):
        """Greedy batch. Above REFINE_MAX_N points the whole batch is chosen
        in one fused pass by rank-1 downdates; below, by hallucination."""
        if n_batch <= 1 or gp.gp_size <= REFINE_MAX_N:
            return super().get_next_batch(
                gp, n_batch=n_batch, acq_kwargs=acq_kwargs, maxiter=maxiter,
                n_restarts=n_restarts, verbose=verbose,
                early_stop_patience=early_stop_patience, rng=rng)

        rng = rng if rng is not None else get_numpy_rng()
        acq_kwargs = dict(acq_kwargs or {})
        with trace.span("acq.mc_points"):
            mc_np = get_mc_points(acq_kwargs.get("mc_samples"),
                                  mc_points_size=int(acq_kwargs.get(
                                      "mc_points_size", 128)),
                                  rng=rng, gp=gp)
        mc_points = torch.as_tensor(mc_np, dtype=config.DTYPE,
                                    device=gp.device)
        with trace.span("acq.sweep"):
            pts, vals = _wip_batch_core(gp, mc_points, self._use_std,
                                        int(n_batch),
                                        production_mesh(gp.device))
            return pts.cpu().numpy(), vals.cpu().numpy()

    def fun(self, x, gp, mc_points=None, k_train_mc=None):
        fv = gp.fantasy_var(x, mc_points, k_train_mc)
        if self._use_std:
            return torch.mean(torch.sqrt(fv))
        return torch.mean(fv)

    def get_next_point(self, gp, acq_kwargs=None, maxiter=100, n_restarts=1,
                       verbose=True, early_stop_patience=25, rng=None):
        rng = rng if rng is not None else get_numpy_rng()
        acq_kwargs = dict(acq_kwargs or {})
        with trace.span("acq.pick"):
            return self._pick(gp, acq_kwargs, maxiter, rng)

    def _pick(self, gp, acq_kwargs, maxiter, rng):
        """The pool's best candidate by the WIP sweep, polished by L-BFGS
        below ``REFINE_MAX_N`` GP points."""
        with trace.span("acq.mc_points"):
            mc_np = np.asarray(get_mc_points(
                acq_kwargs.get("mc_samples"),
                mc_points_size=int(acq_kwargs.get("mc_points_size", 128)),
                rng=rng, gp=gp))
        mc_points = torch.as_tensor(mc_np, dtype=config.DTYPE,
                                    device=gp.device)
        with trace.span("acq.sweep"):
            acq_vals, V, var = _wip_sweep_core(gp, mc_points, self._use_std,
                                               production_mesh(gp.device))
            acq_np = acq_vals.cpu().numpy()
        i_best = int(np.argmin(acq_np))
        acq_min = float(acq_np[i_best])
        x0_np = mc_np[i_best]
        log.debug(f"{self.name} min over MC pool: {acq_min:.4e}")

        if gp.gp_size > REFINE_MAX_N:
            return x0_np, acq_min

        with trace.span("acq.refine", sync=True):
            x, f = _wip_refine_core(gp, mc_points[i_best][None, :],
                                    mc_points, V, var, self._use_std,
                                    int(maxiter))
            f = float(f)
        if f <= acq_min:
            return x.cpu().numpy(), f
        return x0_np, acq_min


class WIPV(WeightedIntegratedPosteriorBase):
    """Evidence-weighted integrated posterior *variance*."""

    name = "WIPV"
    _use_std = False


class WIPStd(WeightedIntegratedPosteriorBase):
    """Evidence-weighted integrated posterior *standard deviation*."""

    name = "WIPStd"
    _use_std = True


# ======================================================================
# MC sample sources
# ======================================================================

def get_mc_samples(gp, warmup_steps=None, num_samples=1024, thinning=None,
                   method="NUTS", num_chains=None, np_rng=None, generator=None,
                   warm_state=None):
    """MC samples of the GP surrogate posterior.

    'EHMC' -> the lockstep ensemble HMC (64 chains); 'NUTS' -> NUTS chains;
    'NS' -> batched nested sampling (acq settings); 'uniform' -> scrambled
    Sobol in the unit cube. ``warmup_steps`` / ``thinning`` / ``num_chains``
    left None take each sampler's own defaults (NUTS: dimension-scaled
    warmup, thinning 4, 4 chains; EHMC: 64 chains, a short cold warmup,
    thinning 2); explicit values reach whichever sampler runs.
    ``warm_state``: an earlier NUTS/EHMC call's adapted kernel."""
    if method == "EHMC":
        from .samplers import sample_gp_ensemble

        return sample_gp_ensemble(gp, num_samples=num_samples,
                                  num_chains=num_chains or 64,
                                  warmup_steps=warmup_steps,
                                  thinning=thinning, np_rng=np_rng,
                                  generator=generator, warm_state=warm_state)
    if method == "NUTS":
        from .samplers import sample_gp_nuts

        return sample_gp_nuts(gp, warmup_steps=warmup_steps,
                              num_samples=num_samples, thinning=thinning,
                              num_chains=num_chains or 4, np_rng=np_rng,
                              generator=generator, warm_state=warm_state)
    if method == "NS":
        from .samplers import nested_sampling

        samples, _, _ = nested_sampling(gp, mode="acq", dlogz=0.02,
                                        equal_weights=True, rng=np_rng,
                                        generator=generator)
        return samples
    if method == "uniform":
        from scipy.stats import qmc

        rng = np_rng if np_rng is not None else get_numpy_rng()
        pts = qmc.Sobol(gp.ndim, scramble=True, rng=rng).random(num_samples)
        return {"x": pts}
    raise ValueError(f"Unknown MC sample method '{method}'")


# Mode-balanced pool subsampling: valley depth (in log-posterior) below which
# two clusters count as the same mode.
MODE_VALLEY_DEPTH = 2.0


def kmeans(x: np.ndarray, k: int, n_init: int, seed: int, max_iter: int = 300,
           tol: float = 1e-4):
    """Seeded Lloyd k-means with k-means++ initialisation (best inertia of
    ``n_init`` runs). Returns (labels (n,), centers (k, d))."""
    rng = np.random.default_rng(seed)
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[0]
    # convergence threshold relative to the data scale, like scikit-learn
    tol_abs = tol * float(np.mean(np.var(x, axis=0)))
    best = None
    for _ in range(n_init):
        centers = np.empty((k, x.shape[1]))
        centers[0] = x[rng.integers(n)]
        d2 = np.sum((x - centers[0]) ** 2, axis=1)
        for c in range(1, k):
            total = d2.sum()
            i = (int(rng.choice(n, p=d2 / total)) if total > 0
                 else int(rng.integers(n)))
            centers[c] = x[i]
            d2 = np.minimum(d2, np.sum((x - centers[c]) ** 2, axis=1))
        for _ in range(max_iter):
            dist = np.sum((x[:, None, :] - centers[None, :, :]) ** 2, axis=2)
            labels = np.argmin(dist, axis=1)
            new = np.array([x[labels == c].mean(axis=0) if np.any(labels == c)
                            else centers[c] for c in range(k)])
            shift = float(np.sum((new - centers) ** 2))
            centers = new
            if shift <= tol_abs:
                break
        dist = np.sum((x[:, None, :] - centers[None, :, :]) ** 2, axis=2)
        labels = np.argmin(dist, axis=1)
        inertia = float(np.sum(np.min(dist, axis=1)))
        if best is None or inertia < best[0]:
            best = (inertia, labels, centers)
    return best[1], best[2]


def _mode_labels(gp, x, rng, max_modes: int = 8) -> np.ndarray:
    """Cluster the MC pool into posterior modes, merging clusters that are
    not separated by a deep log-density valley: k-means over-segments (k up
    to ``max_modes``), then two clusters merge when the GP mean at the
    midpoint of their centers is within MODE_VALLEY_DEPTH nats of the lower
    center."""
    n = x.shape[0]
    k = int(min(max_modes, max(1, n // 32)))
    if k <= 1:
        return np.zeros(n, dtype=int)
    labels, centers = kmeans(x, k, n_init=4,
                             seed=int(rng.integers(2**31 - 1)))

    pairs = [(i, j) for i in range(k) for j in range(i + 1, k)]
    mids = np.asarray([(centers[i] + centers[j]) / 2 for i, j in pairs])
    query = np.vstack([centers, mids])
    mean = gp.predict_mean_batched(query).cpu().numpy()
    c_mean, m_mean = mean[:k], mean[k:]

    parent = list(range(k))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for (i, j), mm in zip(pairs, m_mean):
        if mm >= min(c_mean[i], c_mean[j]) - MODE_VALLEY_DEPTH:
            parent[find(i)] = find(j)
    remap = {}
    merged = np.empty(n, dtype=int)
    for c in range(k):
        remap.setdefault(find(c), len(remap))
    for idx in range(n):
        merged[idx] = remap[find(labels[idx])]
    return merged


def _balanced_choice(labels, n_pick, rng) -> np.ndarray:
    """Indices of a per-mode balanced subsample: equal target share per mode
    (capped at mode occupancy), leftovers redistributed proportionally."""
    modes, counts = np.unique(labels, return_counts=True)
    C = len(modes)
    take = np.minimum(counts, n_pick // C)
    left = n_pick - int(take.sum())
    if left > 0:
        room = counts - take
        if room.sum() > 0:
            extra = np.floor(left * room / room.sum()).astype(int)
            take = np.minimum(counts, take + extra)
            for c in np.argsort(-(counts - take)):
                if take.sum() >= n_pick:
                    break
                if take[c] < counts[c]:
                    take[c] += 1
    idx = []
    for m, c, t in zip(modes, counts, take):
        members = np.flatnonzero(labels == m)
        idx.append(rng.choice(members, size=int(t), replace=False))
    return np.concatenate(idx)


def get_mc_points(mc_samples, mc_points_size=128, rng=None, gp=None):
    """Subsample the MC pool without replacement, stratified per posterior
    mode when ``gp`` is given. Labels are computed once per pool and cached
    on the mc_samples dict."""
    rng = rng if rng is not None else get_numpy_rng()
    x = np.asarray(mc_samples["x"])
    n = x.shape[0]
    if n <= mc_points_size:
        return x
    if gp is not None and isinstance(mc_samples, dict):
        labels = mc_samples.get("_mode_labels")
        if labels is None or len(labels) != n:
            labels = _mode_labels(gp, x, rng)
            mc_samples["_mode_labels"] = labels
        if labels.max() > 0:
            return x[_balanced_choice(labels, mc_points_size, rng)]
    idx = rng.choice(n, size=mc_points_size, replace=False)
    return x[idx]
