"""Bounded multi-restart minimization: batched lockstep L-BFGS or adam, and
host scipy L-BFGS-B restarts.

Every restart is a lane of one batched optimizer: each iteration evaluates
the objective of all R lanes in one batched call (one batched Cholesky for
the GP MLL). The loop is a host loop over batched tensor ops; it stops when
no lane is active or at ``maxiter``.

The algorithm is the JAX package's, step for step (there ``optax``'s
``scale_by_lbfgs`` -> ``scale(-1)`` -> ``scale_by_backtracking_linesearch``
chain, here written out by hand):

* box constraints through the sigmoid reparametrisation
  ``x = lo + (hi - lo) * sigmoid(z)``, with the z-clip inside the objective;
* L-BFGS direction, memory 10, with the first step's scale capped at
  ``1 / |g|``;
* backtracking (Armijo) line search starting at ``min(1.5 * lr_prev, 1)``,
  shrinking by 0.45 for at most 3 further trials, value-only trials, and a
  zero step when every trial was non-finite;
* per-lane retirement: patience on relative-ftol improvement, a gradient
  norm below ``gtol``, or a non-finite value.

As in the JAX version every lane computes a step every iteration; a retired
lane's optimizer state is frozen, so it can record at most one further
improvement of its best value.

``method="adam"`` runs the same lockstep loop with optax's adam update in
place of the L-BFGS step (b1 0.9, b2 0.999, eps 1e-8, learning rate 1e-2).
:func:`minimize_scipy_restarts` drives scipy's L-BFGS-B from each restart
on the host (a thread per restart where the host has cores), the value and
gradient of each evaluation computed on the objective's device.
"""
from __future__ import annotations

import os
from typing import Callable, Tuple

import numpy as np
import torch

from ..utils import trace
from ..utils.log import get_logger

log = get_logger("optim")

_Z_CLIP = 16.0
_MEMORY = 10


def setup_bounds(bounds, num_params, dtype=torch.float64, device=None):
    """Normalize bounds to a (2, num_params) tensor (or None)."""
    if bounds is None:
        return None
    bounds = torch.as_tensor(bounds, dtype=dtype, device=device)
    if bounds.shape == (2,):
        bounds = bounds[:, None].expand(2, num_params).contiguous()
    elif bounds.shape != (2, num_params):
        raise ValueError(f"Bounds shape {tuple(bounds.shape)} incompatible "
                         f"with {num_params} params")
    return bounds


def _to_z(x, bounds):
    u = (x - bounds[0]) / (bounds[1] - bounds[0])
    u = torch.clamp(u, 1e-7, 1.0 - 1e-7)
    return torch.clamp(torch.log(u) - torch.log1p(-u), -_Z_CLIP, _Z_CLIP)


def _to_x(z, bounds):
    return bounds[0] + (bounds[1] - bounds[0]) * torch.sigmoid(z)


def _lbfgs_direction(g, z, st):
    """optax.scale_by_lbfgs update for every lane; returns P g and updates
    the lane states in a new dict (the caller freezes retired lanes)."""
    R, p = z.shape
    m = _MEMORY
    count = st["count"]
    mem_idx = count % m
    prev_idx = (count - 1) % m
    first = (count == 0)
    dp = z - st["params"]
    du = g - st["updates"]
    vdot = torch.sum(du * dp, dim=1)
    weight = torch.where(vdot == 0.0, torch.zeros_like(vdot), 1.0 / vdot)
    dp = torch.where(first[:, None], torch.zeros_like(dp), dp)
    du = torch.where(first[:, None], torch.zeros_like(du), du)
    weight = torch.where(first, torch.zeros_like(weight), weight)
    lanes = torch.arange(R, device=z.device)
    dpm = st["dpm"].clone()
    dum = st["dum"].clone()
    wm = st["wm"].clone()
    dpm[lanes, prev_idx] = dp
    dum[lanes, prev_idx] = du
    wm[lanes, prev_idx] = weight

    num = torch.sum(du * dp, dim=1)
    den = torch.sum(du * du, dim=1)
    scale = torch.where(den > 0.0, num / den, torch.ones_like(den))
    inv_norm = torch.clamp(1.0 / torch.linalg.norm(g, dim=1), max=1.0)
    scale = torch.where(first, inv_norm, scale)

    order = (mem_idx[:, None]
             + torch.arange(m, device=z.device)[None, :]) % m  # (R, m)
    dpo = torch.take_along_dim(dpm, order[:, :, None], dim=1)
    duo = torch.take_along_dim(dum, order[:, :, None], dim=1)
    rho = torch.take_along_dim(wm, order, dim=1)
    vec = g
    alphas = [None] * m
    for t in reversed(range(m)):
        a = rho[:, t] * torch.sum(dpo[:, t] * vec, dim=1)
        vec = vec - a[:, None] * duo[:, t]
        alphas[t] = a
    vec = scale[:, None] * vec
    for t in range(m):
        b = rho[:, t] * torch.sum(duo[:, t] * vec, dim=1)
        vec = vec + (alphas[t] - b)[:, None] * dpo[:, t]
    new = dict(st, count=count + 1, params=z, updates=g, dpm=dpm, dum=dum,
               wm=wm)
    return vec, new


def _backtracking(obj, z, u, value, grad, lr_prev, max_steps: int,
                  decrease_factor: float, slope_rtol: float = 1e-4):
    """optax.scale_by_backtracking_linesearch (atol = rtol = 0,
    increase_factor 1.5, max learning rate 1, value-only trials) for every
    lane. Returns (step, new_lr)."""
    slope = torch.sum(u * grad, dim=1)
    lr = torch.clamp(1.5 * lr_prev, max=1.0)
    dec = torch.full_like(value, float("inf"))
    it = torch.zeros_like(value, dtype=torch.int64)
    for k in range(max_steps + 1):
        searching = ~(dec <= 0.0) & (it <= max_steps)
        if not bool(searching.any()):
            break
        trial_lr = lr * decrease_factor if k > 0 else lr
        with torch.no_grad():
            new_value = obj(z + trial_lr[:, None] * u)
        d = new_value - value - trial_lr * slope_rtol * slope
        d = torch.where(torch.isnan(d), torch.full_like(d, float("inf")), d)
        d = torch.clamp(d, min=0.0)
        lr = torch.where(searching, trial_lr, lr)
        dec = torch.where(searching, d, dec)
        it = it + searching.to(it.dtype)
    new_lr = torch.where(torch.isinf(dec), torch.zeros_like(lr), lr)
    return new_lr[:, None] * u, new_lr


def _adam_step(g, st, learning_rate, b1=0.9, b2=0.999, eps=1e-8):
    """optax.adam's update for every lane: returns the step and the new
    moments in a new dict (the caller freezes retired lanes)."""
    mu = (1.0 - b1) * g + b1 * st["mu"]
    nu = (1.0 - b2) * (g * g) + b2 * st["nu"]
    count = st["count"] + 1
    t = count.to(g.dtype)[:, None]
    mu_hat = mu / (1.0 - b1 ** t)
    nu_hat = nu / (1.0 - b2 ** t)
    step = -learning_rate * (mu_hat / (torch.sqrt(nu_hat) + eps))
    return step, dict(st, mu=mu, nu=nu, count=count)


def minimize_restarts(
    fun: Callable,
    x0: torch.Tensor,
    bounds=None,
    method: str = "lbfgs",
    maxiter: int = 200,
    patience: int = 5,
    learning_rate: float = 1e-2,
    gtol: float = 1e-6,
    ftol: float = 1e-9,
    decrease_factor: float = 0.45,
    max_backtracking_steps: int = 3,
    return_all: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Minimize ``fun`` from each row of x0 (R, p); returns (best_x, best_f).

    ``fun`` maps a batch (R, p) to values (R,) and must be differentiable
    with autograd. ``method``: 'lbfgs' or 'adam' (``learning_rate``). With
    ``return_all=True`` returns every restart's endpoint (x_all (R, p),
    f_all (R,)) instead.
    """
    if method not in ("lbfgs", "adam"):
        raise ValueError(f"Unknown device optimizer '{method}' (expected "
                         "'lbfgs' or 'adam')")
    x0 = torch.atleast_2d(x0)
    R, p = x0.shape
    dev, dt = x0.device, x0.dtype
    bounds_arr = setup_bounds(bounds, p, dtype=dt, device=dev)
    if bounds_arr is not None:
        z0 = _to_z(x0, bounds_arr)
        to_x = lambda z: _to_x(torch.clamp(z, -_Z_CLIP, _Z_CLIP), bounds_arr)
    else:
        z0 = x0
        to_x = lambda z: z

    def obj(z):
        # every objective call counts on the open span (gp.fit, acq.refine)
        trace.count("evals")
        return fun(to_x(z))

    def vg(z):
        with torch.enable_grad():
            zz = z.detach().requires_grad_(True)
            v = obj(zz)
            (g,) = torch.autograd.grad(v.sum(), zz)
        return v.detach(), g.detach()

    v0, g0 = vg(z0)
    ok = torch.isfinite(v0)
    c = dict(
        z=z0, val=v0, grad=g0, best_v=torch.where(ok, v0, torch.full_like(v0, float("inf"))),
        best_z=z0, pat=torch.full((R,), patience, dtype=torch.int64, device=dev),
        active=ok,
    )
    if method == "lbfgs":
        st = dict(count=torch.zeros(R, dtype=torch.int64, device=dev),
                  params=torch.zeros_like(z0), updates=torch.zeros_like(z0),
                  dpm=torch.zeros((R, _MEMORY, p), dtype=dt, device=dev),
                  dum=torch.zeros((R, _MEMORY, p), dtype=dt, device=dev),
                  wm=torch.zeros((R, _MEMORY), dtype=dt, device=dev),
                  lr=torch.ones(R, dtype=dt, device=dev))
    else:
        st = dict(count=torch.zeros(R, dtype=torch.int64, device=dev),
                  mu=torch.zeros_like(z0), nu=torch.zeros_like(z0))

    it = 0
    while it < maxiter and bool(c["active"].any()):
        if method == "lbfgs":
            direction, new_st = _lbfgs_direction(c["grad"], c["z"], st)
            step, new_lr = _backtracking(obj, c["z"], -direction, c["val"],
                                         c["grad"], st["lr"],
                                         max_backtracking_steps,
                                         decrease_factor)
            new_st["lr"] = new_lr
        else:
            step, new_st = _adam_step(c["grad"], st, learning_rate)
        z_new = c["z"] + step
        v_new, g_new = vg(z_new)
        ok = torch.isfinite(v_new)
        meaningful = ftol * (torch.abs(c["best_v"]) + torch.abs(v_new) + 1e-12)
        better = ok & (v_new < c["best_v"])
        improved = ok & (v_new < c["best_v"] - meaningful)
        act = c["active"]
        small_grad = torch.linalg.norm(g_new, dim=1) < gtol
        pat = torch.where(improved, torch.full_like(c["pat"], patience),
                          c["pat"] - 1)
        take = act & ok
        c = dict(
            z=torch.where(act[:, None], z_new, c["z"]),
            val=torch.where(take, v_new, c["val"]),
            grad=torch.where(take[:, None], g_new, c["grad"]),
            best_v=torch.where(better, v_new, c["best_v"]),
            best_z=torch.where(better[:, None], z_new, c["best_z"]),
            pat=pat,
            active=act & ok & (pat > 0) & ~small_grad,
        )
        st = {k: torch.where(act.view((R,) + (1,) * (v.dim() - 1)), new_st[k], v)
              for k, v in st.items()}
        it += 1
    log.debug(f"lockstep {method}: {it} iterations over {R} lanes")

    best_z, best_v = c["best_z"], c["best_v"]
    z_all = torch.clamp(best_z, -_Z_CLIP, _Z_CLIP)
    x_all = _to_x(z_all, bounds_arr) if bounds_arr is not None else best_z
    if return_all:
        return x_all, best_v
    i = int(torch.argmin(best_v))
    return x_all[i], best_v[i]


def minimize_scipy_restarts(fun: Callable, x0, bounds=None, maxiter: int = 200,
                            return_all: bool = False):
    """Host scipy L-BFGS-B from each row of x0 (R, p), the restarts on a
    thread pool where the host has cores to spare. ``fun`` maps a batch
    (R, p) on its device to values (R,) and is differentiated with
    autograd one point at a time. Returns (best_x, best_f) as tensors on
    x0's device; with ``return_all`` also the numpy endpoints
    (all_x (R', p), all_f (R',)) of the restarts whose objective was
    finite. The starting points compete too. Raises when every restart
    failed."""
    from scipy.optimize import minimize as sp_minimize

    x0_t = torch.atleast_2d(torch.as_tensor(x0))
    dev, dt = x0_t.device, x0_t.dtype
    x0 = np.atleast_2d(x0_t.detach().cpu().numpy().astype(np.float64))
    R, p = x0.shape
    bounds_arr = setup_bounds(bounds, p)
    scipy_bounds = (None if bounds_arr is None else
                    [(float(bounds_arr[0, i]), float(bounds_arr[1, i]))
                     for i in range(p)])

    def f_np(x):
        with torch.enable_grad():
            z = torch.as_tensor(x, dtype=dt, device=dev)[None, :]
            z.requires_grad_(True)
            v = fun(z)[0]
            (g,) = torch.autograd.grad(v, z)
        return float(v.detach()), g[0].detach().cpu().numpy().astype(np.float64)

    def one_restart(xi):
        try:
            return sp_minimize(f_np, xi, jac=True, method="L-BFGS-B",
                               bounds=scipy_bounds,
                               options={"maxiter": maxiter})
        except Exception:
            return None

    best_f, best_x = np.inf, None
    for xi in x0:
        v, _ = f_np(xi)
        if np.isfinite(v) and v < best_f:
            best_f, best_x = v, xi

    workers = min(len(x0), os.cpu_count() or 1)
    if workers > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=workers) as ex:
            outcomes = list(ex.map(one_restart, x0))
    else:
        outcomes = [one_restart(xi) for xi in x0]
    all_x, all_f = [], []
    for i, res in enumerate(outcomes):
        if res is None:
            log.warning(f"scipy restart {i} raised (skipped)")
            continue
        # any finite endpoint competes: res.fun is the objective at res.x,
        # also after an "ABNORMAL" line-search end near an optimum
        if np.isfinite(res.fun):
            all_x.append(np.asarray(res.x, dtype=np.float64))
            all_f.append(float(res.fun))
            if res.fun < best_f:
                best_f, best_x = float(res.fun), res.x
    if best_x is None:
        raise RuntimeError(
            "every optimizer restart failed (objective non-finite at all "
            "initial points and no scipy run succeeded)")
    best = (torch.as_tensor(np.asarray(best_x), dtype=dt, device=dev),
            torch.as_tensor(best_f, dtype=dt, device=dev))
    if return_all:
        return best + (np.asarray(all_x), np.asarray(all_f))
    return best
