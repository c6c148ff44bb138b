"""The synthetic planck-like likelihood, with its analytic evidence: frozen
numpy copies of ``make_planck_like`` and ``planck_like_ref_draws`` of
``bobe_tpu_torch/models/toys.py``, kept fixed while the program changes.
Nothing here imports the program.

A toy is found by its name (a configuration's ``likelihood.toy``): the module
``benchmark/toys/<toy>.py`` and its ``make(spec)``.
"""
from __future__ import annotations

import numpy as np


def make_planck_like(d=6, alpha=0.5, gamma=0.4, delta=0.3, c_fail=2.5):
    """Synthetic "planck-like" likelihood with ANALYTIC logZ: curved
    degeneracies (unit-Jacobian shears of z = (x - mu) / sigma) and a hard
    failure region u1 > c_fail that raises RuntimeError, as a Boltzmann code
    fails. logZ = log Phi(c_fail) - log V_prior. Returns (loglike, bounds,
    names, logz_true)."""
    from scipy.stats import norm

    assert d >= 6
    mu = np.array([0.32, 0.05, 0.68, 0.97, 3.05, 0.81] + [0.5] * (d - 6))[:d]
    sigma = np.array([0.011, 0.008, 0.012, 0.004, 0.015, 0.006]
                     + [0.01] * (d - 6))[:d]
    zspan = np.full(d, 10.0)
    zspan[1] = 10.0 * np.sqrt(1 + 2 * alpha**2) + 10.0 * abs(alpha)
    zspan[3] = 10.0 * np.sqrt(1 + 2 * gamma**2) + 10.0 * abs(gamma)
    zspan[4] = 10.0 * np.sqrt(1 + delta**2) + 10.0 * abs(delta)
    lo = mu - zspan * sigma
    hi = mu + zspan * sigma
    bounds = np.vstack([lo, hi])
    names = ["omegam", "omegab", "h", "ns", "logA", "sigma8"][:d] + [
        f"x_{j}" for j in range(6, d)]
    log_v = float(np.sum(np.log(hi - lo)))
    const = -0.5 * d * np.log(2 * np.pi) - float(np.sum(np.log(sigma)))

    def _warp(z):
        u = np.array(z, dtype=float, copy=True)
        u[1] = z[1] + alpha * (z[0] ** 2 - 1.0)
        u[3] = z[3] + gamma * (z[2] ** 2 - 1.0)
        u[4] = z[4] + delta * z[0] * z[2]
        return u

    def loglike(x):
        z = (np.asarray(x, dtype=float) - mu) / sigma
        u = _warp(z)
        if u[1] > c_fail:
            raise RuntimeError("synthetic theory code failed (u1 beyond cut)")
        return float(-0.5 * np.sum(u * u) + const)

    def unwarp(u):
        z = np.array(u, dtype=float, copy=True)
        z[1] = u[1] - alpha * (u[0] ** 2 - 1.0)
        z[3] = u[3] - gamma * (u[2] ** 2 - 1.0)
        z[4] = u[4] - delta * u[0] * u[2]
        return mu + sigma * z

    logz_true = float(np.log(norm.cdf(c_fail)) - log_v)
    loglike.unwarp = unwarp
    loglike.c_fail = c_fail
    return loglike, bounds, names, logz_true


def planck_like_ref_draws(loglike, bounds, n, rng=None, width=2.0,
                          minus_inf=-1e10):
    """Draws from a broadened posterior-shaped reference distribution (the
    analogue of a Cobaya YAML's ``ref`` dists). Returns (X (n, d), y (n,)),
    failures at ``minus_inf``."""
    rng = rng if rng is not None else np.random.default_rng()
    d = bounds.shape[1]
    X, y = [], []
    while len(X) < n:
        u = width * rng.standard_normal(d)
        x = loglike.unwarp(u)
        if np.any(x < bounds[0]) or np.any(x > bounds[1]):
            continue
        try:
            v = loglike(x)
        except RuntimeError:
            v = minus_inf
        X.append(x), y.append(v)
    return np.asarray(X), np.asarray(y)


def make(spec):
    """(loglike, bounds, names, logz_true, draws) of {"toy": "planck_like",
    "d"}."""
    loglike, bounds, names, logz = make_planck_like(d=int(spec["d"]))
    return loglike, bounds, names, logz, planck_like_ref_draws
