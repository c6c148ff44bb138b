"""Analytic toy likelihoods used across examples, tests and benchmarks.

Copied from bobe_tpu/models/toys.py. These mirror the example problems of
BOBE so logZ / posterior parity can be checked problem-by-problem. All functions
take a 1-D parameter vector (physical space) and return a scalar log-density;
``*_bounds`` give the matching prior boxes (2, d).
"""
from __future__ import annotations

import numpy as np


def banana(x):
    """Curved-degeneracy 2-D banana (reference examples/Banana.py:14-18)."""
    return -0.25 * (5.0 * (0.2 - x[0])) ** 2 - (20.0 * (x[1] / 4.0 - x[0] ** 4)) ** 2


banana_bounds = np.array([[-1.0, 1.0], [-1.0, 2.0]]).T
banana_names = ["x1", "x2"]


def himmelblau(x):
    """Negative Himmelblau function; four symmetric modes, logZ ~ -3.2 on
    [-5, 5]^2 (reference docs detailed_usage.rst:197)."""
    return -((x[0] ** 2 + x[1] - 11.0) ** 2 + (x[0] + x[1] ** 2 - 7.0) ** 2)


himmelblau_bounds = np.array([[-5.0, 5.0], [-5.0, 5.0]]).T
himmelblau_names = ["x1", "x2"]


def rosenbrock(x):
    """Negative Rosenbrock in 2-D."""
    return -((1.0 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2)


rosenbrock_bounds = np.array([[-5.0, 5.0], [-5.0, 5.0]]).T
rosenbrock_names = ["x1", "x2"]


def gaussian_ring(x, radius=2.0, width=0.1):
    """Ring-shaped density in 2-D."""
    r = np.sqrt(x[0] ** 2 + x[1] ** 2)
    return -0.5 * ((r - radius) / width) ** 2


gaussian_ring_bounds = np.array([[-4.0, 4.0], [-4.0, 4.0]]).T


def make_gaussian(d, mean=None, sigma=0.1, bounds_width=1.0):
    """d-dim Gaussian with ANALYTIC logZ on the box [0, bounds_width]^d.

    Used as the gold-standard integration test: with the likelihood normalized
    (coefficient included), logZ = -log(volume) + log(mass inside box).
    For sigma << box, logZ ~ -d*log(bounds_width).
    """
    mean = np.full(d, 0.5 * bounds_width) if mean is None else np.asarray(mean)

    def loglike(x):
        x = np.asarray(x)
        return float(
            -0.5 * np.sum(((x - mean) / sigma) ** 2)
            - 0.5 * d * np.log(2 * np.pi * sigma**2)
        )

    bounds = np.array([[0.0, bounds_width]] * d).T
    # evidence of the *likelihood* over a uniform prior on the box:
    # Z = (1/V) * integral(L dx); for mean at center and sigma << width the
    # Gaussian mass inside the box ~ 1, so logZ = -d log(width).
    from scipy.stats import norm

    mass = 1.0
    for j in range(d):
        mass *= norm.cdf((bounds[1, j] - mean[j]) / sigma) - norm.cdf(
            (bounds[0, j] - mean[j]) / sigma
        )
    logz = float(np.log(mass) - d * np.log(bounds_width))
    return loglike, bounds, logz


def make_planck_like(d=6, alpha=0.5, gamma=0.4, delta=0.3, c_fail=2.5):
    """Synthetic "planck-like" likelihood with ANALYTIC logZ: curved
    degeneracies + a hard failure region, the regime of the reference's
    cosmology runs (BOBE docs, examples/cosmology.rst:278,
    6 params, ~5% posterior-to-prior widths, Boltzmann-code failures handled
    by the classifier-GP).

    Construction (d >= 6): z_j = (x_j - mu_j) / sigma_j, then unit-Jacobian
    triangular shears create curved degeneracies:

        u0 = z0
        u1 = z1 + alpha (z0^2 - 1)     (banana pair 0-1)
        u2 = z2
        u3 = z3 + gamma (z2^2 - 1)     (banana pair 2-3)
        u4 = z4 + delta z0 z2          (3-way coupling)
        u_j = z_j  (j >= 5)

    loglike = log N(u; 0, I) - sum log sigma_j, so under the likelihood
    measure the u_j are iid standard normal and the integral over x is
    EXACTLY the u-space Gaussian mass. A hard failure region u1 > c_fail
    ("theory code fails", curved boundary in x-space) raises RuntimeError,
    which the Likelihood adapter maps to minus_inf. The default cut at
    2.5 sigma keeps the boundary at the posterior FRINGE (like real
    Boltzmann-code failures: most of the PRIOR volume fails, ~0.6% of the
    posterior mass is cut); with the cut through the bulk (c_fail ~ 1) the
    evidence error becomes classifier-boundary-limited (~0.5 nats measured)
    for this surrogate architecture and the reference's alike. Hence

        logZ = log Phi(c_fail) - log V_prior  + log(1 - eps_box)

    with eps_box < 1e-12 by construction (prior widths cover >= 8 sd of
    every z_j including the shear-inflated tails). Returns
    (loglike, bounds, names, logz_true).
    """
    from scipy.stats import norm

    assert d >= 6
    # cosmology-flavoured scales: every parameter a different magnitude
    mu = np.array([0.32, 0.05, 0.68, 0.97, 3.05, 0.81] + [0.5] * (d - 6))[:d]
    sigma = np.array([0.011, 0.008, 0.012, 0.004, 0.015, 0.006]
                     + [0.01] * (d - 6))[:d]
    # z-tail inflation from the shears: sd(z1)^2 = 1 + 2 alpha^2 etc.
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
        """Inverse shear (for importance-sampling cross-checks)."""
        z = np.array(u, dtype=float, copy=True)
        z[1] = u[1] - alpha * (u[0] ** 2 - 1.0)
        z[3] = u[3] - gamma * (u[2] ** 2 - 1.0)
        z[4] = u[4] - delta * u[0] * u[2]
        return mu + sigma * z

    logz_true = float(np.log(norm.cdf(c_fail)) - log_v)
    loglike.unwarp = unwarp
    loglike.c_fail = c_fail
    return loglike, bounds, names, logz_true


def planck_like_ref_draws(loglike, bounds, n, rng=None, width=2.0):
    """Draws from a broadened posterior-shaped reference distribution —
    the synthetic analogue of a Cobaya YAML's per-parameter ``ref`` dists
    (the reference's cosmology runs seed near-peak points from them,
    likelihood.py:188-204). Returns (X (n, d), y (n,)) with y evaluated
    through the failure-aware likelihood (failures -> minus_inf floor)."""
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
            v = -1e10
        X.append(x), y.append(v)
    return np.asarray(X), np.asarray(y)
