"""The d-dimensional Gaussian on the unit box, with its analytic evidence: a
frozen numpy copy of ``make_gaussian`` of ``bobe_tpu_torch/models/toys.py``,
kept fixed while the program changes, and the benchmark's own seeded rows
about its mode. Nothing here imports the program.

A toy is found by its name (a configuration's ``likelihood.toy``): the module
``benchmark/toys/<toy>.py`` and its ``make(spec)``.
"""
from __future__ import annotations

import numpy as np


def make_gaussian(d, mean=None, sigma=0.1, bounds_width=1.0):
    """d-dim Gaussian with ANALYTIC logZ on the box [0, bounds_width]^d.

    With the likelihood normalized (coefficient included), logZ =
    -log(volume) + log(mass inside box). Returns (loglike, bounds, logz)."""
    mean = np.full(d, 0.5 * bounds_width) if mean is None else np.asarray(mean)

    def loglike(x):
        x = np.asarray(x)
        return float(
            -0.5 * np.sum(((x - mean) / sigma) ** 2)
            - 0.5 * d * np.log(2 * np.pi * sigma**2)
        )

    bounds = np.array([[0.0, bounds_width]] * d).T
    from scipy.stats import norm

    mass = 1.0
    for j in range(d):
        mass *= norm.cdf((bounds[1, j] - mean[j]) / sigma) - norm.cdf(
            (bounds[0, j] - mean[j]) / sigma
        )
    logz = float(np.log(mass) - d * np.log(bounds_width))
    loglike.mean = mean
    loglike.sigma = sigma
    return loglike, bounds, logz


def gaussian_draws(loglike, bounds, n, rng, width=2.0, minus_inf=-1e10):
    """Draws of N(mean, (width sigma)^2) inside the box: the rows about the
    mode that a BO run on the Gaussian has chosen by its later iterations.
    Returns (X (n, d), y (n,))."""
    d = bounds.shape[1]
    X = np.empty((0, d))
    while X.shape[0] < n:
        x = loglike.mean + width * loglike.sigma * rng.standard_normal((n, d))
        ok = np.all((x >= bounds[0]) & (x <= bounds[1]), axis=1)
        X = np.vstack([X, x[ok]])
    X = X[:n]
    return X, np.asarray([loglike(x) for x in X])


def make(spec):
    """(loglike, bounds, names, logz_true, draws) of {"toy": "gaussian",
    "d", "sigma"}."""
    d = int(spec["d"])
    loglike, bounds, logz = make_gaussian(d, sigma=float(spec["sigma"]))
    return loglike, bounds, [f"x{i}" for i in range(d)], logz, gaussian_draws
