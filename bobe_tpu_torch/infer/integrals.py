"""Nested-sampling evidence integrals (host-side, float64 numpy).

Copied from bobe_tpu/infer/integrals.py. The standard trapezoidal NS
quadrature for the logZ estimate and its GP-uncertainty bounds: given
dead-point log-likelihoods and their assigned log prior volumes, accumulate logZ_i = logaddexp_cumsum( log((L_i + L_{i-1})/2) +
log(X_{i-1} - X_i) ).
"""
from __future__ import annotations

import numpy as np


def trapezoid_logz(logl, logvol, squared: bool = False,
                   lv_start: float = 0.0):
    """Cumulative logZ via the trapezoid rule.

    logl: (n,) dead-point log-likelihoods in sampling order (ascending-ish).
    logvol: (n,) log prior volumes, decreasing from ~lv_start.
    squared: use (dX)^2 instead of dX (for the variance integral
             Var ~ int sigma^2 L^2 dX^2 of the evidence error).
    lv_start: log volume the shrinkage ledger started at (log feasible
              fraction for rejection-seeded classifier-gated runs, else 0).
    Returns (n,) cumulative logZ values.
    """
    return np.logaddexp.accumulate(
        logwt_from(logl, logvol, squared=squared, lv_start=lv_start))


def logwt_from(logl, logvol, squared: bool = False, lv_start: float = 0.0):
    """Per-point trapezoid log-weights (unnormalized posterior weights).

    The single home of the delicate quadrature numerics (volume-difference
    log1p, the -1e-300 shrinkage clip, the trapezoid average) —
    ``trapezoid_logz`` is its cumulative sum, so the cumulative logZ and the
    per-point posterior weights can never desynchronize.
    """
    logl = np.asarray(logl, dtype=np.float64)
    logvol = np.asarray(logvol, dtype=np.float64)
    # log(X_{i-1} - X_i) = logvol_{i-1} + log1p(-exp(logvol_i - logvol_{i-1}))
    lv_prev = np.concatenate([[lv_start], logvol[:-1]])
    dd = np.clip(logvol - lv_prev, None, -1e-300)
    logdvol = lv_prev + np.log1p(-np.exp(dd))
    if squared:  # (dX)^2, for the variance integral int sigma^2 L^2 dX^2
        logdvol = 2.0 * logdvol
    # trapezoid: (L_i + L_{i-1}) / 2
    l_prev = np.concatenate([[-1e300], logl[:-1]])
    return np.logaddexp(logl, l_prev) + logdvol + np.log(0.5)


def information_and_err(logl, logvol, logz, nlive, lv_start: float = 0.0):
    """KL information H and the classic logZ error sqrt(H / nlive).

    ``nlive`` may be a scalar (static run) or a per-death live-count array
    (merged / dynamic runs, infer/nested.merge_runs): the error then sums the
    per-point information increments h_i / n_i — the varying-live-count
    generalization that reduces to H/nlive for constant counts. Negative
    early increments are clipped to zero per point (slightly conservative)."""
    logwt = logwt_from(logl, logvol, lv_start=lv_start)
    wt = np.exp(logwt - logz)
    h_i = wt * (np.asarray(logl) - logz)
    h = max(float(np.sum(h_i)), 0.0)
    n = np.asarray(nlive, dtype=np.float64)
    if n.ndim == 0:
        return h, float(np.sqrt(h / max(float(n), 1.0)))
    var = float(np.sum(np.clip(h_i, 0.0, None) / np.maximum(n, 1.0)))
    return h, float(np.sqrt(var))


def logz_bounds_from_gp_sigma(logl, logvol, sigma, lv_start: float = 0.0):
    """Upper/lower logZ by re-integrating logl +/- sigma over the same volumes,
    plus the variance integral var_logz = exp( log int sigma^2 L^2 dX^2 - 2 logZ )
    — the uncertainty construction of BOBE's samplers.
    """
    logl = np.asarray(logl, dtype=np.float64)
    sigma = np.asarray(sigma, dtype=np.float64)
    mean = trapezoid_logz(logl, logvol, lv_start=lv_start)[-1]
    upper = trapezoid_logz(logl + sigma, logvol, lv_start=lv_start)[-1]
    lower = trapezoid_logz(logl - sigma, logvol, lv_start=lv_start)[-1]
    var = np.clip(sigma**2, 1e-12, 1e12)
    varint = trapezoid_logz(2.0 * logl + np.log(var), logvol, squared=True,
                            lv_start=lv_start)[-1]
    log_var_logz = np.clip(varint - 2.0 * mean, -100.0, 100.0)
    var_logz = np.exp(log_var_logz)
    return {
        "mean": float(mean),
        "upper": float(upper),
        "lower": float(lower),
        "var": float(var_logz),
        "std": float(2.0 * np.sqrt(var_logz)),
    }
