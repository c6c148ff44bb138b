"""Core math utilities: unit-cube scaling, resampling, KL diagnostics,
thresholds, atomic file writes (numpy on the host) and process helpers."""
from __future__ import annotations

import os
from contextlib import contextmanager, redirect_stderr, redirect_stdout

import numpy as np
from scipy.special import erfc, logsumexp
from scipy.stats import chi2

from .seed import get_numpy_rng


# ---------------------------------------------------------------- scaling

def scale_to_unit(x, param_bounds):
    """Map from physical domain to the unit hypercube.

    x: (..., d); param_bounds: (2, d) rows = (lower, upper).
    """
    lo, hi = param_bounds[0], param_bounds[1]
    return (x - lo) / (hi - lo)


def scale_from_unit(x, param_bounds):
    """Map from the unit hypercube to the physical domain."""
    lo, hi = param_bounds[0], param_bounds[1]
    return x * (hi - lo) + lo


# ---------------------------------------------------------------- weights / resampling

def renormalise_log_weights(log_weights):
    lw = np.asarray(log_weights, dtype=np.float64)
    return np.exp(lw - logsumexp(lw))


def resample_equal(samples, aux, weights=None, logwts=None, rng=None):
    """Systematic resampling to equal weights. Returns permuted
    (samples, aux)."""
    rng = rng if rng is not None else get_numpy_rng()
    if logwts is not None:
        wts = renormalise_log_weights(logwts)
    else:
        wts = np.asarray(weights, dtype=np.float64)
    wts = wts / wts.sum()
    cum = np.cumsum(wts)
    cum /= cum[-1]
    n = len(wts)
    positions = (rng.random() + np.arange(n)) / n
    idx = np.searchsorted(cum, positions, side="right")
    idx = np.clip(idx, 0, n - 1)
    perm = rng.permutation(n)
    samples = np.asarray(samples)
    aux = np.asarray(aux)
    return samples[idx][perm], aux[idx][perm]


# ---------------------------------------------------------------- KL diagnostics

def _kl_gaussian_single(mu1, cov1, mu2, cov2):
    d = mu1.shape[0]
    _, logdet1 = np.linalg.slogdet(cov1)
    _, logdet2 = np.linalg.slogdet(cov2)
    trace_term = np.trace(np.linalg.solve(cov2, cov1))
    diff = mu2 - mu1
    quad = diff @ np.linalg.solve(cov2, diff)
    return 0.5 * (logdet2 - logdet1 - d + trace_term + quad)


def kl_divergence_gaussian(mu1, cov1, mu2, cov2):
    """Forward/reverse/symmetric KL between two Gaussian moment fits."""
    fwd = _kl_gaussian_single(mu1, cov1, mu2, cov2)
    rev = _kl_gaussian_single(mu2, cov2, mu1, cov1)
    return {"forward": fwd, "reverse": rev, "symmetric": 0.5 * (fwd + rev)}


# ---------------------------------------------------------------- thresholds / misc

def get_threshold_for_nsigma(nsigma, d):
    """Delta-loglike between a Gaussian peak and its n-sigma contour in d
    dims (chi^2 construction)."""
    nstd = np.sqrt(chi2.isf(erfc(nsigma / np.sqrt(2)), d))
    return 0.5 * nstd**2


def atomic_write(path: str, writer, binary: bool = False):
    """Write a file via tmp + fsync + os.replace so a crash mid-write can
    never corrupt the previous good copy. ``writer(f)`` receives the open
    tmp-file handle."""
    tmp = f"{path}.tmp"
    with open(tmp, "wb" if binary else "w") as f:
        writer(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def kl_divergence_samples(prev_loglike, curr_loglike):
    """Forward/reverse/symmetric KL between the normalised likelihood
    weights of two sets of log-likelihoods at the same samples."""
    from scipy import stats

    p = np.exp(prev_loglike - np.max(prev_loglike))
    q = np.exp(curr_loglike - np.max(curr_loglike))
    p /= p.sum()
    q /= q.sum()
    fwd = stats.entropy(p, q)
    rev = stats.entropy(q, p)
    return {"forward": fwd, "reverse": rev, "symmetric": 0.5 * (fwd + rev)}


@contextmanager
def suppress_stdout_stderr():
    """Silence noisy third-party output (theory codes, samplers)."""
    with open(os.devnull, "w") as fnull:
        with redirect_stderr(fnull) as err, redirect_stdout(fnull) as out:
            yield (err, out)


def is_cluster_environment() -> bool:
    """True under a batch scheduler or MPI launcher, or when stdout is not a
    terminal."""
    indicators = [
        "SLURM_JOB_ID", "PBS_JOBID", "LSB_JOBID", "SGE_TASK_ID",
        "COBALT_JOBID", "MOAB_JOBID", "OMPI_COMM_WORLD_SIZE", "PMI_RANK",
    ]
    if any(os.getenv(v) for v in indicators):
        return True
    try:
        return not os.isatty(1)
    except Exception:
        return True
