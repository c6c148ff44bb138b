"""Marginal log-likelihood and hyperparameter priors for the GP surrogate.

With the padded identity Gram of ops/kernels.gram_masked the pad rows
contribute log(diag)=0 and y_pad=0, so the standard MLL expression is exact
on padded buffers with no extra masking. Every function broadcasts over
leading batch dimensions (the optimizer's restart lanes).
"""
from __future__ import annotations

import math

import torch

from . import chol as chol_ops

LOG_2PI = math.log(2.0 * math.pi)


# --------------------------------------------------------------- distributions

def lognormal_logprob(x, loc, scale):
    x = torch.clamp(x, min=torch.finfo(x.dtype).tiny)
    lx = torch.log(x)
    return (-lx - math.log(scale) - 0.5 * LOG_2PI
            - 0.5 * ((lx - loc) / scale) ** 2)


def halfcauchy_logprob(x, scale):
    lp = math.log(2.0 / math.pi) - math.log(scale) - torch.log1p((x / scale) ** 2)
    return torch.where(x >= 0, lp, torch.full_like(lp, -math.inf))


def uniform_logprob(x, low, high):
    inside = (x >= low) & (x <= high)
    val = torch.full_like(x, -math.log(high - low))
    return torch.where(inside, val, torch.full_like(x, -math.inf))


def normal_logprob(x, loc, scale):
    return -0.5 * LOG_2PI - math.log(scale) - 0.5 * ((x - loc) / scale) ** 2


def gamma_logprob(x, concentration, rate=1.0):
    x = torch.clamp(x, min=torch.finfo(x.dtype).tiny)
    return (concentration * math.log(rate) - math.lgamma(concentration)
            + (concentration - 1.0) * torch.log(x) - rate * x)


_DIST_TABLE = {
    "lognormal": lambda x, s: lognormal_logprob(x, s.get("loc", 0.0), s.get("scale", 1.0)),
    "halfcauchy": lambda x, s: halfcauchy_logprob(x, s.get("scale", 1.0)),
    "uniform": lambda x, s: uniform_logprob(x, s.get("low", 0.0), s.get("high", 1.0)),
    "normal": lambda x, s: normal_logprob(x, s.get("loc", 0.0), s.get("scale", 1.0)),
    "gamma": lambda x, s: gamma_logprob(x, s.get("concentration", 1.0), s.get("rate", 1.0)),
}


def spec_logprob(spec: dict, x):
    """Log-density from a {'name': ..., **params} spec."""
    name = spec["name"].lower()
    if name not in _DIST_TABLE:
        raise ValueError(f"Unknown distribution '{spec['name']}'")
    return _DIST_TABLE[name](x, spec)


# ---------------------------------------------------------------------- priors

def dslp_lengthscale_logprob(lengthscales, ndim):
    """Dimension-scaled lengthscale prior: LogNormal(sqrt2 + 0.5 log d,
    sqrt3) per ARD lengthscale, summed over the last axis."""
    loc = math.sqrt(2.0) + 0.5 * math.log(ndim)
    return torch.sum(lognormal_logprob(lengthscales, loc, math.sqrt(3.0)),
                     dim=-1)


def saas_logprob(lengthscales, kernel_variance, tausq):
    """SAAS sparsity prior: LogNormal(0, 1) amplitude, HalfCauchy(0.1)
    global shrinkage tausq, HalfCauchy(1) on every 1 / (tausq ls^2); the
    lengthscale terms summed over the last axis."""
    lp = lognormal_logprob(kernel_variance, 0.0, 1.0)
    lp = lp + halfcauchy_logprob(tausq, 0.1)
    inv_ls_sq = 1.0 / (tausq[..., None] * lengthscales ** 2)
    return lp + torch.sum(halfcauchy_logprob(inv_ls_sq, 1.0), dim=-1)


# ------------------------------------------------------------------------- MLL

def gp_mll(K, y, n):
    """Gaussian-process marginal log-likelihood on padded buffers.

    K: (..., cap, cap) masked Gram; y: (cap,) standardized targets, pad
    zeros; n: active count. A non-positive-definite K gives NaN."""
    L = chol_ops.cholesky(K)
    alpha = chol_ops.cho_solve(L, y.expand(K.shape[:-1]))
    quad = torch.sum(y * alpha, dim=-1)
    logdet = torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
    return -0.5 * quad - logdet - 0.5 * n * LOG_2PI
