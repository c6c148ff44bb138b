"""Fantasy-variance math for evidence-weighted acquisition.

Adding candidate c to the training set changes the posterior variance at m to

    var'(m) = var(m) - cov(c, m)^2 / var(c)

where cov/var are the current posterior (co)variances with noisy diagonal.
For a candidate pool equal to the MC point set the whole sweep is one
triangular solve and one (n_mc, cap) @ (cap, n_mc) matrix product.
"""
from __future__ import annotations

import torch

from .. import config
from . import chol as chol_ops
from . import kernels as kr


def _floor(v):
    floor = config.SAFE_NOISE_FLOOR
    v = torch.where(torch.isnan(v), torch.full_like(v, floor), v)
    return torch.clamp(v, min=floor)


def posterior_batch(kernel_name, x_pad, mask, L, xq, lengthscales, amp, noise):
    """Posterior solve payload for query points xq (m, d).

    Returns (V, var):
      V:   (cap, m) = L^-1 K(X, xq)   (pad rows zero)
      var: (m,)     = amp + noise - sum(V^2, 0)   [noisy posterior variance,
                       standardized scale, clipped to the safe floor]
    """
    K12 = kr.cross_kernel_masked(kernel_name, x_pad, mask, xq, lengthscales, amp)
    V = chol_ops.tri_solve(L, K12)
    var = amp + noise - torch.sum(V * V, dim=0)
    return V, _floor(var)


def posterior_cov(kernel_name, xa, xb, Va, Vb, lengthscales, amp):
    """Posterior cross-covariance cov(a, b) = K(a, b) - Va^T Vb of query
    rows xa (ma, d) and xb (mb, d), with Va, Vb their posterior_batch V."""
    return kr.cross_kernel(kernel_name, xa, xb, lengthscales, amp) - Va.T @ Vb


def wip_values(C, var_rows, var, y_std, use_std, n_valid=None):
    """WIPV / WIPStd of the candidates whose rows of the pool covariance are
    C (mc, m), var_rows their posterior variances: the mean over the pool
    of g(var'(m | add c)) * y_std^p. ``n_valid``: integrate over the first
    n_valid columns only."""
    fantasy = _floor(var[None, :] - (C * C) / var_rows[:, None])
    if n_valid is not None:
        fantasy = fantasy[:, :n_valid]
    if use_std:
        return torch.mean(torch.sqrt(fantasy), dim=1) * y_std
    return torch.mean(fantasy, dim=1) * y_std**2


def wip_sweep(kernel_name, xq, V, var, lengthscales, amp, noise, y_std,
              use_std, n_valid=None):
    """WIPV / WIPStd for every candidate in the MC pool at once.

    acq[c] = mean_m g(var'(m | add c)) * y_std^p, g = identity (WIPV, p=2)
    or sqrt (WIPStd, p=1). ``n_valid``: integrate over the first n_valid
    columns only."""
    C = posterior_cov(kernel_name, xq, xq, V, V, lengthscales, amp)
    return wip_values(C, var, var, y_std, use_std, n_valid)


def wip_greedy_batch(kernel_name, xq, V, var, lengthscales, amp, noise,
                     y_std, use_std, n_batch: int, C=None):
    """Greedy batch of n_batch pool candidates by rank-1 downdates of the
    (m, m) posterior covariance ``C`` (computed here when None):

        var'(m)   = var(m)   - w_m^2,      w = C[i*, :] / sqrt(var(i*))
        C'(a, m)  = C(a, m)  - w_a w_m

    Returns (idx (n_batch,), acq_vals (n_batch,)) as device tensors."""
    if C is None:
        C = posterior_cov(kernel_name, xq, xq, V, V, lengthscales, amp)
    scale = y_std if use_std else y_std**2
    floor = config.SAFE_NOISE_FLOOR
    idxs, vals = [], []
    taken = torch.zeros((xq.shape[0],), dtype=torch.bool, device=xq.device)
    for _ in range(n_batch):
        fantasy = _floor(var[None, :] - (C * C) / var[:, None])
        red = torch.sqrt(fantasy) if use_std else fantasy
        acq = torch.mean(red, dim=1) * scale
        acq_masked = torch.where(taken, torch.full_like(acq, float("inf")), acq)
        i_star = torch.argmin(acq_masked)
        taken = taken.clone()
        taken[i_star] = True
        idxs.append(i_star)
        vals.append(acq[i_star])
        w = C[i_star, :] / torch.sqrt(torch.clamp(var[i_star], min=floor))
        var = torch.clamp(var - w * w, min=floor)
        C = C - torch.outer(w, w)
    return torch.stack(idxs), torch.stack(vals)


def fantasy_var_single(kernel_name, x_pad, mask, L, x_new, mc_points, V,
                       var_mc, lengthscales, amp, noise):
    """Fantasy variance at mc_points after adding one arbitrary point x_new
    (d,). Differentiable in x_new (the refine polish)."""
    k_new = kr.cross_kernel_masked(kernel_name, x_pad, mask, x_new[None, :],
                                   lengthscales, amp)
    v_new = chol_ops.tri_solve(L, k_new)[:, 0]
    var_new = amp + noise - torch.dot(v_new, v_new)
    var_new = torch.clamp(var_new, min=config.SAFE_NOISE_FLOOR)
    k_nm = kr.cross_kernel(kernel_name, x_new[None, :], mc_points,
                           lengthscales, amp)[0]
    cov = k_nm - v_new @ V
    return _floor(var_mc - cov * cov / var_new)
