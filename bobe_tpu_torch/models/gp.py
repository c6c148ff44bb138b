"""Exact Gaussian-process surrogate on padded device buffers.

Counterpart of ``bobe_tpu/models/gp.py``. The GP is a ``GPState`` of padded
tensors plus plain functions:

* ``x``/``y_raw`` live in (cap, d)/(cap,) buffers, cap a multiple of
  ``config.PAD_MULTIPLE``, with an active count ``n``. Pad rows of the Gram
  matrix are the identity, so padded Cholesky factors and solves are exact.
* Adding points uses the O(cap^2 b) block Cholesky extension; re-standardizing
  the targets after an update only changes ``alpha``.
* Hyperparameter fits run all restarts as lanes of one batched L-BFGS
  (ops/optimize.py) in float64, or as lockstep adam lanes, or as host scipy
  L-BFGS-B restarts (``optimizer``).
* Options: the SAAS lengthscale prior (its global shrinkage ``tausq`` is a
  fitted hyperparameter) and the Kumaraswamy input warp, whose parameters
  are fitted jointly with the kernel's: every kernel evaluation then runs in
  warp space (:func:`train_coords`, :func:`query_coords`), and each restart
  lane of a fit warps the training points with its own parameters (one
  per-lane Gram build, differentiated through the coordinates).

``n`` is a host integer: every slice of the buffers uses it, and keeping it
on the host saves a device read per slice. State tensors are never written in
place, so states may share tensors (``GP.dummy_like``).

The ``GP`` class mirrors the JAX package's facade (predict_*_single/batched,
update, fit, state_dict/save/load/copy, fantasy_var, ...); ``GP.load`` reads
an npz written by either package.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from .. import config
from ..ops import chol as chol_ops
from ..ops import kernels as kr
from ..ops import mll as mll_ops
from ..ops import optimize as opt_ops
from ..ops.fantasy import fantasy_var_single, posterior_batch
from ..utils import trace
from ..utils.core import atomic_write
from ..utils.log import get_logger
from ..utils.seed import get_numpy_rng

log = get_logger("gp")

SAFE_NOISE_FLOOR = config.SAFE_NOISE_FLOOR

# Duplicate-detection tolerances.
DEDUP_ATOL = 1e-6
DEDUP_RTOL = 1e-4

# The fit precomputes per-dimension squared distances (d, cap, cap) when
# they fit in this many bytes; above it every objective evaluation rebuilds
# the Gram matrix through gram_masked.
PERDIM_MAX_BYTES = 256 * 1024**2


def _round_capacity(n: int) -> int:
    m = config.PAD_MULTIPLE
    return max(m, ((int(n) + m - 1) // m) * m)


class GPState(NamedTuple):
    """Padded GP state; ``n`` is the number of active training points."""

    x: torch.Tensor          # (cap, d) inputs in the unit cube, pad rows 0.5
    y_raw: torch.Tensor      # (cap,) unstandardized targets, pad 0
    n: int                   # active count (host)
    chol: torch.Tensor       # (cap, cap) lower Cholesky of padded Gram
    alpha: torch.Tensor      # (cap,) K^-1 y_standardized
    log_ls: torch.Tensor     # (d,) log ARD lengthscales
    log_amp: torch.Tensor    # () log kernel variance
    log_tausq: torch.Tensor  # () log SAAS tausq (unused unless SAAS prior)
    y_mean: torch.Tensor     # () standardization mean
    y_std: torch.Tensor      # () standardization std
    # (d,) log Kumaraswamy input-warp parameters, identity at 0; read only
    # when GPTrainConfig.input_warp is on
    log_wa: Optional[torch.Tensor] = None
    log_wb: Optional[torch.Tensor] = None

    @property
    def cap(self) -> int:
        return self.x.shape[0]

    @property
    def ndim(self) -> int:
        return self.x.shape[1]

    def mask(self) -> torch.Tensor:
        return (torch.arange(self.cap, device=self.x.device)
                < self.n).to(self.x.dtype)


def _freeze_spec(spec):
    """Normalize a prior spec to a hashable form (dict -> sorted items)."""
    if isinstance(spec, dict):
        return tuple(sorted(spec.items()))
    return spec


def _thaw_spec(spec):
    if isinstance(spec, tuple):
        return dict(spec)
    return spec


@dataclass(frozen=True)
class GPTrainConfig:
    """Static GP configuration. Prior specs are stored frozen."""

    kernel: str = "rbf"
    noise: float = 1e-8
    fixed_kernel_variance: bool = False
    lengthscale_prior: Any = None      # None | 'DSLP' | 'SAAS' | frozen spec
    kernel_variance_prior: Any = None  # None | 'fixed' | frozen spec
    lengthscale_bounds: tuple = (0.01, 5.0)
    kernel_variance_bounds: tuple = (1e-4, 1e8)
    tausq_bounds: tuple = (1e-4, 1e4)
    # Kumaraswamy input warp u = 1 - (1 - x^a)^b per dimension, fitted with
    # the kernel hyperparameters; warp_bounds bound a and b (identity 1)
    input_warp: bool = False
    warp_bounds: tuple = (0.25, 4.0)


# =====================================================================
# Functional core
# =====================================================================

def _standardize(y_raw, mask, n):
    n_f = float(max(n, 1))
    mean = torch.sum(y_raw * mask) / n_f
    var = torch.sum(mask * (y_raw - mean) ** 2) / n_f
    std = torch.sqrt(var)
    std = torch.where(std == 0.0, torch.ones_like(std), std)
    return mean, std


def _y_standardized(state: GPState):
    return (state.y_raw - state.y_mean) / state.y_std * state.mask()


# the warp's clip keeps x^a and (1 - x^a)^b off the cube's faces, where
# their slopes are infinite for a, b < 1
WARP_CLIP = 1e-10


def kumaraswamy_warp(x, log_wa, log_wb):
    """Per-dimension Kumaraswamy CDF warp u = 1 - (1 - x^a)^b on [0, 1],
    (a, b) = exp(log_wa, log_wb); identity at a = b = 1. x (..., m, d);
    log_wa, log_wb (d,) or (R, d), one warp per lane (then the result is
    (R, m, d)). x is clipped to [WARP_CLIP, 1 - WARP_CLIP]."""
    a = torch.exp(log_wa).unsqueeze(-2)
    b = torch.exp(log_wb).unsqueeze(-2)
    xc = torch.clamp(x, WARP_CLIP, 1.0 - WARP_CLIP)
    return 1.0 - (1.0 - xc ** a) ** b


def warp_jacobian(x, log_wa, log_wb):
    """du/dx of :func:`kumaraswamy_warp` elementwise:
    a b x^(a-1) (1 - x^a)^(b-1), 0 where the clip holds."""
    a = torch.exp(log_wa)
    b = torch.exp(log_wb)
    inside = (x >= WARP_CLIP) & (x <= 1.0 - WARP_CLIP)
    xc = torch.clamp(x, WARP_CLIP, 1.0 - WARP_CLIP)
    xa = xc ** a
    jac = a * b * xa / xc * (1.0 - xa) ** (b - 1.0)
    return torch.where(inside, jac, torch.zeros_like(jac))


def train_coords(state: GPState, cfg: GPTrainConfig):
    """Kernel-space coordinates of the training buffer (warped iff the
    warp is on)."""
    if cfg.input_warp:
        return kumaraswamy_warp(state.x, state.log_wa, state.log_wb)
    return state.x


def query_coords(state: GPState, cfg: GPTrainConfig, xq):
    """Kernel-space coordinates of query points (warped iff the warp is
    on)."""
    if cfg.input_warp:
        return kumaraswamy_warp(xq, state.log_wa, state.log_wb)
    return xq


def gram(state: GPState, cfg: GPTrainConfig):
    return kr.gram_masked(cfg.kernel, train_coords(state, cfg), state.mask(),
                          torch.exp(state.log_ls), torch.exp(state.log_amp),
                          cfg.noise)


def refresh(state: GPState, cfg: GPTrainConfig) -> GPState:
    """Full O(cap^3) recompute of standardization + Cholesky + alpha."""
    mask = state.mask()
    y_mean, y_std = _standardize(state.y_raw, mask, state.n)
    state = state._replace(y_mean=y_mean, y_std=y_std)
    K = gram(state, cfg)
    L = chol_ops.cholesky_jittered(K, mask, torch.exp(state.log_amp))
    alpha = chol_ops.cho_solve(L, _y_standardized(state))
    return state._replace(chol=L, alpha=alpha)


def extend(state: GPState, cfg: GPTrainConfig, new_x, new_y) -> GPState:
    """Add a batch of points with dedupe + block Cholesky extension.

    new_x: (b, d), new_y: (b,). Points already present in the active set
    (isclose at DEDUP_ATOL/DEDUP_RTOL) or duplicating an earlier member of
    the batch are dropped. Requires n + b <= cap. A non-finite block factor
    falls back to a full jittered refresh. One host read per call.
    """
    b = new_x.shape[0]
    mask = state.mask()
    ls, amp = torch.exp(state.log_ls), torch.exp(state.log_amp)

    close = torch.isclose(state.x[None, :, :], new_x[:, None, :],
                          atol=DEDUP_ATOL, rtol=DEDUP_RTOL)
    dup = torch.any(torch.all(close, dim=-1) & (mask[None, :] > 0), dim=1)
    close_nn = torch.all(torch.isclose(new_x[:, None, :], new_x[None, :, :],
                                       atol=DEDUP_ATOL, rtol=DEDUP_RTOL),
                         dim=-1)
    earlier = torch.tril(torch.ones((b, b), dtype=torch.bool,
                                    device=new_x.device), diagonal=-1)
    dup_batch = torch.any(close_nn & earlier, dim=1)
    accept = ~(dup | dup_batch)
    order = torch.argsort((~accept).long(), stable=True)
    xs = new_x[order]
    ys = new_y[order]
    acc = accept[order].to(state.x.dtype)

    # neutralize pad slots
    xs = xs * acc[:, None] + 0.5 * (1.0 - acc[:, None])
    ys = ys * acc

    # kernel matrices in warp space (the dedupe above stays in raw space)
    xs_k = query_coords(state, cfg, xs)
    K21 = kr.cross_kernel(cfg.kernel, xs_k, train_coords(state, cfg), ls, amp)
    K21 = K21 * (acc[:, None] * mask[None, :])
    K22 = kr.cross_kernel(cfg.kernel, xs_k, xs_k, ls, amp)
    K22 = K22 * (acc[:, None] * acc[None, :])
    K22 = K22 + torch.diag(cfg.noise * acc + (1.0 - acc))
    L21, L22 = chol_ops.extend_cholesky_block(state.chol, K21, K22)

    ok_t = torch.isfinite(L21).all() & torch.isfinite(L22).all()
    n_acc, ok = torch.stack([accept.sum().to(state.x.dtype),
                             ok_t.to(state.x.dtype)]).tolist()
    n = state.n
    chol_new = state.chol.clone()
    chol_new[n:n + b, :] = L21
    chol_new[n:n + b, n:n + b] = L22
    x_new = state.x.clone()
    x_new[n:n + b] = xs
    y_new = state.y_raw.clone()
    y_new[n:n + b] = ys
    state = state._replace(x=x_new, y_raw=y_new, n=n + int(n_acc))

    if not ok:
        return refresh(state, cfg)
    st = state._replace(chol=chol_new)
    y_mean, y_std = _standardize(st.y_raw, st.mask(), st.n)
    st = st._replace(y_mean=y_mean, y_std=y_std)
    return st._replace(alpha=chol_ops.cho_solve(st.chol, _y_standardized(st)))


def predict_raw(state: GPState, cfg: GPTrainConfig, xq):
    """Standardized-scale posterior (mean, var) at xq (m, d): noisy variance
    diagonal, NaN-guarded and floor-clipped."""
    ls, amp = torch.exp(state.log_ls), torch.exp(state.log_amp)
    K12 = kr.cross_kernel_masked(cfg.kernel, train_coords(state, cfg),
                                 state.mask(), query_coords(state, cfg, xq),
                                 ls, amp)
    mean = K12.T @ state.alpha
    V = chol_ops.tri_solve(state.chol, K12)
    var = (amp + cfg.noise) - torch.sum(V * V, dim=0)
    var = torch.where(torch.isnan(var), torch.full_like(var, SAFE_NOISE_FLOOR),
                      var)
    return mean, torch.clamp(var, min=SAFE_NOISE_FLOOR)


def predict_mean(state: GPState, cfg: GPTrainConfig, xq):
    """Physical-scale posterior mean at xq (m, d)."""
    ls, amp = torch.exp(state.log_ls), torch.exp(state.log_amp)
    K12 = kr.cross_kernel_masked(cfg.kernel, train_coords(state, cfg),
                                 state.mask(), query_coords(state, cfg, xq),
                                 ls, amp)
    return (K12.T @ state.alpha) * state.y_std + state.y_mean


def mean_value_and_grad_fn(state: GPState, cfg: GPTrainConfig):
    """``f(xq) -> (mean (m,), grad (m, d))``: the physical-scale posterior
    mean at xq (m, d) and its gradient in xq, in closed form from one
    (cap, m) cross-kernel block. What does not depend on xq is computed
    once, here: the samplers call ``f`` on every leapfrog step, where
    autograd would build a graph per step.

    With c_i = alpha_i amp m_i (m_i the pad mask) the mean is
    sum_i c_i corr(r_i) and its gradient sum_i w_i (x_i - x) / l^2, both
    times y_std: RBF w_i = c_i exp(-r_i^2/2), Matern-5/2
    w_i = c_i (5/3)(1 + sqrt5 r_i) exp(-sqrt5 r_i).

    Under the input warp the closed form runs in warp space (the training
    coordinates warped once, here; the query u = warp(xq)) and its gradient
    is chained by the warp's Jacobian (:func:`warp_jacobian`, 0 where the
    clip holds)."""
    if cfg.kernel not in ("rbf", "matern"):
        raise ValueError(f"Unknown kernel '{cfg.kernel}'")
    ls, amp = torch.exp(state.log_ls), torch.exp(state.log_amp)
    x_tr = train_coords(state, cfg)
    xs_tr = x_tr / ls
    a2 = torch.sum(xs_tr * xs_tr, dim=-1)[:, None]
    coef = (state.alpha * amp * state.mask())[:, None]
    gfac = state.y_std / (ls * ls)
    # one host read here saves a launch per call below
    y_std = float(state.y_std)
    y_mean = state.y_mean
    rbf = cfg.kernel == "rbf"
    if rbf:
        a2 = -0.5 * a2

    def f_warped(xq):
        mean, grad = f(query_coords(state, cfg, xq))
        return mean, grad * warp_jacobian(xq, state.log_wa, state.log_wb)

    def f(xq):
        xq_s = xq / ls
        b2 = torch.linalg.vecdot(xq_s, xq_s)[None, :]
        if rbf:
            # exp(-dsq/2) with dsq = a2 + b2 - 2 ab, clamped at 0
            w = torch.exp(torch.clamp(
                torch.addmm(a2 - 0.5 * b2, xs_tr, xq_s.T), max=0.0)) * coef
            s = sw = torch.sum(w, dim=0)
        else:
            dsq = torch.clamp(torch.addmm(a2 + b2, xs_tr, xq_s.T, alpha=-2.0),
                              min=0.0)
            r = torch.sqrt(torch.clamp(dsq, min=1e-30))
            e = torch.exp(-kr.SQRT5 * r) * coef
            s = torch.sum((1.0 + kr.SQRT5 * r + (5.0 / 3.0) * dsq) * e, dim=0)
            w = (5.0 / 3.0) * (1.0 + kr.SQRT5 * r) * e
            sw = torch.sum(w, dim=0)
        grad = torch.addcmul(w.T @ x_tr, sw[:, None], xq, value=-1.0) * gfac
        return torch.add(y_mean, s, alpha=y_std), grad

    return f_warped if cfg.input_warp else f


def predict_mean_value_and_grad(state: GPState, cfg: GPTrainConfig, xq):
    """Physical-scale posterior mean at xq (m, d) and its gradient in xq
    (m, d); see :func:`mean_value_and_grad_fn`."""
    return mean_value_and_grad_fn(state, cfg)(xq)


def predict(state: GPState, cfg: GPTrainConfig, xq):
    """Physical-scale (mean, var) at xq (m, d)."""
    mean, var = predict_raw(state, cfg, xq)
    return mean * state.y_std + state.y_mean, var * state.y_std**2


def _parse_log_params(cfg: GPTrainConfig, state: GPState, log_params):
    """Split the packed log-hyperparameter vector(s) (..., n_hp):
    [log_ls (d)] [log_amp?] [log_tausq?] [log_wa (d), log_wb (d)?], the warp
    at the end. Returns (ls, amp, tausq, log_wa, log_wb); what the vector
    does not hold comes from the state."""
    d = state.ndim
    batch = log_params.shape[:-1]
    ls = torch.exp(log_params[..., :d])
    i = d
    if cfg.fixed_kernel_variance:
        amp = torch.exp(state.log_amp).expand(batch)
    else:
        amp = torch.exp(log_params[..., i])
        i += 1
    if cfg.lengthscale_prior == "SAAS":
        tausq = torch.exp(log_params[..., i])
        i += 1
    else:
        tausq = torch.exp(state.log_tausq).expand(batch)
    if cfg.input_warp:
        log_wa = log_params[..., i:i + d]
        log_wb = log_params[..., i + d:i + 2 * d]
    else:
        log_wa, log_wb = state.log_wa, state.log_wb
    return ls, amp, tausq, log_wa, log_wb


def _warp_prior_logprob(cfg: GPTrainConfig, log_wa, log_wb):
    """Log-normal prior on the warp parameters: N(0, 0.5^2) on log a and
    log b, toward the identity warp; summed over the last axis."""
    sig2 = 0.25
    return -0.5 * (torch.sum(log_wa ** 2, dim=-1)
                   + torch.sum(log_wb ** 2, dim=-1)) / sig2


def _prior_logprob(cfg: GPTrainConfig, d: int, ls, amp, tausq):
    """Hyperprior: the SAAS prior; else uniform (or a user spec) on the
    amplitude unless fixed, and on every lengthscale uniform, the DSLP
    prior, or a user spec."""
    if cfg.lengthscale_prior == "SAAS":
        return mll_ops.saas_logprob(ls, amp, tausq)
    lp = torch.zeros_like(amp)
    kv_spec = _thaw_spec(cfg.kernel_variance_prior)
    if not cfg.fixed_kernel_variance:
        if kv_spec is None:
            kv_spec = {"name": "Uniform",
                       "low": cfg.kernel_variance_bounds[0],
                       "high": cfg.kernel_variance_bounds[1]}
        lp = lp + mll_ops.spec_logprob(kv_spec, amp)
    if cfg.lengthscale_prior == "DSLP":
        return lp + mll_ops.dslp_lengthscale_logprob(ls, d)
    ls_spec = _thaw_spec(cfg.lengthscale_prior)
    if ls_spec is None:
        ls_spec = {"name": "Uniform", "low": cfg.lengthscale_bounds[0],
                   "high": cfg.lengthscale_bounds[1]}
    return lp + torch.sum(mll_ops.spec_logprob(ls_spec, ls), dim=-1)


def neg_mll(state: GPState, cfg: GPTrainConfig, log_params, dsq_perdim=None):
    """Negative (MLL + hyperprior) of log hyperparameters (n_hp,) or a batch
    of restart lanes (R, n_hp).

    ``dsq_perdim``: precomputed per-dimension squared distances
    (ops/kernels.sq_dist_perdim); each Gram build is then a weighted slab
    sum. Without it every lane's Gram matrix comes from one ``gram_masked``
    call (on the card: one forward launch, and one backward launch under
    autograd). Under the input warp every lane warps the training points
    with its own parameters, so the Gram build takes per-lane coordinates
    and is differentiated through them (``dsq_perdim`` is ignored).
    Differentiable either way."""
    ls, amp, tausq, log_wa, log_wb = _parse_log_params(cfg, state, log_params)
    mask = state.mask()
    if cfg.input_warp:
        xw = kumaraswamy_warp(state.x, log_wa, log_wb)
        K = kr.gram_masked(cfg.kernel, xw, mask, ls, amp, cfg.noise)
    elif dsq_perdim is not None:
        K = kr.gram_masked_perdim(cfg.kernel, dsq_perdim, mask, ls, amp,
                                  cfg.noise)
    else:
        K = kr.gram_masked(cfg.kernel, state.x, mask, ls, amp, cfg.noise)
    y = _y_standardized(state)
    mll = mll_ops.gp_mll(K, y, state.n)
    mll = mll + _prior_logprob(cfg, state.ndim, ls, amp, tausq)
    if cfg.input_warp:
        mll = mll + _warp_prior_logprob(cfg, log_wa, log_wb)
    return -mll


def hyperparam_bounds_log(cfg: GPTrainConfig, d: int) -> torch.Tensor:
    """(2, n_hp) log-space optimization bounds (float64, host)."""
    bounds: List = [list(cfg.lengthscale_bounds)] * d
    if not cfg.fixed_kernel_variance:
        bounds.append(list(cfg.kernel_variance_bounds))
    if cfg.lengthscale_prior == "SAAS":
        bounds.append(list(cfg.tausq_bounds))
    if cfg.input_warp:
        bounds.extend([list(cfg.warp_bounds)] * (2 * d))
    return torch.log(torch.as_tensor(bounds, dtype=torch.float64).T)


def set_hyperparams(state: GPState, cfg: GPTrainConfig, log_params) -> GPState:
    log_params = torch.as_tensor(log_params, dtype=state.x.dtype,
                                 device=state.x.device)
    ls, amp, tausq, log_wa, log_wb = _parse_log_params(cfg, state, log_params)
    state = state._replace(
        log_ls=torch.log(ls),
        log_amp=state.log_amp if cfg.fixed_kernel_variance else torch.log(amp),
        log_tausq=torch.log(tausq),
    )
    if cfg.input_warp:
        state = state._replace(log_wa=log_wa, log_wb=log_wb)
    return refresh(state, cfg)


def _loo_z_rms(state: GPState) -> torch.Tensor:
    """RMS leave-one-out z-score over the active rows: with
    Kinv = L^-T L^-1 the LOO z-score of row i is alpha_i / sqrt(Kinv_ii)."""
    cap = state.cap
    mask = state.mask()
    Linv = chol_ops.tri_solve(state.chol, torch.eye(cap, dtype=state.chol.dtype,
                                                    device=state.chol.device))
    kinv_diag = torch.sum(Linv * Linv, dim=0)
    z2 = torch.where(mask > 0,
                     state.alpha**2 / torch.clamp(kinv_diag, min=1e-300),
                     torch.zeros_like(kinv_diag))
    return torch.sqrt(torch.sum(z2) / float(max(state.n, 1)))


def _basin_representatives(cand: np.ndarray, scores: np.ndarray,
                           atol: float = 0.02) -> list:
    """Indices of one representative per distinct optimizer basin: two
    endpoints within ``atol`` in every log-hyperparameter coordinate are the
    same local optimum; the representative is the member with the best
    objective."""
    order = np.argsort(np.where(np.isfinite(scores), scores, np.inf))
    assigned = np.zeros(len(cand), dtype=bool)
    reps = []
    for i in order:
        i = int(i)
        if assigned[i]:
            continue
        close = np.all(np.abs(cand - cand[i]) <= atol, axis=1)
        assigned |= close
        reps.append(i)
    return reps


def restore_factor(gp, state: Dict[str, Any]) -> None:
    """Install a state dict's Cholesky factor, alphas and standardization
    in place of the ones a rebuild from it computed, so that the GP predicts
    what the GP that wrote the state predicts (a new factorization, on
    another device or in another order, differs from it by its roundoff)."""
    n = gp.gp_size
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64),
                                  dtype=config.DTYPE, device=gp.device)
    L, a = t(state["cholesky"]), t(state["alphas"]).reshape(-1)
    if L.shape != (n, n) or a.shape != (n,):
        raise ValueError(f"the state's factor {tuple(L.shape)} and alphas "
                         f"{tuple(a.shape)} do not fit {n} training points")
    chol, alpha = gp.state.chol.clone(), gp.state.alpha.clone()
    chol[:n, :n], alpha[:n] = L, a
    gp.state = gp.state._replace(chol=chol, alpha=alpha,
                                 y_mean=t(state["y_mean"]),
                                 y_std=t(state["y_std"]))


def _restore_fit_basins(gp, state: Dict[str, Any]) -> None:
    bp = state.get("fit_basins_params")
    bf = state.get("fit_basins_nmll")
    if bp is not None and bf is not None and np.size(bp):
        bp = np.atleast_2d(np.asarray(bp, dtype=np.float64))
        bf = np.asarray(bf, dtype=np.float64).reshape(-1)
        gp._fit_basins = [(bp[i], float(bf[i])) for i in range(len(bf))]


def _restore_warp(gp, state: Dict[str, Any]) -> None:
    """Install a state dict's warp parameters (absent-tolerant) and, when
    the GP warps its inputs, refactorize in warp space."""
    log_wa, log_wb = state.get("log_wa"), state.get("log_wb")
    if log_wa is not None and log_wb is not None and np.size(log_wa):
        t = lambda a: torch.as_tensor(np.array(a, dtype=np.float64),
                                      dtype=config.DTYPE, device=gp.device)
        gp.state = gp.state._replace(log_wa=t(log_wa), log_wb=t(log_wb))
        if gp.cfg.input_warp:
            gp.state = refresh(gp.state, gp.cfg)


def _endpoint_basins(all_x, all_f) -> list:
    """``[(log_params, neg_mll)]`` per distinct basin, best-first, from the
    restart endpoints of one fit. All scores are exact float64, so this is
    the JAX package's float64 selection (_f64_select) reduced to sorting."""
    all_x = np.atleast_2d(np.asarray(all_x, dtype=np.float64))
    all_f = np.asarray(all_f, dtype=np.float64).reshape(-1)
    if all_x.size == 0 or not np.isfinite(all_f).any():
        return []
    reps = _basin_representatives(all_x, all_f)
    out = [(np.asarray(all_x[i]), float(all_f[i]))
           for i in reps if np.isfinite(all_f[i])]
    out.sort(key=lambda t: t[1])
    return out


def fit(state: GPState, cfg: GPTrainConfig, x0=None, maxiter: int = 500,
        n_restarts: int = 4, rng=None, optimizer: str = "lbfgs"):
    """Optimize hyperparameters from multi-restart x0 (log space).

    Restarts: the current hyperparameters plus uniform draws inside the log
    bounds from ``rng`` (the warp parameters of the random restarts drawn
    near the identity instead). ``optimizer``: 'lbfgs' (lockstep L-BFGS
    lanes) or 'adam' (lockstep adam lanes), both in float64 on the state's
    device, or 'scipy' (scipy L-BFGS-B per restart on the host, the value
    and gradient on the device). Returns (new_state, info dict with 'mll',
    'params' and 'basins')."""
    if optimizer not in ("lbfgs", "adam", "scipy"):
        raise ValueError(f"Unknown optimizer '{optimizer}' (expected "
                         "'lbfgs', 'adam' or 'scipy')")
    d = state.ndim
    dev, dt = state.x.device, state.x.dtype
    bounds = hyperparam_bounds_log(cfg, d)
    if x0 is None:
        rng = rng if rng is not None else get_numpy_rng()
        cur = [state.log_ls]
        if not cfg.fixed_kernel_variance:
            cur.append(state.log_amp[None])
        if cfg.lengthscale_prior == "SAAS":
            cur.append(state.log_tausq[None])
        if cfg.input_warp:
            zeros = torch.zeros(d, dtype=dt, device=dev)
            cur.append(state.log_wa if state.log_wa is not None else zeros)
            cur.append(state.log_wb if state.log_wb is not None else zeros)
        cur = torch.cat(cur)
        n_hp = bounds.shape[1]
        if n_restarts > 1:
            rand = rng.uniform(bounds[0].numpy(), bounds[1].numpy(),
                               size=(n_restarts - 1, n_hp))
            if cfg.input_warp:
                # random restarts keep the warp near the identity: wild
                # warps with random lengthscales make spuriously deep local
                # optima; the warp's curvature comes from the data
                rand[:, n_hp - 2 * d:] = rng.normal(
                    0.0, 0.1, size=(n_restarts - 1, 2 * d))
            x0 = torch.cat([cur[None, :],
                            torch.as_tensor(rand, dtype=dt, device=dev)])
        else:
            x0 = cur[None, :]
    x0 = torch.as_tensor(x0, dtype=dt, device=dev)

    cap = state.cap
    dsq = None
    if (d * cap * cap * state.x.element_size() <= PERDIM_MAX_BYTES
            and not cfg.input_warp):
        dsq = kr.sq_dist_perdim(state.x)
    obj = lambda lp: neg_mll(state, cfg, lp, dsq_perdim=dsq)
    if optimizer == "scipy":
        best, best_f, all_np, f_np = opt_ops.minimize_scipy_restarts(
            obj, x0, bounds=bounds, maxiter=maxiter, return_all=True)
        new_state = set_hyperparams(state, cfg, best)
        return new_state, {"mll": float(-best_f),
                           "params": best.cpu().numpy(),
                           "basins": _endpoint_basins(all_np, f_np)}
    all_x, all_f = opt_ops.minimize_restarts(
        obj, x0, bounds=bounds.to(dev), method=optimizer, maxiter=maxiter,
        return_all=True)
    all_np = all_x.cpu().numpy()
    f_np = all_f.cpu().numpy()
    i = int(np.argmin(f_np))
    best_f = float(f_np[i])
    if not np.isfinite(best_f):
        raise RuntimeError(
            "GP hyperparameter fit failed: the objective was non-finite at "
            "every restart (degenerate training data or Gram matrix)")
    new_state = set_hyperparams(state, cfg, all_x[i])
    basins = _endpoint_basins(all_np, f_np)
    return new_state, {"mll": -best_f, "params": all_np[i], "basins": basins}


# =====================================================================
# Object facade
# =====================================================================

class GP:
    """Object wrapper over a ``GPState``: capacity growth and host<->device
    marshalling."""

    def __init__(self, train_x, train_y, noise=1e-8, kernel="rbf",
                 optimizer="lbfgs", optimizer_options=None,
                 kernel_variance_bounds=(1e-4, 1e8), lengthscale_bounds=(0.01, 5),
                 lengthscales=None, kernel_variance=None,
                 kernel_variance_prior=None, lengthscale_prior=None,
                 tausq=None, tausq_bounds=(1e-4, 1e4),
                 param_names: Optional[List[str]] = None,
                 input_warp: bool = False, warp_bounds=(0.25, 4.0),
                 device=None):
        if isinstance(train_x, torch.Tensor):
            train_x = train_x.detach().cpu().numpy()
        if isinstance(train_y, torch.Tensor):
            train_y = train_y.detach().cpu().numpy()
        train_x = np.atleast_2d(np.asarray(train_x, dtype=np.float64))
        train_y = np.asarray(train_y, dtype=np.float64).reshape(-1)
        if train_x.shape[0] != train_y.shape[0]:
            raise ValueError("train_x and train_y must have the same number "
                             "of points")
        d = train_x.shape[1]
        self.device = config.resolve_device(device)
        self.param_names = list(param_names) if param_names is not None else [
            f"x_{i}" for i in range(d)]
        self.optimizer_method = optimizer
        self.optimizer_options = dict(optimizer_options or {})

        aliases = {"rbf": "rbf", "matern": "matern", "matern52": "matern"}
        if kernel not in aliases:
            raise ValueError(f"Unknown kernel '{kernel}'; expected one of "
                             f"{sorted(aliases)}")
        self.cfg = GPTrainConfig(
            kernel=aliases[kernel],
            noise=float(noise),
            fixed_kernel_variance=kernel_variance_prior == "fixed",
            lengthscale_prior=_freeze_spec(lengthscale_prior),
            kernel_variance_prior=_freeze_spec(kernel_variance_prior),
            lengthscale_bounds=tuple(float(b) for b in lengthscale_bounds),
            kernel_variance_bounds=tuple(float(b) for b in kernel_variance_bounds),
            tausq_bounds=tuple(float(b) for b in tausq_bounds),
            input_warp=bool(input_warp),
            warp_bounds=tuple(float(b) for b in warp_bounds),
        )

        n = train_x.shape[0]
        cap = _round_capacity(max(n, 1))
        dt, dev = config.DTYPE, self.device
        ls = (np.array(lengthscales, dtype=np.float64).reshape(-1)
              if lengthscales is not None else np.ones(d))
        amp = float(kernel_variance) if kernel_variance is not None else 1.0
        tausq = float(tausq) if tausq is not None else 1.0
        x_pad = np.full((cap, d), 0.5)
        x_pad[:n] = train_x
        y_pad = np.zeros(cap)
        y_pad[:n] = train_y
        t = lambda a: torch.as_tensor(a, dtype=dt, device=dev)
        self.state = GPState(
            x=t(x_pad), y_raw=t(y_pad), n=int(n),
            chol=torch.eye(cap, dtype=dt, device=dev),
            alpha=torch.zeros(cap, dtype=dt, device=dev),
            log_ls=torch.log(t(ls)), log_amp=t(math.log(amp)),
            log_tausq=t(math.log(tausq)),
            y_mean=t(0.0), y_std=t(1.0),
            log_wa=torch.zeros(d, dtype=dt, device=dev),
            log_wb=torch.zeros(d, dtype=dt, device=dev),
        )
        self.state = refresh(self.state, self.cfg)
        self._fit_basins = []

    # ------------------------------------------------------------- properties

    @property
    def ndim(self) -> int:
        return self.state.ndim

    @property
    def npoints(self) -> int:
        return self.state.n

    @property
    def gp_size(self) -> int:
        """Number of active GP training rows."""
        return self.state.n

    @property
    def train_x(self):
        return self.state.x[: self.gp_size]

    @property
    def train_y(self):
        """Standardized targets (n, 1)."""
        n = self.gp_size
        y = (self.state.y_raw[:n] - self.state.y_mean) / self.state.y_std
        return y.reshape(-1, 1)

    @property
    def train_y_raw(self):
        return self.state.y_raw[: self.gp_size]

    @property
    def y_mean(self):
        return self.state.y_mean

    @property
    def y_std(self):
        return self.state.y_std

    @property
    def lengthscales(self):
        return torch.exp(self.state.log_ls)

    @property
    def kernel_variance(self):
        return float(torch.exp(self.state.log_amp))

    @property
    def tausq(self):
        return float(torch.exp(self.state.log_tausq))

    @property
    def noise(self):
        return self.cfg.noise

    @property
    def kernel_name(self):
        return self.cfg.kernel

    @property
    def cholesky(self):
        n = self.gp_size
        return self.state.chol[:n, :n]

    @property
    def alphas(self):
        return self.state.alpha[: self.gp_size].reshape(-1, 1)

    def _as_points(self, x):
        return torch.atleast_2d(torch.as_tensor(x, dtype=config.DTYPE,
                                                device=self.device))

    # ------------------------------------------------------------ prediction

    def _map_chunked(self, fn, x):
        """Apply a batched predict in chunks of config.PREDICT_CHUNK points,
        bounding the (cap, m) intermediates of huge batches."""
        x = self._as_points(x)
        m = x.shape[0]
        chunk = config.PREDICT_CHUNK
        if m <= chunk:
            return fn(x)
        parts = [fn(x[i:i + chunk]) for i in range(0, m, chunk)]
        if isinstance(parts[0], tuple):
            return tuple(torch.cat([p[j] for p in parts])
                         for j in range(len(parts[0])))
        return torch.cat(parts)

    def predict_mean_batched(self, x):
        return self._map_chunked(
            lambda xe: predict_mean(self.state, self.cfg, xe), x)

    def predict_var_batched(self, x):
        return self._map_chunked(
            lambda xe: predict(self.state, self.cfg, xe)[1], x)

    def predict_batched(self, x):
        """Standardized (mean, var) batch — used by acquisition functions."""
        return self._map_chunked(
            lambda xe: predict_raw(self.state, self.cfg, xe), x)

    def predict_mean_single(self, x):
        return self.predict_mean_batched(x)[0]

    def predict_var_single(self, x):
        return self.predict_var_batched(x)[0]

    def predict_single(self, x):
        mean, var = self.predict_batched(x)
        return mean[0], var[0]

    def loo_z_rms(self) -> float:
        return float(_loo_z_rms(self.state))

    def fantasy_var(self, new_x, mc_points, k_train_mc=None):
        """Physical-scale posterior variance at mc_points if new_x were
        added, via the rank-1 identity in ops/fantasy.py. ``k_train_mc`` is
        accepted for API parity and not used."""
        st, cfg = self.state, self.cfg
        ls, amp = torch.exp(st.log_ls), torch.exp(st.log_amp)
        xt = train_coords(st, cfg)
        mc = query_coords(st, cfg, self._as_points(mc_points))
        new = query_coords(st, cfg, self._as_points(new_x).reshape(1, -1))[0]
        V, var_mc = posterior_batch(cfg.kernel, xt, st.mask(), st.chol,
                                    mc, ls, amp, cfg.noise)
        fv = fantasy_var_single(cfg.kernel, xt, st.mask(), st.chol,
                                new, mc, V, var_mc, ls, amp, cfg.noise)
        return fv * st.y_std**2

    # --------------------------------------------------------------- updates

    def _grow_to(self, needed: int):
        cap = _round_capacity(needed)
        st = self.state
        if cap <= st.cap:
            return
        d, old = st.ndim, st.cap
        x_pad = torch.full((cap, d), 0.5, dtype=st.x.dtype, device=self.device)
        x_pad[:old] = st.x
        y_pad = torch.zeros(cap, dtype=st.y_raw.dtype, device=self.device)
        y_pad[:old] = st.y_raw
        chol = torch.eye(cap, dtype=st.chol.dtype, device=self.device)
        chol[:old, :old] = st.chol
        alpha = torch.zeros(cap, dtype=st.alpha.dtype, device=self.device)
        alpha[:old] = st.alpha
        self.state = st._replace(x=x_pad, y_raw=y_pad, chol=chol, alpha=alpha)
        log.debug(f"GP capacity grown to {cap}")

    def update(self, new_x, new_y):
        """Add points (dedupe + incremental Cholesky extension)."""
        new_x = self._as_points(new_x)
        new_y = torch.as_tensor(new_y, dtype=config.DTYPE,
                                device=self.device).reshape(-1)
        with trace.span("gp.extend"):
            self._grow_to(self.gp_size + new_x.shape[0])
            self.state = extend(self.state, self.cfg, new_x, new_y)

    def recompute_cholesky(self):
        self.state = refresh(self.state, self.cfg)

    def fit(self, x0=None, maxiter: int = 500, n_restarts: int = 4, rng=None):
        if x0 is not None:
            x0 = torch.atleast_2d(torch.as_tensor(x0, dtype=config.DTYPE,
                                                  device=self.device))
            n_restarts = x0.shape[0]
        opts = self.optimizer_options
        if opts:
            maxiter = int(opts.get("maxiter", maxiter))
            if x0 is None:
                n_restarts = int(opts.get("n_restarts", n_restarts))
            unknown = set(opts) - {"maxiter", "n_restarts"}
            if unknown and not getattr(self, "_warned_opt_opts", False):
                self._warned_opt_opts = True
                log.warning(f"optimizer_options {sorted(unknown)} are not "
                            "supported and are ignored (supported: maxiter, "
                            "n_restarts)")
        with trace.span("gp.fit", sync=True) as sp:
            sp.count("restarts", n_restarts)
            self.state, info = fit(self.state, self.cfg, x0=x0,
                                   maxiter=maxiter, n_restarts=n_restarts,
                                   rng=rng, optimizer=self.optimizer_method)
        # distinct optimizer basins of this fit, best-first: read by the
        # evidence bounds (samplers.nested_sampling, dlogz_hyp)
        self._fit_basins = info.get("basins") or []
        return info

    def hyp_basins(self, mll_window: float = 8.0, max_basins: int = 4) -> list:
        """``[(log_params, neg_mll)]`` from the last fit, best-first,
        trimmed to basins within ``mll_window`` nats of the optimum."""
        basins = getattr(self, "_fit_basins", None) or []
        if not basins:
            return []
        f0 = basins[0][1]
        return [b for b in basins if b[1] - f0 <= mll_window][:max_basins]

    def predict_mean_with_params(self, log_params, x):
        """Posterior mean at ``x`` under alternate hyperparameters; the live
        state is untouched."""
        st = set_hyperparams(self.state, self.cfg,
                             np.asarray(log_params, dtype=np.float64))
        return self._map_chunked(lambda xe: predict_mean(st, self.cfg, xe), x)

    def update_hyperparams(self, log_params):
        self.state = set_hyperparams(self.state, self.cfg, log_params)

    def neg_mll(self, log_params):
        lp = torch.as_tensor(log_params, dtype=config.DTYPE, device=self.device)
        return neg_mll(self.state, self.cfg, lp)

    @property
    def hyperparam_bounds(self):
        return hyperparam_bounds_log(self.cfg, self.ndim)

    @property
    def num_hyperparams(self):
        return self.hyperparam_bounds.shape[1]

    @property
    def hyperparam_names(self):
        names = ["lengthscales"]
        if not self.cfg.fixed_kernel_variance:
            names.append("kernel_variance")
        if self.cfg.lengthscale_prior == "SAAS":
            names.append("tausq")
        if self.cfg.input_warp:
            # the name groups follow the packed vector of
            # hyperparam_bounds / get_hyperparams
            names.extend(["warp_a", "warp_b"])
        return names

    def get_hyperparams(self):
        hp = [torch.exp(self.state.log_ls)]
        if not self.cfg.fixed_kernel_variance:
            hp.append(torch.exp(self.state.log_amp)[None])
        if self.cfg.lengthscale_prior == "SAAS":
            hp.append(torch.exp(self.state.log_tausq)[None])
        if self.cfg.input_warp:
            hp.append(torch.exp(self.state.log_wa))
            hp.append(torch.exp(self.state.log_wb))
        return torch.cat(hp)

    def hyperparams_dict(self):
        ls = {n: f"{float(v):.4f}" for n, v in
              zip(self.param_names, self.lengthscales.tolist())}
        out = {"lengthscales": ls,
               "kernel_variance": f"{self.kernel_variance:.4f}"}
        if self.cfg.lengthscale_prior == "SAAS":
            out["tausq"] = f"{self.tausq:.4f}"
        return out

    def get_random_point(self, rng=None, nstd=None):
        rng = rng if rng is not None else get_numpy_rng()
        return rng.uniform(0.0, 1.0, size=self.ndim)

    # --------------------------------------------------------- serialization

    def state_dict(self) -> Dict[str, Any]:
        """State dict in the JAX package's layout; train_y unstandardized."""
        n = self.gp_size
        np_ = lambda t: t.detach().cpu().numpy()
        return {
            "train_x": np_(self.train_x),
            "train_y": np_(self.train_y_raw).reshape(-1, 1),
            "lengthscales": np_(self.lengthscales),
            "kernel_variance": float(self.kernel_variance),
            "noise": float(self.cfg.noise),
            "tausq": float(self.tausq),
            "y_mean": float(self.state.y_mean),
            "y_std": float(self.state.y_std),
            "kernel_name": self.cfg.kernel,
            "lengthscale_prior_spec": _thaw_spec(self.cfg.lengthscale_prior),
            "kernel_variance_prior_spec": _thaw_spec(self.cfg.kernel_variance_prior),
            "fixed_kernel_variance": self.cfg.fixed_kernel_variance,
            "optimizer_method": self.optimizer_method,
            "optimizer_options": self.optimizer_options,
            "lengthscale_bounds": list(self.cfg.lengthscale_bounds),
            "kernel_variance_bounds": list(self.cfg.kernel_variance_bounds),
            "tausq_bounds": list(self.cfg.tausq_bounds),
            "cholesky": np_(self.state.chol[:n, :n]),
            "alphas": np_(self.state.alpha[:n]).reshape(-1, 1),
            "ndim": self.ndim,
            "gp_class": "GP",
            "param_names": list(self.param_names),
            "input_warp": bool(self.cfg.input_warp),
            "warp_bounds": list(self.cfg.warp_bounds),
            "log_wa": (None if self.state.log_wa is None
                       else np_(self.state.log_wa)),
            "log_wb": (None if self.state.log_wb is None
                       else np_(self.state.log_wb)),
            "fit_basins_params": np.asarray(
                [p for p, _ in getattr(self, "_fit_basins", [])],
                dtype=np.float64),
            "fit_basins_nmll": np.asarray(
                [f for _, f in getattr(self, "_fit_basins", [])],
                dtype=np.float64),
        }

    @classmethod
    def from_state_dict(cls, state: Dict[str, Any], device=None) -> "GP":
        ls_prior = state.get("lengthscale_prior_spec")
        if isinstance(ls_prior, np.ndarray):
            ls_prior = ls_prior.item()
        kv_prior = state.get("kernel_variance_prior_spec")
        if isinstance(kv_prior, np.ndarray):
            kv_prior = kv_prior.item()
        gp = cls(
            train_x=state["train_x"],
            train_y=state["train_y"],
            noise=state["noise"],
            kernel=str(state["kernel_name"]),
            optimizer=str(state.get("optimizer_method", "lbfgs")),
            optimizer_options=state.get("optimizer_options") or {},
            lengthscales=state["lengthscales"],
            kernel_variance=state["kernel_variance"],
            lengthscale_bounds=tuple(np.asarray(state["lengthscale_bounds"]).tolist()),
            kernel_variance_bounds=tuple(np.asarray(state["kernel_variance_bounds"]).tolist()),
            kernel_variance_prior=kv_prior,
            lengthscale_prior=ls_prior,
            tausq=state.get("tausq", 1.0),
            tausq_bounds=tuple(np.asarray(state.get("tausq_bounds", (1e-4, 1e4))).tolist()),
            input_warp=bool(state.get("input_warp", False)),
            warp_bounds=tuple(np.asarray(
                state.get("warp_bounds", (0.25, 4.0))).tolist()),
            param_names=(list(np.asarray(state["param_names"]).tolist())
                         if state.get("param_names") is not None else None),
            device=device,
        )
        _restore_warp(gp, state)
        _restore_fit_basins(gp, state)
        return gp

    def save(self, filename: str = "gp"):
        if not filename.endswith(".npz"):
            filename += ".npz"
        sd = self.state_dict()
        atomic_write(
            filename,
            lambda f: np.savez(f, **{
                k: np.asarray(v, dtype=object)
                if isinstance(v, (dict, type(None))) else v
                for k, v in sd.items()}),
            binary=True)
        log.info(f"Saved GP state to {filename}")

    @classmethod
    def load(cls, filename: str, device=None, **kwargs) -> "GP":
        """Load an npz written by ``GP.save`` of either package."""
        if not filename.endswith(".npz"):
            filename += ".npz"
        data = np.load(filename, allow_pickle=True)
        state = {}
        for key in data.files:
            v = data[key]
            state[key] = v.item() if isinstance(v, np.ndarray) and v.shape == () else v
        state.update(kwargs)
        gp = cls.from_state_dict(state, device=device)
        log.info(f"Loaded GP from {filename} with {gp.npoints} training points")
        return gp

    def copy(self) -> "GP":
        return self.__class__.from_state_dict(self.state_dict(),
                                              device=self.device)

    @classmethod
    def dummy_like(cls, other: "GP") -> "GP":
        """Plain-GP clone sharing the same padded state (no O(cap^3)
        rebuild), for greedy-batch hallucination. Later ``update`` calls
        build new tensors, so the shared state is never modified."""
        gp = object.__new__(GP)
        gp.device = other.device
        gp.param_names = list(other.param_names)
        gp.optimizer_method = other.optimizer_method
        gp.optimizer_options = dict(other.optimizer_options)
        # priors and bounds do not shape K, the warp does: the shared
        # Cholesky factor lives in warp space
        gp.cfg = GPTrainConfig(kernel=other.cfg.kernel, noise=other.cfg.noise,
                               input_warp=other.cfg.input_warp,
                               warp_bounds=other.cfg.warp_bounds)
        gp.state = other.state
        gp._fit_basins = []
        return gp


def state_from_numpy(sd: Dict[str, Any], device=None) -> GP:
    """The port's ``GP`` (or ``GPwithClassifier``, by the dict's
    ``gp_class``) from a state dict of numpy values, such as the JAX
    package's ``state_dict()``, refreshed on ``device``."""
    gp_class = sd.get("gp_class", "GP")
    if isinstance(gp_class, np.ndarray):
        gp_class = gp_class.item()
    if gp_class == "GPwithClassifier":
        from .clf_gp import GPwithClassifier

        return GPwithClassifier.from_state_dict(sd, device=device)
    return GP.from_state_dict(sd, device=device)
