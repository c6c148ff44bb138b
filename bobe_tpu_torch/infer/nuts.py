"""No-U-Turn Sampler over a batch of chains, and the HMC helpers it shares
with the ensemble sampler (infer/ehmc.py).

Counterpart of ``bobe_tpu/infer/nuts.py``: multinomial NUTS (Betancourt
2017, arXiv:1701.02434) with the iterative U-turn checkpoints of the
Stan/numpyro lineage, Stan's windowed warmup (dual-averaging step size,
target accept 0.8, and a diagonal or dense mass matrix from Welford moments
in doubling windows).

Every array carries a leading chain axis (C, d): the JAX package vmaps a
single-chain program, the port writes the batch out. The JAX package's
``while_loop``s become host loops that run while any chain is active:

* the tree doublings of a transition read "any chain still active" once per
  doubling after the first, so a transition costs at most ``max_depth - 1``
  host syncs;
* a subtree runs all its 2**depth leaves; a chain whose subtree has turned
  or diverged is masked out of the remaining leaves (its state is frozen, as
  a finished lane of a vmapped ``while_loop`` is), so the masks change
  nothing in any chain's result.

Random numbers: each chain draws from its own ``torch.Generator`` (the
counterpart of the JAX package's per-chain keys), a fixed block per
transition, so what a chain draws does not depend on the other chains and a
chain run in a batch gives the same result as the chain run alone.

The warmup schedule is a host boolean array, so a mass-matrix update is a
plain Python ``if``.
"""
from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

MAX_DELTA_ENERGY = 1000.0
LOG_HALF = math.log(0.5)


# ---------------------------------------------------------------- mass matrix

class MassMatrix(NamedTuple):
    """Diagonal (inv (..., d), chol_mass (..., d) = 1/sqrt(inv)) or dense
    (inv (..., d, d), chol_mass (..., d, d) = the inverse Cholesky factor of
    inv). A leading chain axis is optional: the ensemble shares one."""

    inv: torch.Tensor
    chol_mass: torch.Tensor


def _mass_from_cov(cov, dense: bool, reg_n) -> MassMatrix:
    """Regularized mass-matrix estimate from a sample covariance (Stan's
    shrinkage: cov * n/(n+5) + 1e-3 * 5/(n+5) * I). ``cov`` may carry
    leading batch axes; ``reg_n`` is the sample count."""
    shrink = reg_n / (reg_n + 5.0)
    if dense:
        d = cov.shape[-1]
        eye = torch.eye(d, dtype=cov.dtype, device=cov.device)
        reg = cov * shrink + 1e-3 * (1.0 - shrink) * eye
        # mass = reg^-1 = Li^T Li with Li = inv(chol(reg)); p = Li^T eps
        L = torch.linalg.cholesky(reg)
        Li = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
        return MassMatrix(inv=reg, chol_mass=Li)
    var = cov * shrink + 1e-3 * (1.0 - shrink)
    return MassMatrix(inv=var, chol_mass=1.0 / torch.sqrt(var))


def _identity_mass(d, dense, dtype, device, batch=()) -> MassMatrix:
    if dense:
        eye = torch.eye(d, dtype=dtype, device=device).expand(*batch, d, d)
        return MassMatrix(eye.clone(), eye.clone())
    ones = torch.ones((*batch, d), dtype=dtype, device=device)
    return MassMatrix(ones, ones.clone())


def _sample_momentum(noise, mass: MassMatrix, dense: bool):
    """Momenta (C, d) ~ N(0, mass) from standard normal draws (C, d)."""
    if dense:
        # chol_mass holds Li = inv(chol(inv_mass)): Li^T eps has covariance
        # Li^T Li = mass
        return torch.matmul(mass.chol_mass.transpose(-1, -2),
                            noise[..., None])[..., 0]
    return mass.chol_mass * noise


def _psharp(p, mass: MassMatrix, dense: bool):
    """inv_mass @ p per chain, p (C, d)."""
    if dense:
        return torch.matmul(mass.inv, p[..., None])[..., 0]
    return mass.inv * p


def _kinetic(p, mass: MassMatrix, dense: bool):
    return 0.5 * torch.sum(p * _psharp(p, mass, dense), dim=-1)


# ------------------------------------------------------------------- leapfrog

def _leapfrog(vg: Callable, z, p, grad, eps, mass: MassMatrix, dense: bool,
              half=None):
    """One leapfrog step of every chain. ``eps`` is 0-d (shared) or (C, 1)
    (per chain), ``half`` is 0.5 * eps when the caller has it; ``vg(z)``
    returns (logp (C,), grad (C, d))."""
    half = 0.5 * eps if half is None else half
    p_half = torch.addcmul(p, half, grad)
    z_new = torch.addcmul(z, eps, _psharp(p_half, mass, dense))
    logp_new, grad_new = vg(z_new)
    return z_new, torch.addcmul(p_half, half, grad_new), logp_new, grad_new


# ----------------------------------------------------------------- adaptation

class DualAveraging(NamedTuple):
    log_eps: torch.Tensor
    log_eps_avg: torch.Tensor
    h_avg: torch.Tensor
    mu: torch.Tensor
    t: torch.Tensor


def _da_init(eps0) -> DualAveraging:
    # log_eps_avg starts at log(eps0), not 0: with zero adaptation steps the
    # final step size is eps0 itself (a warm-started eps survives
    # num_warmup=0); the first update overwrites the average (w = 1 at t=1)
    log_eps = torch.log(eps0)
    return DualAveraging(log_eps, log_eps, torch.zeros_like(log_eps),
                         math.log(10.0) + log_eps, torch.zeros_like(log_eps))


def _da_update(da: DualAveraging, accept_stat, target=0.8, gamma=0.05,
               t0=10.0, kappa=0.75) -> DualAveraging:
    t = da.t + 1.0
    h_avg = (1.0 - 1.0 / (t + t0)) * da.h_avg + (target - accept_stat) / (t + t0)
    log_eps = da.mu - torch.sqrt(t) / gamma * h_avg
    w = t ** (-kappa)
    log_eps_avg = w * log_eps + (1.0 - w) * da.log_eps_avg
    return DualAveraging(log_eps, log_eps_avg, h_avg, da.mu, t)


class Welford(NamedTuple):
    n: float                 # sample count, the same for every chain (host)
    mean: torch.Tensor       # (C, d)
    m2: torch.Tensor         # (C, d) or (C, d, d)


def _welford_init(C, d, dense, dtype, device) -> Welford:
    shape = (C, d, d) if dense else (C, d)
    return Welford(0.0, torch.zeros((C, d), dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def _welford_update(w: Welford, x, dense) -> Welford:
    n = w.n + 1.0
    delta = x - w.mean
    mean = w.mean + delta / n
    delta2 = x - mean
    m2 = w.m2 + (delta[..., :, None] * delta2[..., None, :] if dense
                 else delta * delta2)
    return Welford(n, mean, m2)


def _welford_cov(w: Welford):
    return w.m2 / max(w.n - 1.0, 1.0)


def _warmup_schedule(num_warmup: int) -> np.ndarray:
    """Stan-style three-phase schedule: a host bool array of length
    num_warmup, True where a slow window ends and the mass matrix is
    re-estimated. Empty for num_warmup=0 (where the JAX package's indexes
    past the end and raises)."""
    if num_warmup <= 0:
        return np.zeros(0, dtype=bool)
    init_buffer, term_buffer, base_window = 75, 50, 25
    if num_warmup < init_buffer + term_buffer + base_window:
        init_buffer = max(1, int(0.15 * num_warmup))
        term_buffer = max(1, int(0.1 * num_warmup))
        base_window = max(1, num_warmup - init_buffer - term_buffer)
    is_mass = np.zeros(num_warmup, dtype=bool)
    start = init_buffer
    w = base_window
    while start + w < num_warmup - term_buffer:
        is_mass[start + w - 1] = True
        start += w
        w *= 2
    is_mass[max(0, num_warmup - term_buffer - 1)] = True
    return is_mass


def _find_reasonable_eps(vg, z, noise, mass, dense, logp=None, grad=None):
    """Heuristic initial step size per chain: double or halve until the
    one-step acceptance crosses 0.5 (Hoffman & Gelman, Algorithm 4).
    ``noise`` (C, d): the momentum draws. One host sync per step of the
    search."""
    if logp is None:
        logp, grad = vg(z)
    p = _sample_momentum(noise, mass, dense)
    H0 = -logp + _kinetic(p, mass, dense)

    def log_ratio(eps):
        _, p1, logp1, _ = _leapfrog(vg, z, p, grad, eps[:, None], mass, dense)
        return H0 - (-logp1 + _kinetic(p1, mass, dense))

    eps = torch.ones(z.shape[0], dtype=z.dtype, device=z.device)
    ratio = log_ratio(eps)
    up = ratio > LOG_HALF
    factor = torch.where(up, 2.0, 0.5).to(z.dtype)
    active = torch.ones_like(up)
    for it in range(61):
        keep = torch.where(up, ratio > LOG_HALF, ratio < LOG_HALF)
        active = active & keep & torch.isfinite(ratio)
        if it == 60 or not bool(active.any()):
            break
        eps = torch.where(active, eps * factor, eps)
        ratio = log_ratio(eps)
    return torch.clamp(eps, 1e-6, 1e3)


# --------------------------------------------------------------- tree building

def _uniform_block(max_depth: int) -> int:
    """Uniform draws per chain per transition: a direction and a swap per
    doubling, and one per leaf of every subtree (2**depth leaves at
    doubling ``depth``)."""
    return 2 * max_depth + 2 ** max_depth - 1


def _trailing_levels(m: int, levels: int) -> int:
    """Number of aligned subtree levels j in [0, levels) with 2**(j+1)
    dividing m (every level for m = 0)."""
    if m == 0:
        return levels
    return min(levels, (m & -m).bit_length() - 1)


class _Subtree(NamedTuple):
    prop: torch.Tensor        # the proposal, packed [z | grad | logp]
    lw: torch.Tensor          # logsumexp of the leaf weights
    last: torch.Tensor        # the far endpoint, packed [z | grad | logp | p]
    rho: torch.Tensor         # sum of the leaves' momenta
    stop: torch.Tensor        # turned or diverged
    diverging: torch.Tensor
    sum_accept: torch.Tensor
    n_leaves: torch.Tensor


def _pack(z, grad, logp, p):
    """A chain state as one (C, 3d + 1) row, [z | grad | logp | p], so one
    ``where`` selects all of it."""
    return torch.cat([z, grad, logp[:, None], p], dim=1)


def _build_subtree(vg, log_u, n_steps, start, eps, mass, dense, H0, live,
                   max_depth) -> _Subtree:
    """A subtree of ``n_steps`` leapfrog leaves beyond ``start`` (packed)
    for every chain; ``live`` (C,) masks the chains that build one, and a
    chain stops (is masked) after the leaf where its subtree turns or
    diverges. ``log_u`` (C, n_steps): the leaves' log-uniforms; ``eps``
    (C, 1) signed. The U-turn checks of every aligned sub-subtree use
    checkpoint buffers of inv_mass @ p and the prefix momentum sums
    (max_depth + 1 levels)."""
    C, w = start.shape
    d = (w - 1) // 3
    D = max_depth + 1
    dt, dev = start.dtype, start.device
    half = 0.5 * eps
    cur = start
    prop = start[:, :2 * d + 1]
    lw = torch.full((C,), -math.inf, dtype=dt, device=dev)
    rho = torch.zeros((C, d), dtype=dt, device=dev)
    stop = torch.zeros((C,), dtype=torch.bool, device=dev)
    diverging = torch.zeros_like(stop)
    sum_accept = torch.zeros((C,), dtype=dt, device=dev)
    n_leaves = torch.zeros((C,), dtype=dt, device=dev)
    ps_ck = torch.zeros((C, D, d), dtype=dt, device=dev)
    r_ck = torch.zeros((C, D, d), dtype=dt, device=dev)
    for m in range(n_steps):
        if m:
            live = live & ~stop
        z_new, p_new, logp_new, grad_new = _leapfrog(
            vg, cur[:, :d], cur[:, 2 * d + 1:], cur[:, d:2 * d], eps, mass,
            dense, half)
        ps_new = _psharp(p_new, mass, dense)
        # checkpoints where leaf m is the left boundary of an aligned
        # subtree: its momentum, and the prefix sum that excludes it
        nb = _trailing_levels(m, D)
        if nb:
            ps_ck[:, :nb] = ps_new[:, None, :]
            r_ck[:, :nb] = rho[:, None, :]
        delta = (0.5 * torch.linalg.vecdot(p_new, ps_new) - logp_new) - H0
        # NaN-safe: a NaN energy counts as a divergence
        ok_leaf = delta <= MAX_DELTA_ENERGY
        div_leaf = ~ok_leaf
        lw_leaf = torch.where(ok_leaf, -delta, -math.inf)
        accept_leaf = torch.exp(torch.clamp(lw_leaf, max=0.0))
        rho_new = rho + p_new
        # U-turn checks of every aligned subtree that ends at this leaf
        ne = _trailing_levels(m + 1, D)
        if ne:
            rho_sub = rho_new[:, None, :] - r_ck[:, :ne]
            turn = (torch.linalg.vecdot(ps_ck[:, :ne], rho_sub) <= 0.0) | \
                (torch.linalg.vecdot(rho_sub, ps_new[:, None, :]) <= 0.0)
            stop_now = torch.any(turn, dim=1) | div_leaf
        else:
            stop_now = div_leaf
        # progressive multinomial proposal within the subtree
        lw_tot = torch.logaddexp(lw, lw_leaf)
        take = live & (log_u[:, m] < lw_leaf - lw_tot)
        new = _pack(z_new, grad_new, logp_new, p_new)
        prop = torch.where(take[:, None], new[:, :2 * d + 1], prop)
        lw = torch.where(live, lw_tot, lw)
        rho = torch.where(live[:, None], rho_new, rho)
        live_f = live.to(dt)
        sum_accept = torch.addcmul(sum_accept, accept_leaf, live_f)
        n_leaves = n_leaves + live_f
        stop = stop | (live & stop_now)
        diverging = diverging | (live & div_leaf)
        cur = torch.where(live[:, None], new, cur)
    return _Subtree(prop, lw, cur, rho, stop, diverging, sum_accept, n_leaves)


class NutsCarry(NamedTuple):
    z: torch.Tensor     # (C, d)
    logp: torch.Tensor  # (C,)
    grad: torch.Tensor  # (C, d)


def nuts_step(vg, noise, u, state: NutsCarry, eps, mass: MassMatrix,
              dense: bool, max_depth: int):
    """One NUTS transition of every chain. ``noise`` (C, d) standard normal
    momentum draws, ``u`` (C, _uniform_block(max_depth)) uniforms, ``eps``
    (C,). Returns (new_state, accept_stat (C,), diverging (C,), leapfrog
    steps run in lockstep)."""
    z, logp, grad = state
    d = z.shape[1]
    log_u = torch.log(u)
    p0 = _sample_momentum(noise, mass, dense)
    H0 = -logp + _kinetic(p0, mass, dense)

    minus = plus = _pack(z, grad, logp, p0)
    prop = plus[:, :2 * d + 1]
    lw = torch.zeros_like(logp)  # weight of the initial point: exp(0) = 1
    rho = p0
    turning = torch.zeros(z.shape[0], dtype=torch.bool, device=z.device)
    diverging = torch.zeros_like(turning)
    sum_accept = torch.zeros_like(logp)
    n_leaves = torch.zeros_like(logp)
    active = ~turning
    steps = 0
    for depth in range(max_depth):
        if depth:
            active = ~(turning | diverging)
            if not bool(active.any()):
                break
        go_right = u[:, depth] < 0.5
        gr = go_right[:, None]
        n_steps = 2 ** depth
        off = 2 * max_depth + n_steps - 1
        sub = _build_subtree(
            vg, log_u[:, off:off + n_steps], n_steps,
            torch.where(gr, plus, minus),
            torch.where(go_right, eps, -eps)[:, None], mass, dense, H0,
            active, max_depth)
        steps += n_steps
        # biased progressive sampling across the doubling; a chain that was
        # not active built an empty subtree (lw = -inf, rho = 0, the far
        # endpoint where it started), so every update below leaves it as it
        # was
        ok = ~sub.stop
        take = ok & (log_u[:, max_depth + depth] < sub.lw - lw)
        prop = torch.where(take[:, None], sub.prop, prop)
        lw = torch.where(ok, torch.logaddexp(lw, sub.lw), lw)
        rho = rho + sub.rho
        plus = torch.where(gr, sub.last, plus)
        minus = torch.where(gr, minus, sub.last)
        turning_full = (
            (torch.linalg.vecdot(_psharp(minus[:, 2 * d + 1:], mass, dense),
                                 rho) <= 0.0)
            | (torch.linalg.vecdot(_psharp(plus[:, 2 * d + 1:], mass, dense),
                                   rho) <= 0.0))
        # a diverged subtree ends the transition as a turned one does
        turning = turning | (active & (sub.stop | turning_full))
        diverging = diverging | sub.diverging
        sum_accept = sum_accept + sub.sum_accept
        n_leaves = n_leaves + sub.n_leaves
    accept = sum_accept / torch.clamp(n_leaves, min=1.0)
    return (NutsCarry(prop[:, :d], prop[:, 2 * d], prop[:, d:2 * d]), accept,
            diverging, steps)


# ------------------------------------------------------------------ top level

def _draw(gens: List[torch.Generator], shape, normal: bool, device):
    """One draw of ``shape`` per chain from each chain's own generator,
    stacked to (C, *shape)."""
    fn = torch.randn if normal else torch.rand
    return torch.stack([fn(shape, generator=g, dtype=torch.float64,
                           device=device) for g in gens])


def run_chain(vg, init_z, gens: List[torch.Generator], num_warmup=512,
              num_samples=1024, thinning=4, dense_mass=True, max_depth=6,
              warm: Optional[tuple] = None, adapt_mass=True):
    """Warmup and sampling for C chains, ``init_z`` (C, d), chain c drawing
    from ``gens[c]``. ``vg(z)`` maps (C, d) to (logp (C,), grad (C, d)).

    ``warm`` with ``adapt_mass=False``: per-chain (eps (C,), mass_inv,
    mass_chol) from an earlier run on a nearby target; the mass is fixed and
    only the step size re-adapts over ``num_warmup``. NUTS leaves the target
    invariant for any mass and step size, so reuse affects efficiency, not
    correctness.

    Returns (samples (C, kept, d), logps (C, kept), diagnostics): per-chain
    mean_accept, n_divergent and step_size, the adapted mass, last_z, and
    ``n_leapfrog``, the leapfrog steps run in lockstep (host int)."""
    C, d = init_z.shape
    dt, dev = init_z.dtype, init_z.device
    n_unif = _uniform_block(max_depth)
    logp, grad = vg(init_z)
    steps = 0
    if warm is not None and not adapt_mass:
        eps_w, mass_inv, mass_chol = warm
        mass = MassMatrix(mass_inv, mass_chol)
        eps0 = torch.clamp(eps_w, 1e-6, 1e3)
    else:
        mass = _identity_mass(d, dense_mass, dt, dev, (C,))
        eps0 = _find_reasonable_eps(vg, init_z, _draw(gens, (d,), True, dev),
                                    mass, dense_mass, logp, grad)
    da = _da_init(eps0)
    state = NutsCarry(init_z, logp, grad)
    is_mass_update = (_warmup_schedule(num_warmup) if adapt_mass
                      else np.zeros(num_warmup, dtype=bool))

    wf = _welford_init(C, d, dense_mass, dt, dev)
    for upd_mass in is_mass_update:
        state, accept, _, n = nuts_step(
            vg, _draw(gens, (d,), True, dev), _draw(gens, (n_unif,), False, dev),
            state, torch.exp(da.log_eps), mass, dense_mass, max_depth)
        steps += n
        da = _da_update(da, accept)
        wf = _welford_update(wf, state.z, dense_mass)
        if upd_mass:
            mass = _mass_from_cov(_welford_cov(wf), dense_mass, wf.n)
            # restart step-size adaptation around the current average
            da = _da_init(torch.exp(da.log_eps_avg))
            wf = _welford_init(C, d, dense_mass, dt, dev)
    eps_final = torch.exp(da.log_eps_avg)

    zs, logps = [], []
    sum_accept = torch.zeros(C, dtype=dt, device=dev)
    n_div = torch.zeros(C, dtype=torch.long, device=dev)
    for i in range(num_samples):
        state, accept, div, n = nuts_step(
            vg, _draw(gens, (d,), True, dev), _draw(gens, (n_unif,), False, dev),
            state, eps_final, mass, dense_mass, max_depth)
        steps += n
        sum_accept = sum_accept + accept
        n_div = n_div + div.long()
        if (i + 1) % thinning == 0:
            zs.append(state.z)
            logps.append(state.logp)
    zs = torch.stack(zs, dim=1) if zs else init_z.new_zeros((C, 0, d))
    logps = torch.stack(logps, dim=1) if logps else init_z.new_zeros((C, 0))
    diag = {"mean_accept": sum_accept / max(num_samples, 1),
            "n_divergent": n_div, "step_size": eps_final,
            "mass_inv": mass.inv, "mass_chol": mass.chol_mass,
            "last_z": state.z, "n_leapfrog": steps}
    return zs, logps, diag
