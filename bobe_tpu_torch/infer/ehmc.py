"""Ensemble jittered HMC: many short chains advanced in lockstep.

Counterpart of ``bobe_tpu/infer/ehmc.py``, the default MC-pool refresh of
the BO loop. C chains (64 by default) take fixed-length jittered
trajectories together, so every leapfrog step evaluates the GP mean and its
gradient at one (C, d) batch; one step size (dual averaging on the
cross-chain mean acceptance) and one mass matrix (from the cross-chain
moments) are shared by all chains; a warm start reuses the adapted kernel
and the chain ends of the previous refresh. Every transition is a per-chain
Metropolis-adjusted HMC step, so the kernel leaves the target invariant
whatever the adapted step size and mass.

The shared trajectory lengths are drawn up front on the host, from a CPU
generator seeded by the call's own generator, so the leapfrog loop count is
known without reading the device; dual averaging and the moment sums stay on
the device, and the loop over transitions reads nothing back.
"""
from __future__ import annotations

import torch

from .nuts import (
    MassMatrix,
    _da_init,
    _da_update,
    _find_reasonable_eps,
    _identity_mass,
    _kinetic,
    _leapfrog,
    _mass_from_cov,
    _sample_momentum,
    _warmup_schedule,
)


def _ensemble_transition(vg, noise, log_u, z, logp, grad, eps, n_leap, mass,
                         dense):
    """One jittered-HMC transition of all C chains in lockstep: ``n_leap``
    (host int) leapfrog steps at the shared ``eps`` (0-d) from momenta drawn
    from ``noise`` (C, d), then a per-chain accept on ``log_u`` (C,).
    Returns (z, logp, grad, accept_prob (C,), diverged (C,))."""
    p0 = _sample_momentum(noise, mass, dense)
    H0 = -logp + _kinetic(p0, mass, dense)
    z1, p1, logp1, grad1 = z, p0, logp, grad
    half = 0.5 * eps
    for _ in range(n_leap):
        z1, p1, logp1, grad1 = _leapfrog(vg, z1, p1, grad1, eps, mass, dense,
                                         half)
    delta = H0 - (-logp1 + _kinetic(p1, mass, dense))
    # NaN-safe: a NaN or huge-energy trajectory rejects (NaN > x is False)
    diverged = ~(delta > -1000.0)
    accept_prob = torch.where(diverged, 0.0,
                              torch.exp(torch.clamp(delta, max=0.0)))
    acc = (log_u < delta) & ~diverged
    z = torch.where(acc[:, None], z1, z)
    logp = torch.where(acc, logp1, logp)
    grad = torch.where(acc[:, None], grad1, grad)
    return z, logp, grad, accept_prob, diverged


def run_ensemble(vg, init_z, generator: torch.Generator, num_warmup=128,
                 num_samples=8, thinning=2, dense_mass=True, num_leapfrog=16,
                 warm=None, adapt_mass=True):
    """Warmup and sampling for a C-chain lockstep ensemble.

    ``init_z`` (C, d) chain starts; ``vg(z)`` maps (C, d) to (logp (C,),
    grad (C, d)). ``warm=(eps, mass_inv, mass_chol)`` with
    ``adapt_mass=False`` fixes the mass and re-adapts only the step size
    over the (short) ``num_warmup``: the warm BO refresh. Returns (zs
    (num_samples, C, d), logps (num_samples, C), diag) with mean_accept,
    n_divergent, step_size, the mass, last_z, and ``n_leapfrog`` (host
    int): the lockstep leapfrog steps of the call, ``n_leapfrog_warmup``
    those of its warmup."""
    C, d = init_z.shape
    dt, dev = init_z.dtype, init_z.device
    n_trans = num_warmup + num_samples * thinning
    seed = int(torch.randint(0, 2**62, (1,), generator=generator,
                             device=generator.device).item())
    host = torch.Generator().manual_seed(seed)
    n_leaps = torch.randint(1, num_leapfrog + 1, (n_trans,),
                            generator=host).tolist()

    def draws():
        noise = torch.randn((C, d), generator=generator, dtype=dt, device=dev)
        u = torch.rand((C,), generator=generator, dtype=dt, device=dev)
        return noise, torch.log(u)

    logp, grad = vg(init_z)
    n_leapfrog = sum(n_leaps)
    if warm is not None and not adapt_mass:
        eps_w, mass_inv, mass_chol = warm
        mass = MassMatrix(mass_inv, mass_chol)
        eps0 = torch.clamp(eps_w, 1e-6, 1e3)
    else:
        mass = _identity_mass(d, dense_mass, dt, dev)
        # anchor the step-size search at the best-logp start: the
        # cross-chain mean can sit between modes where the gradient vanishes
        i = torch.argmax(logp)
        noise = torch.randn((1, d), generator=generator, dtype=dt, device=dev)
        eps0 = _find_reasonable_eps(vg, init_z[i][None], noise, mass,
                                    dense_mass)[0]
    da = _da_init(eps0)
    is_mass_update = (_warmup_schedule(num_warmup) if adapt_mass
                      else [False] * num_warmup)

    # cross-chain, in-window moment sums: cov = s2/n - mean mean^T
    def mom0():
        return (torch.zeros((d,), dtype=dt, device=dev),
                torch.zeros((d, d) if dense_mass else (d,), dtype=dt,
                            device=dev), 0.0)

    z = init_z
    s1, s2, n = mom0()
    for t, upd_mass in enumerate(is_mass_update):
        noise, log_u = draws()
        z, logp, grad, acc_p, _ = _ensemble_transition(
            vg, noise, log_u, z, logp, grad, torch.exp(da.log_eps),
            n_leaps[t], mass, dense_mass)
        da = _da_update(da, torch.mean(acc_p))
        s1 = s1 + torch.sum(z, dim=0)
        s2 = s2 + (z.T @ z if dense_mass else torch.sum(z * z, dim=0))
        n += C
        if upd_mass:
            mean = s1 / n
            cov = s2 / n - (torch.outer(mean, mean) if dense_mass
                            else mean * mean)
            mass = _mass_from_cov(cov, dense_mass, n)
            da = _da_init(torch.exp(da.log_eps_avg))
            s1, s2, n = mom0()
    eps_final = torch.exp(da.log_eps_avg)

    zs, logps = [], []
    sum_acc = torch.zeros((), dtype=dt, device=dev)
    n_div = torch.zeros((), dtype=torch.long, device=dev)
    for i in range(num_samples * thinning):
        noise, log_u = draws()
        z, logp, grad, acc_p, div = _ensemble_transition(
            vg, noise, log_u, z, logp, grad, eps_final,
            n_leaps[num_warmup + i], mass, dense_mass)
        sum_acc = sum_acc + torch.sum(acc_p)
        n_div = n_div + torch.sum(div)
        if (i + 1) % thinning == 0:
            zs.append(z)
            logps.append(logp)
    diag = {"mean_accept": sum_acc / max(C * num_samples * thinning, 1),
            "n_divergent": n_div, "step_size": eps_final,
            "mass_inv": mass.inv, "mass_chol": mass.chol_mass, "last_z": z,
            "n_leapfrog": n_leapfrog,
            "n_leapfrog_warmup": sum(n_leaps[:num_warmup])}
    return torch.stack(zs), torch.stack(logps), diag
