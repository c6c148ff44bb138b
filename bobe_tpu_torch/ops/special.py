"""Numerically stable special functions of the EI / LogEI acquisitions.

Counterpart of ``bobe_tpu/ops/special.py``, with the same branches (the cut
of ``erfcx`` at 2 and its 60-level continued fraction, the two sides of
``log1mexp``, the LogEI tail at -1/sqrt(eps)), so that the two packages
agree to roundoff and not only to scipy.
"""
from __future__ import annotations

import math

import torch

_LOG2 = 0.6931471805599453
_CF_DEPTH = 60
_CF_CUT = 2.0
_HALF_SQRT2 = 0.5 * math.sqrt(2.0)


def erfcx(x):
    """Scaled complementary error function exp(x^2) erfc(x): the definition
    below 2, the Laplace continued fraction
    pi^{-1/2} / (x + (1/2)/(x + 1/(x + (3/2)/(x + ...)))) with 60 levels,
    evaluated bottom-up, from 2 on."""
    xs = torch.clamp(x, max=_CF_CUT)  # exp(x^2) stays finite off its branch
    direct = torch.exp(xs * xs) * torch.special.erfc(xs)
    xl = torch.clamp(x, min=_CF_CUT)
    r = torch.zeros_like(xl)
    for k in range(_CF_DEPTH, 0, -1):
        r = (0.5 * k) / (xl + r)
    cf = (1.0 / math.sqrt(math.pi)) / (xl + r)
    return torch.where(x < _CF_CUT, direct, cf)


def log1mexp(x):
    """log(1 - exp(x)) for x < 0, stable near both 0 and -inf."""
    big = torch.where(x > -_LOG2, x, torch.full_like(x, -_LOG2))
    small = torch.where(x <= -_LOG2, x, torch.full_like(x, -2.0 * _LOG2))
    return torch.where(x > -_LOG2, torch.log(-torch.expm1(big)),
                       torch.log1p(-torch.exp(small)))


def _norm_pdf(u):
    return torch.exp(-(math.log(2.0 * math.pi) + u * u) / 2.0)


def _ndtr(u):
    """Standard normal CDF, by the branches of jax.scipy.special.ndtr."""
    w = u * _HALF_SQRT2
    z = torch.abs(w)
    y = torch.where(z < _HALF_SQRT2, 1.0 + torch.special.erf(w),
                    torch.where(w > 0.0, 2.0 - torch.special.erfc(z),
                                torch.special.erfc(z)))
    return 0.5 * y


def _log_phi(u):
    return -0.5 * (u * u + math.log(2.0 * math.pi))


def ei_helper(u):
    """EI(u) = phi(u) + u Phi(u)."""
    return _norm_pdf(u) + u * _ndtr(u)


def _log_abs_u_Phi_div_phi(u):
    """log(|u| Phi(u) / phi(u)) for u < 0, through erfcx in the tail."""
    inv_sqrt2 = 1.0 / math.sqrt(2.0)
    log_sqrt_pi_div_2 = 0.5 * math.log(math.pi / 2.0)
    return torch.log(torch.abs(u) * erfcx(-inv_sqrt2 * u)) + log_sqrt_pi_div_2


def log_ei_helper(u):
    """log(phi(u) + u Phi(u)), accurate over the whole real line."""
    if u.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"log_ei_helper supports float32/float64, got "
                        f"{u.dtype}")
    bound = -1.0
    neg_inv_sqrt_eps = -1e6 if u.dtype == torch.float64 else -1e3
    u_upper = torch.clamp(u, min=bound)
    log_ei_upper = torch.log(ei_helper(u_upper))
    u_lower = torch.clamp(u, max=bound)
    u_eps = torch.clamp(u_lower, min=neg_inv_sqrt_eps)
    w = _log_abs_u_Phi_div_phi(u_eps)
    second = torch.where(u > neg_inv_sqrt_eps, log1mexp(w),
                         -2.0 * torch.log(torch.abs(u_lower)))
    log_ei_lower = _log_phi(u) + second
    return torch.where(u > bound, log_ei_upper, log_ei_lower)
