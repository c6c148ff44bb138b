"""The plain reference agrees with the port on small states on the CPU:
the objective with each prior, the posterior mean, the WIPStd values of both
batch selections, and the nested-sampling ledger and quadrature."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.reference.gp import Reference, ns_ledger, trapezoid_logz

MODEL = {"noise": 1e-8, "lengthscale_bounds": [0.01, 5.0],
         "kernel_variance_bounds": [1e-4, 1e8]}


def _gp(prior, n=40, d=3, seed=0):
    from bobe_tpu_torch.models.gp import GP

    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, d))
    y = -0.5 * np.sum(((x - 0.5) / 0.3) ** 2, axis=1)
    gp = GP(x, y, lengthscale_prior=prior, lengthscales=[0.4, 0.5, 0.6],
            kernel_variance=2.0, device="cpu")
    lp = np.log([0.4, 0.5, 0.6, 2.0])
    return gp, x, y, lp, rng


@pytest.mark.parametrize("prior", [None, "DSLP"])
def test_neg_mll(prior):
    gp, x, y, lp, _ = _gp(prior)
    ref = Reference(dict(MODEL, lengthscale_prior=prior), "cpu")
    r = ref.neg_mll(x, y, lp)
    assert abs(float(gp.neg_mll(lp)) - r) <= 1e-10 * (1 + abs(r))


def test_mean():
    gp, x, y, lp, rng = _gp(None)
    q = rng.uniform(size=(50, 3))
    ref = Reference(dict(MODEL, lengthscale_prior=None), "cpu")
    np.testing.assert_allclose(gp.predict_mean_batched(q).numpy(),
                               ref.mean(x, y, lp, q), rtol=0, atol=1e-9)


def test_wipstd_fused_batch():
    from bobe_tpu_torch.acquisition import _wip_batch_core

    gp, x, y, lp, rng = _gp(None)
    mc = rng.uniform(size=(64, 3))
    pts, vals = _wip_batch_core(gp, torch.as_tensor(mc), True, 4)
    ref = Reference(dict(MODEL, lengthscale_prior=None), "cpu")
    r = ref.wipstd(x, y, lp, pts.numpy(), [mc])
    np.testing.assert_allclose(vals.numpy(), r, rtol=1e-9)


def test_wipstd_batch_by_hallucination():
    from bobe_tpu_torch.acquisition import WIPStd

    gp, x, y, lp, rng = _gp(None)
    mc = rng.uniform(size=(32, 3))
    pts, vals = WIPStd().get_next_batch(
        gp, n_batch=3, acq_kwargs={"mc_samples": {"x": mc},
                                   "mc_points_size": 32},
        maxiter=20, rng=np.random.default_rng(1))
    ref = Reference(dict(MODEL, lengthscale_prior=None), "cpu")
    r = ref.wipstd(x, y, lp, pts, [mc] * 3)
    np.testing.assert_allclose(vals, r, rtol=1e-9)


def test_ns_ledger_and_quadrature():
    from bobe_tpu_torch import samplers

    gp, *_ = _gp(None)
    gen = torch.Generator().manual_seed(3)
    smp, logz, ok = samplers.nested_sampling(
        gp, mode="convergence", nlive=60, rng=np.random.default_rng(3),
        generator=gen)
    assert ok
    lv = ns_ledger(len(smp["logl"]), 60, 0.1, 0.0)
    assert abs(trapezoid_logz(smp["logl"], lv, 0.0) - logz["mean"]) < 1e-10
