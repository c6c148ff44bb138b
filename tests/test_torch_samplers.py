"""Parity of the port's nested sampling (bobe_tpu_torch.infer, samplers) with
the JAX package's, on the CPU.

The deterministic parts (evidence quadrature, run merging, slice-sampling
geometry, settings, live seeding) are compared on identical inputs at rtol
1e-9. The sampler itself draws from torch generators where JAX draws from
its own keys, so a run is compared statistically: a GP state fitted by the
JAX package is carried across, both packages run convergence-mode NS on it,
and the two logZ agree within 3 combined sampler errors (``dlogz_sampler``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bobe_tpu  # noqa: F401  (float64 in JAX)
from bobe_tpu import samplers as jsamp
from bobe_tpu.infer import integrals as jint
from bobe_tpu.infer import nested as jnest
from bobe_tpu.models import gp as jgp
from bobe_tpu_torch import samplers as tsamp
from bobe_tpu_torch.infer import integrals as tint
from bobe_tpu_torch.infer import nested as tnest
from bobe_tpu_torch.models import gp as tgp
from bobe_tpu_torch.utils.seed import set_global_seed

RTOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _port_seed():
    set_global_seed(42)


@pytest.fixture(scope="module")
def jax_gaussian_gp():
    """The JAX package's GP fitted to a 2-d Gaussian log-density
    (sigma 0.15), as tests/test_samplers.py builds it."""
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(120, 2))
    y = -0.5 * np.sum(((x - 0.5) / 0.15) ** 2, axis=1)
    gp = jgp.GP(train_x=jnp.asarray(x), train_y=jnp.asarray(y), noise=1e-8)
    gp.fit(n_restarts=4, maxiter=200)
    return gp


def _dead_points(n=400, seed=0):
    rng = np.random.default_rng(seed)
    logvol = -np.cumsum(rng.uniform(0.001, 0.02, size=n))
    logl = np.sort(rng.normal(size=n)) * 3.0
    sigma = rng.uniform(0.0, 0.1, size=n)
    return logl, logvol, sigma


def test_evidence_quadrature_matches_jax():
    logl, logvol, sigma = _dead_points()
    for sq in (False, True):
        np.testing.assert_allclose(
            tint.trapezoid_logz(logl, logvol, squared=sq, lv_start=-0.1),
            jint.trapezoid_logz(logl, logvol, squared=sq, lv_start=-0.1),
            rtol=RTOL)
    want = jint.logz_bounds_from_gp_sigma(logl, logvol, sigma)
    got = tint.logz_bounds_from_gp_sigma(logl, logvol, sigma)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL)
    np.testing.assert_allclose(
        tint.information_and_err(logl, logvol, want["mean"], 50),
        jint.information_and_err(logl, logvol, want["mean"], 50), rtol=RTOL)


def test_merge_runs_matches_jax():
    rng = np.random.default_rng(1)
    runs = []
    for i, bound in enumerate((-np.inf, -np.inf, 0.5)):
        n = 200 + 30 * i
        logl = np.sort(rng.normal(size=n))
        sched = np.concatenate([np.tile(50 - np.arange(5), (n - 50) // 5),
                                50 - np.arange(50)]).astype(float)
        runs.append((rng.uniform(size=(n, 2)), logl, sched[:n], bound))
    want = jnest.merge_runs(runs, logvol0=-0.2)
    got = tnest.merge_runs(runs, logvol0=-0.2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL)


def test_slice_geometry_and_settings_match_jax():
    rng = np.random.default_rng(2)
    x, e = rng.uniform(size=(16, 3)), rng.normal(size=(16, 3))
    jlo, jhi = jax.vmap(jnest._chord_bounds)(jnp.asarray(x), jnp.asarray(e))
    tlo, thi = tnest._chord_bounds(torch.as_tensor(x), torch.as_tensor(e))
    np.testing.assert_allclose(tlo.numpy(), np.asarray(jlo), rtol=RTOL)
    np.testing.assert_allclose(thi.numpy(), np.asarray(jhi), rtol=RTOL)
    u = rng.uniform(size=(4, 16))
    want = jnest._spec_candidates(jnp.asarray(u), jlo, jhi, 4)
    got = tnest._spec_candidates(torch.as_tensor(u), tlo, thi, 4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL)
    for mode in ("acq", "convergence"):
        for d in (2, 8, 30):
            assert tsamp.ns_settings(mode, d) == jsamp.ns_settings(mode, d)
    for d in (2, 12):
        assert tnest._resolve_spec(None, d) == jnest._resolve_spec(None, d)


def test_seed_live_points_match_jax(jax_gaussian_gp):
    """Same numpy draws, same surrogate: the same live set; a plain GP has
    no infeasible plateau, so the ledger starts at log 1 = 0. The GP-mean
    values agree to rtol 1e-6: at noise 1e-8 the Gram's condition number is
    ~1e10, and alpha = K^-1 y from the two packages' Cholesky factors agrees
    to ~cond * eps."""
    jg = jax_gaussian_gp
    tg = tgp.state_from_numpy(jg.state_dict(), device="cpu")
    japply, jctx = jsamp._gp_loglike(jg)
    tapply, tctx = tsamp._gp_loglike(tg)
    jl = jsamp._seed_live_points(jg, lambda x: japply(jctx, x), 64, 2,
                                 np.random.default_rng(3))
    tl = tsamp._seed_live_points(tg, lambda x: tapply(tctx, x), 64, 2,
                                 np.random.default_rng(3))
    np.testing.assert_array_equal(tl[0], jl[0])
    np.testing.assert_allclose(tl[1], jl[1], rtol=1e-6)
    assert tl[2:] == pytest.approx(jl[2:]) and tl[2] == 0.0


def test_convergence_ns_on_a_jax_state_agrees_with_jax(jax_gaussian_gp):
    jg = jax_gaussian_gp
    tg = tgp.state_from_numpy(jg.state_dict(), device="cpu")
    _, jz, jok = jsamp.nested_sampling(jg, mode="convergence",
                                       rng=np.random.default_rng(4))
    samples, tz, tok = tsamp.nested_sampling(
        tg, mode="convergence", rng=np.random.default_rng(5),
        generator=torch.Generator().manual_seed(5))
    assert jok and tok
    for k in ("mean", "upper", "lower", "var", "std", "dlogz_sampler", "h",
              "dlogz_hyp", "err_total"):
        assert np.isfinite(tz[k]), k
    assert tz["lower"] <= tz["mean"] <= tz["upper"]
    s = np.hypot(jz["dlogz_sampler"], tz["dlogz_sampler"])
    assert abs(tz["mean"] - jz["mean"]) < 3.0 * s, (tz["mean"], jz["mean"], s)
    # both near the analytic value log(2 pi 0.15^2)
    assert abs(tz["mean"] - np.log(2 * np.pi * 0.15**2)) < 0.3
    assert samples["n_iter"] > 0 and samples["n_inner"] >= samples["n_iter"]
    assert samples["x"].shape[1] == 2
    np.testing.assert_allclose(samples["weights"].sum(), 1.0, rtol=1e-9)


def test_repeated_runs_merge_and_tighten_the_sampler_error(jax_gaussian_gp):
    tg = tgp.state_from_numpy(jax_gaussian_gp.state_dict(), device="cpu")
    one, z1, ok1 = tsamp.nested_sampling(tg, mode="convergence", nlive=100,
                                         rng=np.random.default_rng(6))
    _, z3, ok3 = tsamp.nested_sampling(tg, mode="convergence", nlive=100,
                                       n_runs=2, merge_with=[one["raw"]],
                                       rng=np.random.default_rng(7))
    assert ok1 and ok3
    assert z3["dlogz_sampler"] < z1["dlogz_sampler"]
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tsamp.nested_sampling(tg, dynamic=True)
