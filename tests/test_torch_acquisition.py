"""Parity of the port's acquisition (bobe_tpu_torch.acquisition and
ops/fantasy) with the JAX package's, on the CPU: the posterior payload, the
WIP sweep, the greedy batch, the single-point fantasy variance, the refine
polish, the MC pools and the mode-balanced subsample.

Both packages act on the same GP state (data and hyperparameters from a
numpy seed). Deterministic stages are float64 at rtol 1e-9 unless a test
states otherwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bobe_tpu  # noqa: F401  (float64 in JAX)
import bobe_tpu.acquisition as jacq
import bobe_tpu_torch.acquisition as tacq
from bobe_tpu.models import gp as jgp
from bobe_tpu.ops import fantasy as jfx
from bobe_tpu_torch.models import gp as tgp
from bobe_tpu_torch.ops import fantasy as tfx
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
def gps():
    """The same 2-d GP in both packages (hyperparameters fixed, not fitted,
    so both hold bit-comparable states)."""
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(30, 2))
    y = -10.0 * np.sum((x - 0.6) ** 2, axis=1)
    kw = dict(train_x=x, train_y=y, noise=1e-6,
              lengthscales=np.asarray([0.35, 0.45]), kernel_variance=3.0)
    return jgp.GP(**kw), tgp.GP(device="cpu", **kw)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _payloads(gps, mc):
    jg, tg = gps
    js, ts = jg.state, tg.state
    jargs = (jnp.exp(js.log_ls), jnp.exp(js.log_amp))
    targs = (torch.exp(ts.log_ls), torch.exp(ts.log_amp))
    jV, jvar = jfx.posterior_batch("rbf", js.x, js.mask(), js.chol,
                                   jnp.asarray(mc), *jargs, 1e-6)
    tV, tvar = tfx.posterior_batch("rbf", ts.x, ts.mask(), ts.chol,
                                   torch.as_tensor(mc), *targs, 1e-6)
    return (jV, jvar, jargs), (tV, tvar, targs)


def test_posterior_sweep_batch_and_single_match_jax(gps):
    jg, tg = gps
    mc = np.random.default_rng(1).uniform(size=(40, 2))
    (jV, jvar, ja), (tV, tvar, ta) = _payloads(gps, mc)
    np.testing.assert_allclose(_np(tV), _np(jV), rtol=1e-8, atol=1e-11)
    np.testing.assert_allclose(_np(tvar), _np(jvar), rtol=1e-7, atol=1e-12)
    jmc, tmc = jnp.asarray(mc), torch.as_tensor(mc)
    for use_std in (True, False):
        want = jfx.wip_sweep("rbf", jmc, jV, jvar, *ja, 1e-6,
                             jg.state.y_std, use_std)
        got = tfx.wip_sweep("rbf", tmc, tV, tvar, *ta, 1e-6,
                            tg.state.y_std, use_std)
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-7)
        jidx, jvals = jfx.wip_greedy_batch("rbf", jmc, jV, jvar, *ja, 1e-6,
                                           jg.state.y_std, use_std, 4)
        tidx, tvals = tfx.wip_greedy_batch("rbf", tmc, tV, tvar, *ta, 1e-6,
                                           tg.state.y_std, use_std, 4)
        np.testing.assert_array_equal(_np(tidx), _np(jidx))
        np.testing.assert_allclose(_np(tvals), _np(jvals), rtol=1e-7)
    xn = np.asarray([0.31, 0.72])
    want = jfx.fantasy_var_single("rbf", jg.state.x, jg.state.mask(),
                                  jg.state.chol, jnp.asarray(xn), jmc, jV,
                                  jvar, *ja, 1e-6)
    got = tfx.fantasy_var_single("rbf", tg.state.x, tg.state.mask(),
                                 tg.state.chol, torch.as_tensor(xn), tmc, tV,
                                 tvar, *ta, 1e-6)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-7, atol=1e-12)


def test_sweep_core_and_refine_polish_match_jax(gps):
    """WIPStd's pool sweep picks the same candidate, and the L-BFGS polish
    of it (same algorithm, step for step) reaches the same value; rtol 1e-6
    on the polished value and 1e-4 on its location, whose basin is flat."""
    jg, tg = gps
    mc = np.random.default_rng(2).uniform(size=(32, 2))
    jacqv, jV, jvar = jacq._wip_sweep_core(jg.cfg, True)(jg.state,
                                                          jnp.asarray(mc))
    tacqv, tV, tvar = tacq._wip_sweep_core(tg, torch.as_tensor(mc), True)
    np.testing.assert_allclose(_np(tacqv), _np(jacqv), rtol=1e-7)
    i = int(np.argmin(_np(jacqv)))
    assert int(np.argmin(_np(tacqv))) == i
    jx, jf = jacq._wip_refine_core(jg.cfg, True, 50)(
        jg.state, jnp.asarray(mc[i])[None, :], jnp.asarray(mc), jV, jvar)
    tx, tf = tacq._wip_refine_core(tg, torch.as_tensor(mc[i])[None, :],
                                   torch.as_tensor(mc), tV, tvar, True, 50)
    np.testing.assert_allclose(float(tf), float(jf), rtol=1e-6)
    np.testing.assert_allclose(_np(tx), _np(jx), atol=1e-4)


def test_fused_batch_above_refine_max_n_matches_jax(gps, monkeypatch):
    """Above REFINE_MAX_N the whole batch is one fused pass: same points,
    same values."""
    jg, tg = gps
    monkeypatch.setattr(jacq, "REFINE_MAX_N", -1)
    monkeypatch.setattr(tacq, "REFINE_MAX_N", -1)
    mc = {"x": np.random.default_rng(3).uniform(size=(48, 2))}
    kw = dict(n_batch=3, acq_kwargs={"mc_samples": mc, "mc_points_size": 48})
    jp, jv = jacq.WIPStd().get_next_batch(jg, rng=np.random.default_rng(4),
                                          **kw)
    tp, tv = tacq.WIPStd().get_next_batch(tg, rng=np.random.default_rng(4),
                                          **kw)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_allclose(tv, jv, rtol=1e-7)


def test_hallucination_batch_is_distinct_and_in_the_cube(gps):
    _, tg = gps
    mc = {"x": np.random.default_rng(5).uniform(size=(64, 2))}
    pts, vals = tacq.WIPStd().get_next_batch(
        tg, n_batch=3, acq_kwargs={"mc_samples": mc, "mc_points_size": 32},
        maxiter=30, rng=np.random.default_rng(6))
    assert pts.shape == (3, 2) and vals.shape == (3,)
    assert np.all((pts >= 0) & (pts <= 1)) and np.all(vals > 0)
    assert np.linalg.norm(pts[0] - pts[1]) > 1e-4
    # the hallucinated points never reach the real GP
    assert tg.npoints == 30


def test_mc_pools(gps):
    jg, tg = gps
    ju = jacq.get_mc_samples(jg, method="uniform", num_samples=64,
                             np_rng=np.random.default_rng(7))
    tu = tacq.get_mc_samples(tg, method="uniform", num_samples=64,
                             np_rng=np.random.default_rng(7))
    np.testing.assert_array_equal(tu["x"], ju["x"])
    ns = tacq.get_mc_samples(tg, method="NS", np_rng=np.random.default_rng(8))
    assert ns["method"] == "nested" and ns["x"].shape[1] == 2
    assert np.all((ns["x"] >= 0) & (ns["x"] <= 1))
    for method in ("EHMC", "NUTS"):
        mc = tacq.get_mc_samples(tg, method=method, num_samples=64,
                                 warmup_steps=32,
                                 np_rng=np.random.default_rng(8),
                                 generator=torch.Generator().manual_seed(8))
        # EHMC keeps at least 4 samples of each of its 64 chains
        assert mc["method"] == "MCMC" and mc["x"].shape[1] == 2
        assert mc["x"].shape[0] == (256 if method == "EHMC" else 64)
        assert np.all((mc["x"] >= 0) & (mc["x"] <= 1))
    # EI is ported (tests/test_torch_ei.py holds it)
    assert tacq.EI().name == "EI" and tacq.LogEI().name == "LogEI"


def test_balanced_choice_matches_jax_and_kmeans_finds_blobs():
    rng = np.random.default_rng(9)
    labels = np.repeat([0, 1, 2], [300, 40, 10])
    got = tacq._balanced_choice(labels, 64, np.random.default_rng(10))
    want = jacq._balanced_choice(labels, 64, np.random.default_rng(10))
    np.testing.assert_array_equal(got, want)
    blobs = np.vstack([rng.normal(0.2, 0.03, size=(100, 2)),
                       rng.normal(0.8, 0.03, size=(60, 2))])
    lab, centers = tacq.kmeans(blobs, 2, n_init=4, seed=0)
    assert len(set(lab[:100])) == 1 and len(set(lab[100:])) == 1
    assert lab[0] != lab[100]
    np.testing.assert_allclose(np.sort(centers[:, 0]), [0.2, 0.8], atol=0.02)


def test_mode_labels_separate_deep_modes_and_merge_unimodal():
    """As tests/test_acquisition.py holds the JAX package: a bimodal pool
    keeps two labels, a unimodal pool collapses to one."""
    rng = np.random.default_rng(11)
    x = np.vstack([rng.normal(0.2, 0.04, size=(30, 2)),
                   rng.normal(0.8, 0.04, size=(30, 2)),
                   rng.uniform(size=(20, 2))]).clip(0, 1)
    y = np.logaddexp(-0.5 * np.sum(((x - 0.2) / 0.05) ** 2, 1),
                     -0.5 * np.sum(((x - 0.8) / 0.05) ** 2, 1))
    gp = tgp.GP(train_x=x, train_y=y, device="cpu")
    gp.fit(n_restarts=2, maxiter=100, rng=rng)
    rng = np.random.default_rng(0)
    pool = np.vstack([rng.normal(0.2, 0.04, size=(200, 2)),
                      rng.normal(0.8, 0.04, size=(100, 2))]).clip(0, 1)
    labels = tacq._mode_labels(gp, pool, rng)
    assert np.bincount(labels[:200]).argmax() != \
        np.bincount(labels[200:]).argmax()
    uni = rng.normal(0.2, 0.04, size=(300, 2)).clip(0, 1)
    assert tacq._mode_labels(gp, uni, rng).max() == 0
    # the balanced subsample gives the minority mode its share
    pts = tacq.get_mc_points({"x": pool}, mc_points_size=128, rng=rng, gp=gp)
    assert pts.shape == (128, 2)
    assert np.sum(np.linalg.norm(pts - 0.8, axis=1) < 0.3) >= 50
