"""Parity of the port's Kumaraswamy input warp with the JAX package's, on
the CPU: the warp and the warped coordinates, neg_mll and its gradient
(every restart lane warping the training points with its own parameters,
the Gram build differentiated through them), the plain Gram backward's
coordinate gradient, the fit, the closed-form mean gradient through the
warp's Jacobian, the WIPStd sweep and refine in warp space, the
classifier-GP rebuild, and npz files both ways.

Inputs come from numpy seeds; several training and query points lie on the
cube's faces, where the warp's clip holds. Deterministic stages are float64
at rtol 1e-9 unless a test states otherwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bobe_tpu  # noqa: F401  (float64 in JAX)
from bobe_tpu import acquisition as jacq
from bobe_tpu.models import clf_gp as jclf
from bobe_tpu.models import gp as jgp
from bobe_tpu.ops import kernels as jkr
from bobe_tpu_torch import acquisition as tacq
from bobe_tpu_torch.models import clf_gp as tclf
from bobe_tpu_torch.models import gp as tgp
from bobe_tpu_torch.ops import kernels as tkr
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


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _data(n, d, seed, noise=0.0):
    """Points in the unit cube, the first ones on its faces (0 and 1), and
    a skewed target (its peak near a corner, where a warp helps)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, d))
    x[0] = 0.0
    x[1] = 1.0
    x[2, 0], x[3, -1] = 0.0, 1.0
    y = -0.5 * np.sum(((x ** 2 - 0.3) / 0.25) ** 2, axis=1)
    y = y + noise * np.abs(y).std() * rng.normal(size=n)
    return x, y


def _warp_params(d, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(0.0, 0.4, size=d), rng.normal(0.0, 0.4, size=d)


def _pair(kernel="rbf", n=40, d=3, seed=0, noise=0.0, **kw):
    x, y = _data(n, d, seed, noise)
    args = dict(train_x=x, train_y=y, noise=1e-6, kernel=kernel,
                lengthscales=np.linspace(0.3, 0.6, d), kernel_variance=2.0,
                input_warp=True, **kw)
    jg, tg = jgp.GP(**args), tgp.GP(device="cpu", **args)
    wa, wb = _warp_params(d, seed + 1)
    lp = np.concatenate([np.log(np.linspace(0.3, 0.6, d)), [np.log(2.0)],
                         wa, wb])
    jg.update_hyperparams(jnp.asarray(lp))
    tg.update_hyperparams(lp)
    return jg, tg, lp


@pytest.mark.parametrize("kernel", ["rbf", "matern"])
def test_warp_coordinates_and_neg_mll_match_jax(kernel):
    """The warp (faces included), train and query coordinates, the predict
    family in warp space, and neg_mll with its gradient at one point and
    over restart lanes (jax.vmap of jax.value_and_grad) at rtol 1e-9."""
    jg, tg, lp = _pair(kernel)
    d = tg.ndim
    np.testing.assert_allclose(_np(tgp.train_coords(tg.state, tg.cfg)),
                               _np(jgp.train_coords(jg.state, jg.cfg)),
                               rtol=RTOL, atol=1e-15)
    xq = np.random.default_rng(3).uniform(size=(7, d))
    xq[0], xq[1, 1] = 0.0, 1.0
    np.testing.assert_allclose(
        _np(tgp.query_coords(tg.state, tg.cfg, torch.as_tensor(xq))),
        _np(jgp.query_coords(jg.state, jg.cfg, jnp.asarray(xq))),
        rtol=RTOL, atol=1e-15)
    jm, jv = jgp.predict(jg.state, jg.cfg, jnp.asarray(xq))
    tm, tv = tgp.predict(tg.state, tg.cfg, torch.as_tensor(xq))
    np.testing.assert_allclose(_np(tm), _np(jm), rtol=RTOL, atol=1e-9)
    np.testing.assert_allclose(_np(tv), _np(jv), rtol=1e-6, atol=1e-9)

    lps = lp[None, :] + np.random.default_rng(4).normal(0, 0.1, (3, lp.size))
    jval, jgrad = jax.vmap(jax.value_and_grad(
        lambda p: jgp.neg_mll(jg.state, jg.cfg, p)))(jnp.asarray(lps))
    tlp = torch.as_tensor(lps).requires_grad_(True)
    tval = tgp.neg_mll(tg.state, tg.cfg, tlp)
    (tgrad,) = torch.autograd.grad(tval.sum(), tlp)
    np.testing.assert_allclose(_np(tval), _np(jval), rtol=RTOL)
    np.testing.assert_allclose(_np(tgrad), _np(jgrad), rtol=1e-7,
                               atol=1e-9 * np.abs(_np(jgrad)).max())
    one = torch.as_tensor(lps[0]).requires_grad_(True)
    v1 = tgp.neg_mll(tg.state, tg.cfg, one)
    (g1,) = torch.autograd.grad(v1, one)
    np.testing.assert_allclose(float(v1), float(jval[0]), rtol=RTOL)
    np.testing.assert_allclose(_np(g1), _np(jgrad[0]), rtol=1e-7,
                               atol=1e-9 * np.abs(_np(jgrad)).max())


@pytest.mark.parametrize("kernel", ["rbf", "matern"])
@pytest.mark.parametrize("per_lane", [False, True])
def test_plain_backward_grad_x_matches_autograd_and_jax(kernel, per_lane):
    """gram_masked_backward_plain(need_x=True) against torch.autograd of
    gram_masked_plain and against jax.vjp of the JAX package's XLA Gram
    (lane by lane), for a cotangent that is not symmetric; pad rows exactly
    0."""
    rng = np.random.default_rng(5 + per_lane)
    R, cap, n, d = 3, 128, 90, 4
    x = rng.uniform(size=(R, cap, d) if per_lane else (cap, d))
    mask = (np.arange(cap) < n).astype(np.float64)
    ls = rng.uniform(0.2, 1.0, size=(R, d))
    amp = rng.uniform(0.5, 2.0, size=R)
    g = rng.normal(size=(R, cap, cap))
    t = lambda a: torch.as_tensor(a)
    gl, ga, gx = tkr.gram_masked_backward_plain(kernel, t(x), t(mask), t(ls),
                                                t(amp), t(g), need_x=True)
    assert bool((gx[:, n:] == 0).all())
    tx = t(x).requires_grad_(True)
    K = tkr.gram_masked_plain(kernel, tx, t(mask), t(ls), t(amp), 1e-6)
    (ax,) = torch.autograd.grad(torch.sum(K * t(g)), tx)
    want = gx if per_lane else gx.sum(0)
    np.testing.assert_allclose(_np(want), _np(ax), rtol=1e-9,
                               atol=1e-11 * float(ax.abs().max()))
    for r in range(R):
        xr = x[r] if per_lane else x
        _, vjp = jax.vjp(lambda xx: jkr.gram_masked(
            kernel, xx, jnp.asarray(mask), jnp.asarray(ls[r]),
            jnp.asarray(amp[r]), 1e-6), jnp.asarray(xr))
        (jx,) = vjp(jnp.asarray(g[r]))
        np.testing.assert_allclose(_np(gx[r]), _np(jx), rtol=1e-8,
                                   atol=1e-10 * np.abs(_np(jx)).max())


@pytest.mark.parametrize("kernel", ["rbf", "matern"])
def test_plain_backward_grad_x_matches_jax_at_d30(kernel):
    """The plain dL/dx at the input warp's d=30 shape (4 lanes, per-lane x,
    cap 384, a cotangent that is not symmetric) against jax.vjp of the JAX
    package's XLA Gram, lane by lane, at rtol 1e-9 with a floor of 1e-11 of
    the lane's largest component; pad rows exactly 0."""
    rng = np.random.default_rng(11)
    R, cap, n, d = 4, 384, 300, 30
    x = rng.uniform(size=(R, cap, d))
    mask = (np.arange(cap) < n).astype(np.float64)
    ls = rng.uniform(0.5, 2.0, size=(R, d)) * np.sqrt(d / 8)
    amp = rng.uniform(0.5, 2.0, size=R)
    g = rng.normal(size=(R, cap, cap))
    t = lambda a: torch.as_tensor(a)
    _, _, gx = tkr.gram_masked_backward_plain(kernel, t(x), t(mask), t(ls),
                                              t(amp), t(g), need_x=True)
    assert bool((gx[:, n:] == 0).all())
    for r in range(R):
        _, vjp = jax.vjp(lambda xx: jkr.gram_masked(
            kernel, xx, jnp.asarray(mask), jnp.asarray(ls[r]),
            jnp.asarray(amp[r]), 1e-6), jnp.asarray(x[r]))
        (jx,) = vjp(jnp.asarray(g[r]))
        np.testing.assert_allclose(_np(gx[r]), _np(jx), rtol=1e-9,
                                   atol=1e-11 * np.abs(_np(jx)).max())


def test_warp_fit_from_the_same_x0_matches_jax():
    """A warp fit (4 restarts, 1 %-noise target) from the same x0 ends
    within 1e-6 |f| of the JAX package's best neg_mll; the installed state
    carries the fitted warp."""
    x, y = _data(50, 2, seed=6, noise=0.01)
    kw = dict(train_x=x, train_y=y, noise=1e-8, input_warp=True)
    jg, tg = jgp.GP(**kw), tgp.GP(device="cpu", **kw)
    rng = np.random.default_rng(7)
    n_hp = 2 + 1 + 4
    x0 = np.zeros((4, n_hp))
    x0[1:, :3] = rng.uniform(np.log(0.05), np.log(3.0), size=(3, 3))
    x0[1:, 3:] = rng.normal(0.0, 0.1, size=(3, 4))
    jf = -jg.fit(x0=jnp.asarray(x0), maxiter=100)["mll"]
    tinfo = tg.fit(x0=x0, maxiter=100)
    tf = -tinfo["mll"]
    assert abs(tf - jf) <= 1e-6 * abs(jf), (tf, jf)
    np.testing.assert_allclose(_np(tg.state.log_wa), tinfo["params"][3:5],
                               rtol=RTOL)
    np.testing.assert_allclose(_np(tg.state.log_wb), tinfo["params"][5:7],
                               rtol=RTOL)


def test_warp_restart_seeding_matches_jax():
    """Without x0 both packages draw the same restarts from the same numpy
    generator: uniform inside the log bounds, the warp lanes from
    N(0, 0.1) near the identity (checked through the rng state both leave
    behind and the first restart, the current parameters)."""
    x, y = _data(30, 2, seed=8, noise=0.01)
    kw = dict(train_x=x, train_y=y, noise=1e-8, input_warp=True)
    jg, tg = jgp.GP(**kw), tgp.GP(device="cpu", **kw)
    jr, tr = np.random.default_rng(9), np.random.default_rng(9)
    # four restarts, maxiter 100: the fit test's shapes, one JAX compile
    jg.fit(n_restarts=4, maxiter=100, rng=jr)
    tg.fit(n_restarts=4, maxiter=100, rng=tr)
    assert jr.uniform() == tr.uniform()


@pytest.mark.parametrize("kernel", ["rbf", "matern"])
def test_mean_gradient_through_the_warp_matches_jax_grad(kernel):
    """mean_value_and_grad_fn under the warp (closed form in warp space,
    chained by the Jacobian) against jax.grad of the JAX package's
    predict_mean, at interior points and on the faces x = 0 and x = 1 (the
    clip's gradient is 0 there in both)."""
    jg, tg, _ = _pair(kernel, seed=10)
    d = tg.ndim
    xq = np.random.default_rng(11).uniform(0.05, 0.95, size=(6, d))
    xq[0, 0], xq[1, 1], xq[2] = 0.0, 1.0, 1.0
    f = tgp.mean_value_and_grad_fn(tg.state, tg.cfg)
    tm, tgr = f(torch.as_tensor(xq))
    jfun = lambda p: jgp.predict_mean(jg.state, jg.cfg, p[None, :])[0]
    jm = jax.vmap(jfun)(jnp.asarray(xq))
    jgr = jax.vmap(jax.grad(jfun))(jnp.asarray(xq))
    np.testing.assert_allclose(_np(tm), _np(jm), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(_np(tgr), _np(jgr), rtol=1e-7,
                               atol=1e-9 * np.abs(_np(jgr)).max())
    assert _np(tgr)[0, 0] == 0.0 and _np(tgr)[1, 1] == 0.0
    assert np.all(_np(tgr)[2] == 0.0)


def test_wipstd_sweep_and_refine_in_warp_space_match_jax():
    """The WIPStd sweep over an MC pool (warped pool and training
    coordinates), and the refine polish from the pool's best candidate
    (raw variable, the warp differentiated), against the JAX package's
    cores."""
    jg, tg, _ = _pair("rbf", n=30, d=2, seed=12)
    mc = np.random.default_rng(13).uniform(size=(64, 2))
    jv, jV, jvar = jacq._wip_sweep_core(jg.cfg, True)(jg.state,
                                                        jnp.asarray(mc))
    tv, tV, tvar = tacq._wip_sweep_core(tg, torch.as_tensor(mc), True)
    np.testing.assert_allclose(_np(tv), _np(jv), rtol=1e-7)
    i = int(np.argmin(_np(jv)))
    jx, jf = jacq._wip_refine_core(jg.cfg, True, 40)(
        jg.state, jnp.asarray(mc[i])[None, :], jnp.asarray(mc), jV, jvar)
    tx, tf = tacq._wip_refine_core(tg, torch.as_tensor(mc[i])[None, :],
                                   torch.as_tensor(mc), tV, tvar, True, 40)
    np.testing.assert_allclose(float(tf), float(jf), rtol=1e-6)
    np.testing.assert_allclose(_np(tx), _np(jx), atol=1e-5)
    assert float(tf) <= float(tv[i]) + 1e-12
    # the batch core returns raw points of the pool
    pts, _ = tacq._wip_batch_core(tg, torch.as_tensor(mc), True, 3)
    assert all(any(np.array_equal(p, m) for m in mc) for p in _np(pts))


def test_clf_gp_rebuild_keeps_the_learned_warp():
    """A classifier GP's subset rebuild carries the fitted warp (a fresh GP
    starts at the identity) and refactorizes in warp space: predictions
    after the rebuild equal the JAX package's rebuild of the same state."""
    x, y = _data(60, 2, seed=14)
    y[:10] = -1e10
    kw = dict(train_x=x, train_y=y, clf_type="svm", clf_use_size=10,
              clf_threshold=75.0, gp_threshold=150.0, minus_inf=-1e10,
              noise=1e-6, input_warp=True)
    jg = jclf.GPwithClassifier(**kw)
    wa, wb = _warp_params(2, 15)
    lp = np.concatenate([np.log([0.4, 0.5]), [np.log(1.5)], wa, wb])
    jg.update_hyperparams(jnp.asarray(lp))
    tg = tclf.GPwithClassifier.from_state_dict(jg.state_dict(), device="cpu")
    np.testing.assert_allclose(_np(tg.state.log_wa), wa, rtol=RTOL)
    keep = np.arange(20, 60)
    jg._rebuild(x[keep], y[keep])
    tg._rebuild(x[keep], y[keep])
    np.testing.assert_allclose(_np(tg.state.log_wa), wa, rtol=RTOL)
    np.testing.assert_allclose(_np(tg.state.log_wb), wb, rtol=RTOL)
    xq = np.random.default_rng(16).uniform(size=(8, 2))
    np.testing.assert_allclose(
        _np(tgp.predict_mean(tg.state, tg.cfg, torch.as_tensor(xq))),
        _np(jgp.predict_mean(jg.state, jg.cfg, jnp.asarray(xq))),
        rtol=1e-8, atol=1e-8)


def test_warp_gp_npz_both_ways(tmp_path):
    """A warp GP saved by either package loads in the other with its warp
    (predictions equal), and dummy_like keeps evaluating in warp space."""
    jg, tg, _ = _pair("matern", n=30, d=2, seed=17)
    xq = np.random.default_rng(18).uniform(size=(6, 2))
    want = _np(jg.predict_mean_batched(jnp.asarray(xq)))
    jg.save(str(tmp_path / "jax_warp"))
    tl = tgp.GP.load(str(tmp_path / "jax_warp"), device="cpu")
    assert tl.cfg.input_warp
    np.testing.assert_allclose(_np(tl.predict_mean_batched(xq)), want,
                               rtol=1e-8, atol=1e-8)
    tg.save(str(tmp_path / "torch_warp"))
    jl = jgp.GP.load(str(tmp_path / "torch_warp"))
    assert jl.cfg.input_warp
    np.testing.assert_allclose(_np(jl.predict_mean_batched(jnp.asarray(xq))),
                               want, rtol=1e-8, atol=1e-8)
    dummy = tgp.GP.dummy_like(tg)
    np.testing.assert_allclose(_np(dummy.predict_mean_batched(xq)),
                               _np(tg.predict_mean_batched(xq)), rtol=0)
    assert tg.hyperparam_names[-2:] == ["warp_a", "warp_b"]
    assert tg.get_hyperparams().shape[0] == tg.num_hyperparams
