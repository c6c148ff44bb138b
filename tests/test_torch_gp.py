"""Parity of the port's GP (bobe_tpu_torch.models.gp) with the JAX package's,
on the CPU: refresh, predict, extend with dedupe, capacity growth, neg_mll
and its gradient, the fit from the same x0, and state carried across both
ways (state_from_numpy, npz files).

Inputs come from a numpy seed and go through both packages. Deterministic
stages are float64 at rtol 1e-9 unless a test states otherwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bobe_tpu  # noqa: F401  (float64 in JAX)
from bobe_tpu.models import gp as jgp
from bobe_tpu.ops import kernels as jkr
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


def _data(n, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, d))
    y = -0.5 * np.sum(((x - 0.5) / 0.25) ** 2, axis=1)
    return x, y


def _pair(n=40, d=2, seed=0, kernel="rbf", ls=(0.3, 0.5), amp=2.5):
    x, y = _data(n, d, seed)
    kw = dict(train_x=x, train_y=y, noise=1e-6, kernel=kernel,
              lengthscales=np.asarray(ls[:d]), kernel_variance=amp)
    return jgp.GP(**kw), tgp.GP(device="cpu", **kw)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _assert_states_match(js, ts, rtol=RTOL, atol=1e-12):
    """Data and hyperparameters at ``rtol``. The factor and alpha at a
    tolerance scaled by the Gram's conditioning: at noise 1e-6 the Gram's
    condition number is ~1e7, and two LAPACK Cholesky implementations (XLA's
    and PyTorch's) then agree to ~cond * eps = 1e-9 of the factor's largest
    entry, alpha = K^-1 y to ~cond * eps of its norm."""
    assert int(js.n) == ts.n
    for f in ("x", "y_raw", "log_ls", "log_amp", "y_mean", "y_std"):
        np.testing.assert_allclose(_np(getattr(ts, f)), _np(getattr(js, f)),
                                   rtol=rtol, atol=atol, err_msg=f)
    for f in ("chol", "alpha"):
        want = _np(getattr(js, f))
        np.testing.assert_allclose(_np(getattr(ts, f)), want, rtol=0,
                                   atol=1e-8 * np.abs(want).max(), err_msg=f)


@pytest.mark.parametrize("kernel", ["rbf", "matern"])
def test_refresh_and_predict_match_jax(kernel):
    jg, tg = _pair(kernel=kernel)
    _assert_states_match(jg.state, tg.state)
    xq = np.random.default_rng(1).uniform(size=(9, 2))
    jm, jv = jgp.predict_raw(jg.state, jg.cfg, jnp.asarray(xq))
    tm, tv = tgp.predict_raw(tg.state, tg.cfg, torch.as_tensor(xq))
    np.testing.assert_allclose(_np(tm), _np(jm), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(_np(tv), _np(jv), rtol=1e-7, atol=1e-12)
    np.testing.assert_allclose(_np(tg.predict_mean_batched(xq)),
                               _np(jg.predict_mean_batched(jnp.asarray(xq))),
                               rtol=RTOL)
    np.testing.assert_allclose(_np(tg.predict_var_batched(xq)),
                               _np(jg.predict_var_batched(jnp.asarray(xq))),
                               rtol=1e-7, atol=1e-12)
    np.testing.assert_allclose(tg.loo_z_rms(), jg.loo_z_rms(), rtol=1e-7)
    mc = np.random.default_rng(2).uniform(size=(7, 2))
    np.testing.assert_allclose(
        _np(tg.fantasy_var(xq[0], mc)),
        _np(jg.fantasy_var(jnp.asarray(xq[0]), jnp.asarray(mc))),
        rtol=1e-7, atol=1e-12)


def test_extend_with_dedupe_matches_jax():
    """One batch with a duplicate of a training point, an exact in-batch
    duplicate, an epsilon-close pair and new points: same accepted rows,
    same factor, same alpha."""
    jg, tg = _pair(n=30, seed=3)
    x_old = np.asarray(jg.train_x)
    new = np.asarray([x_old[4], [0.21, 0.31], [0.21, 0.31],
                      [0.61, 0.71], [0.61 + 1e-8, 0.71 - 1e-8], [0.9, 0.1]])
    ny = np.asarray([-1.0, -1.5, -1.5, -2.5, -2.5, -3.0])
    jg.update(jnp.asarray(new), jnp.asarray(ny))
    tg.update(new, ny)
    assert tg.npoints == jg.npoints == 33
    _assert_states_match(jg.state, tg.state, rtol=1e-8, atol=1e-11)


def test_capacity_growth_matches_jax():
    jg, tg = _pair(n=120, seed=4)
    new = np.random.default_rng(5).uniform(size=(20, 2))
    ny = -0.5 * np.sum(((new - 0.5) / 0.25) ** 2, axis=1)
    jg.update(jnp.asarray(new), jnp.asarray(ny))
    tg.update(new, ny)
    assert tg.state.cap == jg.state.cap == 256
    _assert_states_match(jg.state, tg.state, rtol=1e-8, atol=1e-10)
    # the padded factor keeps its identity pad block
    n = tg.npoints
    np.testing.assert_array_equal(_np(tg.state.chol[n:, n:]),
                                  np.eye(256 - n))


def test_extend_non_finite_factor_falls_back_to_refresh():
    """As in the JAX package: a poisoned factor heals on the next update via
    the full jittered refresh, and both packages heal to the same state."""
    jg, tg = _pair(n=10, seed=31)
    jbad = jg.state._replace(chol=jg.state.chol.at[0, 0].set(jnp.nan))
    tchol = tg.state.chol.clone()
    tchol[0, 0] = float("nan")
    tbad = tg.state._replace(chol=tchol)
    new_x, new_y = np.asarray([[0.91, 0.13]]), np.asarray([-4.0])
    jh = jgp.extend(jbad, jg.cfg, jnp.asarray(new_x), jnp.asarray(new_y))
    th = tgp.extend(tbad, tg.cfg, torch.as_tensor(new_x),
                    torch.as_tensor(new_y))
    assert th.n == 11
    assert torch.isfinite(th.chol).all() and torch.isfinite(th.alpha).all()
    _assert_states_match(jh, th, rtol=1e-8, atol=1e-11)


@pytest.mark.parametrize("use_dsq", [True, False])
def test_neg_mll_and_gradient_match_jax(use_dsq):
    jg, tg = _pair(n=50, d=3, seed=6, ls=(0.3, 0.5, 0.8))
    lps = np.random.default_rng(7).uniform(np.log(0.1), np.log(2.0),
                                           size=(3, 4))
    jdsq = jkr.sq_dist_perdim(jg.state.x) if use_dsq else None
    tdsq = tkr.sq_dist_perdim(tg.state.x) if use_dsq else None
    vg = jax.value_and_grad(
        lambda lp: jgp.neg_mll(jg.state, jg.cfg, lp, dsq_perdim=jdsq))
    for lp in lps:
        jv, jgrad = vg(jnp.asarray(lp))
        tlp = torch.as_tensor(lp).requires_grad_(True)
        tv = tgp.neg_mll(tg.state, tg.cfg, tlp, dsq_perdim=tdsq)
        (tgrad,) = torch.autograd.grad(tv, tlp)
        np.testing.assert_allclose(float(tv), float(jv), rtol=RTOL)
        np.testing.assert_allclose(_np(tgrad), _np(jgrad), rtol=1e-7,
                                   atol=1e-9)
    # the restart lanes: one batched call gives every lane's value
    batch = tgp.neg_mll(tg.state, tg.cfg, torch.as_tensor(lps),
                        dsq_perdim=tdsq)
    want = [float(jgp.neg_mll(jg.state, jg.cfg, jnp.asarray(lp)))
            for lp in lps]
    np.testing.assert_allclose(_np(batch), want, rtol=RTOL)


def test_fit_from_the_same_x0_is_not_worse_than_jax():
    """The fit's best neg_mll is at most the JAX package's plus 1e-6 |f|
    when both start from the same restart seeds. The targets carry 1 %
    noise, as bench.py's do, so the optimum is interior and both optimizers
    converge to it; on noiseless targets the optimum sits at the lengthscale
    bound, lanes retire on patience at points that roundoff decides, and the
    two endpoints differ by up to ~1e-6 |f| either way."""
    x, y = _data(60, 3, seed=8)
    y = y + 0.01 * np.random.default_rng(8).normal(size=y.shape)
    jg = jgp.GP(train_x=x, train_y=y, noise=1e-8)
    tg = tgp.GP(train_x=x, train_y=y, noise=1e-8, device="cpu")
    rng = np.random.default_rng(9)
    x0 = np.vstack([np.zeros(4),
                    rng.uniform(np.log(0.05), np.log(3.0), size=(3, 4))])
    jinfo = jg.fit(x0=jnp.asarray(x0), maxiter=100)
    tinfo = tg.fit(x0=x0, maxiter=100)
    jf, tf = -jinfo["mll"], -tinfo["mll"]
    assert np.isfinite(tf)
    assert tf <= jf + 1e-6 * abs(jf), (tf, jf)
    # the installed state is the refreshed state at the returned params
    np.testing.assert_allclose(_np(tg.state.log_ls), tinfo["params"][:3],
                               rtol=RTOL)
    assert tinfo["basins"][0][1] == pytest.approx(tf)


def test_neg_mll_lanes_on_the_gram_route_match_jax_vmap():
    """Above the per-dimension budget the fit's objective takes every lane's
    Gram matrix from one gram_masked call and differentiates it through
    GramMasked (here its plain versions): value and gradient over 3 lanes at
    cap 256, d=8 against jax.vmap(jax.value_and_grad(neg_mll)) of the JAX
    package on its own Gram route."""
    x, y = _data(230, 8, seed=14)
    y = y + 0.01 * np.random.default_rng(14).normal(size=y.shape)
    jg = jgp.GP(train_x=x, train_y=y, noise=1e-6)
    tg = tgp.GP(train_x=x, train_y=y, noise=1e-6, device="cpu")
    assert tg.state.cap == 256
    lps = np.random.default_rng(15).uniform(np.log(0.2), np.log(2.0),
                                            size=(3, 9))
    jv, jgrad = jax.vmap(jax.value_and_grad(
        lambda lp: jgp.neg_mll(jg.state, jg.cfg, lp)))(jnp.asarray(lps))
    tlp = torch.as_tensor(lps).requires_grad_(True)
    tv = tgp.neg_mll(tg.state, tg.cfg, tlp, dsq_perdim=None)
    (tgrad,) = torch.autograd.grad(tv.sum(), tlp)
    np.testing.assert_allclose(_np(tv), _np(jv), rtol=RTOL)
    np.testing.assert_allclose(_np(tgrad), _np(jgrad), rtol=1e-7, atol=1e-9)


def test_fit_on_the_gram_route_matches_jax(monkeypatch):
    """With the per-dimension budget at 0 every objective of the port's fit
    goes through gram_masked and its backward. From the same x0 on 1 %-noise
    targets it reaches the JAX package's neg_mll (whose own fit takes the
    per-dimension route at this size) to 1e-7 relative. The same optimizer
    runs on the same objective, but lanes retire on relative-ftol patience
    at points that roundoff decides: the two endpoints were 2.3e-9 |f|
    apart (the port's own per-dimension route: 1.2e-8)."""
    monkeypatch.setattr(tgp, "PERDIM_MAX_BYTES", 0)
    x, y = _data(60, 3, seed=16)
    y = y + 0.01 * np.random.default_rng(16).normal(size=y.shape)
    jg = jgp.GP(train_x=x, train_y=y, noise=1e-8)
    tg = tgp.GP(train_x=x, train_y=y, noise=1e-8, device="cpu")
    rng = np.random.default_rng(17)
    x0 = np.vstack([np.zeros(4),
                    rng.uniform(np.log(0.05), np.log(3.0), size=(3, 4))])
    jf = -jg.fit(x0=jnp.asarray(x0), maxiter=100)["mll"]
    before = tkr.gram_masked.launches
    tf = -tg.fit(x0=x0, maxiter=100)["mll"]
    assert tkr.gram_masked.launches == before  # plain versions on the CPU
    assert abs(tf - jf) <= 1e-7 * abs(jf), (tf, jf)


def test_state_from_numpy_and_npz_carry_state_both_ways(tmp_path):
    jg, _ = _pair(n=25, seed=10)
    jg.update(jnp.asarray([[0.3, 0.3]]), jnp.asarray([-0.9]))
    xq = np.random.default_rng(11).uniform(size=(6, 2))
    want = _np(jg.predict_mean_batched(jnp.asarray(xq)))

    tg = tgp.state_from_numpy(jg.state_dict(), device="cpu")
    _assert_states_match(jg.state, tg.state)
    np.testing.assert_allclose(_np(tg.predict_mean_batched(xq)), want,
                               rtol=RTOL)

    jg.save(str(tmp_path / "jax_gp"))
    tl = tgp.GP.load(str(tmp_path / "jax_gp"), device="cpu")
    _assert_states_match(jg.state, tl.state)

    tl.save(str(tmp_path / "torch_gp"))
    jl = jgp.GP.load(str(tmp_path / "torch_gp"))
    _assert_states_match(jl.state, tl.state)
    np.testing.assert_allclose(_np(jl.predict_mean_batched(jnp.asarray(xq))),
                               want, rtol=RTOL)


def test_bounds_and_basins_match_jax():
    cfg_j = jgp.GPTrainConfig()
    cfg_t = tgp.GPTrainConfig()
    np.testing.assert_allclose(_np(tgp.hyperparam_bounds_log(cfg_t, 3)),
                               _np(jgp.hyperparam_bounds_log(cfg_j, 3)),
                               rtol=RTOL)
    rng = np.random.default_rng(12)
    base = rng.normal(size=(3, 4))
    all_x = np.vstack([base, base + 1e-3, base[:1] + 0.5])
    all_f = rng.normal(size=len(all_x))
    want = jgp._endpoint_basins(all_x, all_f)
    got = tgp._endpoint_basins(all_x, all_f)
    assert len(got) == len(want)
    for (gx, gf), (wx, wf) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        assert gf == wf


