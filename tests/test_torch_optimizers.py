"""Parity of the port's adam lanes and host scipy restarts with the JAX
package's optimizers, on the CPU: lockstep adam against optax's adam (the
JAX package's minimize_restarts(method="adam")) step for step on
Rosenbrock, scipy L-BFGS-B restarts against the JAX package's
minimize_scipy_restarts on the same objective, and GP.fit with
``optimizer="adam"`` and ``"scipy"``.

Inputs come from numpy seeds; float64.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bobe_tpu  # noqa: F401  (float64 in JAX)
from bobe_tpu.models import gp as jgp
from bobe_tpu.ops import optimize as jopt
from bobe_tpu_torch.models import gp as tgp
from bobe_tpu_torch.ops import optimize as topt
from bobe_tpu_torch.utils.seed import set_global_seed


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _port_seed():
    set_global_seed(42)


def _rosen_j(x):
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def _rosen_t(X):
    return torch.sum(100.0 * (X[:, 1:] - X[:, :-1] ** 2) ** 2
                     + (1.0 - X[:, :-1]) ** 2, dim=1)


@pytest.mark.parametrize("bounded", [False, True])
def test_adam_lanes_follow_optax_step_for_step(bounded):
    """25 adam steps over 5 lanes (learning rate 1e-2, patience 5): every
    lane's endpoint and best value equal the JAX package's to 1e-9."""
    x0 = np.random.default_rng(0).uniform(-1.5, 1.5, size=(5, 3))
    bounds = np.array([[-2.0] * 3, [2.0] * 3]) if bounded else None
    jx, jf = jopt.minimize_restarts(
        _rosen_j, jnp.asarray(x0), bounds=None if bounds is None
        else jnp.asarray(bounds), method="adam", maxiter=25, return_all=True)
    tx, tf = topt.minimize_restarts(
        _rosen_t, torch.as_tensor(x0), bounds=bounds, method="adam",
        maxiter=25, return_all=True)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-9)
    # and the best lane
    bx, bf = topt.minimize_restarts(_rosen_t, torch.as_tensor(x0),
                                    bounds=bounds, method="adam", maxiter=25)
    assert float(bf) == float(tf.min())


def test_scipy_restarts_match_jax():
    """scipy L-BFGS-B from each of 4 restarts on bounded Rosenbrock: the
    best point and value, and every restart's endpoint, equal the JAX
    package's minimize_scipy_restarts (the same scipy on the same values
    and gradients, to roundoff)."""
    x0 = np.random.default_rng(1).uniform(-1.5, 1.5, size=(4, 2))
    bounds = np.array([[-2.0, -2.0], [2.0, 2.0]])
    jb, jf, jall, jfall = jopt.minimize_scipy_restarts(
        _rosen_j, x0, bounds=jnp.asarray(bounds), maxiter=200,
        return_all=True)
    tb, tf, tall, tfall = topt.minimize_scipy_restarts(
        _rosen_t, torch.as_tensor(x0), bounds=bounds, maxiter=200,
        return_all=True)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6,
                               atol=1e-8)
    np.testing.assert_allclose(float(tf), float(jf), atol=1e-10)
    np.testing.assert_allclose(tall, np.asarray(jall), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(tfall, np.asarray(jfall), atol=1e-10)
    with pytest.raises(RuntimeError, match="every optimizer restart"):
        topt.minimize_scipy_restarts(
            lambda X: torch.full((X.shape[0],), float("nan"),
                                 dtype=X.dtype) * X.sum(),
            torch.as_tensor(x0), bounds=bounds, maxiter=5)


def _data(n, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, d))
    y = -0.5 * np.sum(((x - 0.5) / 0.25) ** 2, axis=1)
    return x, y + 0.01 * rng.normal(size=n)


def test_gp_fit_with_adam_matches_jax():
    """GP(optimizer="adam").fit from the same x0 (60 steps) ends at the
    JAX package's neg_mll to 1e-9 relative (the same lanes, the same
    steps)."""
    x, y = _data(40, 2, seed=2)
    kw = dict(train_x=x, train_y=y, noise=1e-6, optimizer="adam")
    jg, tg = jgp.GP(**kw), tgp.GP(device="cpu", **kw)
    x0 = np.random.default_rng(3).uniform(np.log(0.1), np.log(2.0),
                                          size=(3, 3))
    jf = -jg.fit(x0=jnp.asarray(x0), maxiter=60)["mll"]
    tinfo = tg.fit(x0=x0, maxiter=60)
    np.testing.assert_allclose(-tinfo["mll"], jf, rtol=1e-9)
    assert tg.optimizer_method == "adam"
    assert tg.state_dict()["optimizer_method"] == "adam"


def test_gp_fit_with_scipy_matches_jax_scipy_restarts():
    """GP(optimizer="scipy").fit from the same x0 against the JAX
    package's minimize_scipy_restarts on its own neg_mll (its GP fit with
    scipy is not used as the oracle: it fails on a CPU-only host): the same
    best neg_mll to 1e-7 relative, and the installed state is the refreshed
    state at the returned parameters."""
    x, y = _data(40, 2, seed=4)
    kw = dict(train_x=x, train_y=y, noise=1e-6)
    jg = jgp.GP(**kw)
    tg = tgp.GP(device="cpu", optimizer="scipy", **kw)
    x0 = np.random.default_rng(5).uniform(np.log(0.1), np.log(2.0),
                                          size=(3, 3))
    bounds = jgp.hyperparam_bounds_log(jg.cfg, 2)
    _, jf = jopt.minimize_scipy_restarts(
        lambda lp: jgp.neg_mll(jg.state, jg.cfg, lp), x0, bounds=bounds,
        maxiter=200)
    tinfo = tg.fit(x0=x0, maxiter=200)
    np.testing.assert_allclose(-tinfo["mll"], float(jf), rtol=1e-7)
    np.testing.assert_allclose(tg.state.log_ls.numpy(), tinfo["params"][:2],
                               rtol=1e-12)
    assert len(tinfo["basins"]) >= 1
    with pytest.raises(ValueError, match="optimizer"):
        tgp.fit(tg.state, tg.cfg, x0=torch.as_tensor(x0), optimizer="sgd")
