"""Parity of the port's EI / LogEI with the JAX package's, on the CPU: the
special functions (erfcx, log1mexp, ei_helper, log_ei_helper) over
u in [-1e7, 40], EI and LogEI values and gradients on a GP, the restart
optimization fed the same restarts, and short BOBE runs with
``acq="logei"`` and ``acq=("logei", "wipstd")``.

Inputs come from numpy seeds; float64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import norm

import bobe_tpu  # noqa: F401  (float64 in JAX)
from bobe_tpu import acquisition as jacq
from bobe_tpu.models import gp as jgp
from bobe_tpu.ops import special as jsp
from bobe_tpu_torch import acquisition as tacq
from bobe_tpu_torch.bo import BOBE
from bobe_tpu_torch.models import gp as tgp
from bobe_tpu_torch.models import toys
from bobe_tpu_torch.ops import special as tsp
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


def _both(name, u):
    return (np.asarray(getattr(jsp, name)(jnp.asarray(u))),
            getattr(tsp, name)(torch.as_tensor(u)).numpy())


U_ALL = np.concatenate([-np.logspace(7, -9, 4000), [0.0],
                        np.linspace(1e-9, 40.0, 4000)])


@pytest.mark.parametrize("name", ["erfcx", "log_ei_helper"])
def test_special_functions_match_jax(name):
    """erfcx and log_ei_helper over u in [-1e7, 40] at rtol 1e-12 (the
    same branches: erfcx's cut at 2 and continued fraction, the LogEI tail);
    where the JAX package gives inf or 0, so does the port."""
    want, got = _both(name, U_ALL)
    ok = np.isfinite(want) & (want != 0)
    np.testing.assert_array_equal(got[~ok], want[~ok])
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-12)


def test_ei_helper_and_log1mexp_match_jax():
    """ei_helper at rtol 1e-12 on [-5, 40]; below -5 phi(u) + u Phi(u)
    cancels in both packages alike (LogEI exists for that), so there the
    two agree to 1e-14 of phi(u) (1 + |u|). log1mexp on x in [-1e3, -1e-12]
    at rtol 1e-12."""
    u = U_ALL[U_ALL >= -5.0]
    want, got = _both("ei_helper", u)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    u = U_ALL[(U_ALL < -5.0) & (U_ALL > -1e3)]
    want, got = _both("ei_helper", u)
    np.testing.assert_array_less(
        np.abs(got - want), 1e-14 * norm.pdf(u) * (1 + np.abs(u)) + 1e-300)
    x = -np.logspace(-12, 3, 3000)
    want, got = _both("log1mexp", x)
    # below x = -708 the result is subnormal: XLA flushes it to 0
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-300)


def _pair(n=25, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, 2))
    y = -0.5 * np.sum(((x - 0.6) / 0.2) ** 2, axis=1)
    kw = dict(train_x=x, train_y=y, noise=1e-6, lengthscales=[0.3, 0.4],
              kernel_variance=2.0)
    return jgp.GP(**kw), tgp.GP(device="cpu", **kw)


@pytest.mark.parametrize("cls", ["EI", "LogEI"])
def test_ei_values_and_gradients_match_jax(cls):
    """fun (-EI or -logEI) and its gradient in x against jax.value_and_grad
    of the JAX package's, at points where u = (mean - zeta - best) / sigma
    is between -3 and 2 (far in the tail both are cancellation noise: the
    GP's mean agrees to ~1e-9 relative, which |u| then amplifies)."""
    jg, tg = _pair()
    jf, tf = getattr(jacq, cls)(), getattr(tacq, cls)()
    rng = np.random.default_rng(1)
    for x, u in zip(rng.uniform(size=(5, 2)), np.linspace(-3.0, 2.0, 5)):
        m, v = jg.predict_single(jnp.asarray(x))
        best_y = float(m) - 0.01 - u * float(np.sqrt(v))
        jv, jgr = jax.value_and_grad(
            lambda p: jf.fun(p, jg, best_y, 0.01))(jnp.asarray(x))
        tx = torch.as_tensor(x).requires_grad_(True)
        tv = tf.fun(tx, tg, best_y, 0.01)
        (tgr,) = torch.autograd.grad(tv, tx)
        np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-8)
        np.testing.assert_allclose(tgr.numpy(), np.asarray(jgr), rtol=1e-6,
                                   atol=1e-8 * np.abs(np.asarray(jgr)).max())


@pytest.mark.parametrize("use_log", [False, True])
def test_restart_optimization_fed_the_same_x0_matches_jax(use_log):
    """The -EI / -logEI lanes from the same 8 restarts end within 1e-6 of
    the JAX package's best point and value; get_next_point seeds its
    restarts from the same generator draws in both packages."""
    jg, tg = _pair(seed=2)
    best_y = float(jnp.max(jg.train_y))
    x0 = np.random.default_rng(3).uniform(size=(8, 2))
    jx, jf = jacq._ei_objective_core(jg.cfg, use_log, 100)(
        jg.state, jnp.asarray(x0), jnp.asarray(best_y), jnp.asarray(0.01))
    tx, tf = tacq._ei_objective_core(tg, torch.as_tensor(x0), best_y, 0.01,
                                     use_log, 100)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-6)
    np.testing.assert_allclose(float(tf), float(jf), rtol=1e-6, atol=1e-12)
    cls = "LogEI" if use_log else "EI"
    jr, tr = np.random.default_rng(4), np.random.default_rng(4)
    jp, jv = getattr(jacq, cls)().get_next_point(jg, maxiter=100,
                                                 n_restarts=6, rng=jr)
    tp, tv = getattr(tacq, cls)().get_next_point(tg, maxiter=100,
                                                 n_restarts=6, rng=tr)
    assert jr.uniform() == tr.uniform()
    np.testing.assert_allclose(tp, np.asarray(jp), atol=1e-6)
    np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=1e-12)


def _bobe(tmp_path):
    return BOBE(loglikelihood=toys.rosenbrock,
                param_list=toys.rosenbrock_names,
                param_bounds=toys.rosenbrock_bounds,
                likelihood_name="rosen_port", n_sobol_init=8, seed=0,
                save_dir=str(tmp_path), save=False, verbosity="WARNING",
                pool="serial", device="cpu")


def test_logei_run_optimizes_rosenbrock(tmp_path):
    """run(acq="logei") on the Rosenbrock valley: one point per iteration
    to the evaluation budget, the best value improving on the Sobol
    design's, the ledger and the best point in the results."""
    bobe = _bobe(tmp_path)
    start = bobe.best_f
    res = bobe.run(acq="logei", max_evals=14, max_gp_size=50, ei_goal=1e-8,
                   convergence_n_iters=2, zeta_ei=0.01)
    assert res["termination_reason"] == "Maximum evaluations reached"
    assert res["gp"].npoints == 14
    assert res["best_val"] >= start
    assert res["best_pt"].shape == (2,)
    acq = res["results_manager"].acquisition_values
    assert len(acq) == 6 and all(np.isfinite(acq))


def test_logei_then_wipstd_run(tmp_path):
    """run(acq=("logei", "wipstd")): the LogEI phase ends on its goal
    ("LOGEI goal reached" is recorded), then the WIPStd phase runs its own
    loop to an evidence."""
    bobe = _bobe(tmp_path)
    res = bobe.run(acq=("logei", "wipstd"), min_evals=10, max_evals=30,
                   max_gp_size=60, ei_goal=1e6, convergence_n_iters=1,
                   logz_threshold=50.0, mc_points_method="NS",
                   fit_n_points=4, ns_n_points=4)
    assert bobe.acquisition.name == "WIPStd"
    names = res["results_manager"].acquisition_names
    # the goal (log EI below log 1e6) holds at the first LogEI check
    assert names[0] == "LogEI" and names.count("LogEI") == 1
    assert names[-1] == "WIPStd"
    assert res["termination_reason"] == "LogZ converged"
    assert np.isfinite(res["logz"]["mean"])
