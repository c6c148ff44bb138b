"""Parity of the port's SAAS lengthscale prior with the JAX package's, on
the CPU: the prior itself, the log-space bounds and the packing of the
global shrinkage tausq into the hyperparameter vector, neg_mll and its
gradient over restart lanes, the fit's restart seeding, and the state
carried across both packages (state dicts and npz files).

Inputs come from numpy seeds; float64 at rtol 1e-9.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bobe_tpu  # noqa: F401  (float64 in JAX)
from bobe_tpu.models import gp as jgp
from bobe_tpu.ops import mll as jmll
from bobe_tpu_torch.models import gp as tgp
from bobe_tpu_torch.ops import mll as tmll
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


def _pair(d=4, n=50, seed=0, **kw):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, d))
    # one relevant dimension: the sparsity SAAS looks for
    y = -0.5 * ((x[:, 0] - 0.4) / 0.2) ** 2 + 0.01 * rng.normal(size=n)
    args = dict(train_x=x, train_y=y, noise=1e-6,
                lengthscale_prior="SAAS", tausq=0.5, **kw)
    return jgp.GP(**args), tgp.GP(device="cpu", **args)


def test_saas_prior_matches_jax():
    rng = np.random.default_rng(1)
    for _ in range(4):
        ls = rng.uniform(0.01, 5.0, size=6)
        amp, tausq = rng.uniform(1e-3, 10.0), rng.uniform(1e-3, 10.0)
        want = float(jmll.saas_logprob(jnp.asarray(ls), amp, tausq))
        t = lambda a: torch.as_tensor(a, dtype=torch.float64)
        got = float(tmll.saas_logprob(t(ls), t(amp), t(tausq)))
        np.testing.assert_allclose(got, want, rtol=RTOL)
    # over lanes at once
    ls = rng.uniform(0.01, 5.0, size=(3, 6))
    amp, tausq = rng.uniform(0.1, 3.0, size=3), rng.uniform(0.1, 3.0, size=3)
    got = tmll.saas_logprob(torch.as_tensor(ls), torch.as_tensor(amp),
                            torch.as_tensor(tausq))
    want = [float(jmll.saas_logprob(jnp.asarray(ls[i]), amp[i], tausq[i]))
            for i in range(3)]
    np.testing.assert_allclose(_np(got), want, rtol=RTOL)


@pytest.mark.parametrize("warp", [False, True])
def test_bounds_and_packing_match_jax(warp):
    """[log_ls (d)] [log_amp] [log_tausq] [warp (2d)]: the same bounds, the
    same names, set_hyperparams stores tausq."""
    jg, tg = _pair(d=3, input_warp=warp)
    np.testing.assert_array_equal(_np(tg.hyperparam_bounds),
                                  _np(jg.hyperparam_bounds))
    assert tg.hyperparam_names == jg.hyperparam_names
    lp = np.concatenate([np.log([0.3, 0.8, 1.2]), [np.log(1.7)],
                         [np.log(0.25)], np.zeros(6 if warp else 0)])
    jg.update_hyperparams(jnp.asarray(lp))
    tg.update_hyperparams(lp)
    assert tg.tausq == pytest.approx(0.25, rel=1e-12)
    np.testing.assert_allclose(_np(tg.get_hyperparams()),
                               _np(jg.get_hyperparams()), rtol=RTOL)
    assert tg.hyperparams_dict()["tausq"] == jg.hyperparams_dict()["tausq"]


def test_saas_neg_mll_and_gradient_match_jax():
    jg, tg = _pair(d=4)
    lps = np.random.default_rng(2).uniform(np.log(0.1), np.log(2.0),
                                           size=(3, 6))
    jv, jgrad = jax.vmap(jax.value_and_grad(
        lambda p: jgp.neg_mll(jg.state, jg.cfg, p)))(jnp.asarray(lps))
    tlp = torch.as_tensor(lps).requires_grad_(True)
    tv = tgp.neg_mll(tg.state, tg.cfg, tlp)
    (tgrad,) = torch.autograd.grad(tv.sum(), tlp)
    np.testing.assert_allclose(_np(tv), _np(jv), rtol=RTOL)
    np.testing.assert_allclose(_np(tgrad), _np(jgrad), rtol=1e-7,
                               atol=1e-9 * np.abs(_np(jgrad)).max())


def test_saas_fit_seeding_and_endpoints_match_jax():
    """Without x0 both packages seed the same restarts (current parameters
    with log tausq, then uniform draws) from the same generator, and the
    fit from the same x0 ends within 1e-6 |f| of the JAX package's."""
    jg, tg = _pair(d=3, n=40, seed=3)
    jr, tr = np.random.default_rng(4), np.random.default_rng(4)
    # the shapes and maxiter of the fit below: one JAX compile serves both
    jg.fit(n_restarts=4, maxiter=100, rng=jr)
    tg.fit(n_restarts=4, maxiter=100, rng=tr)
    assert jr.uniform() == tr.uniform()
    jg, tg = _pair(d=3, n=40, seed=3)
    x0 = np.random.default_rng(5).uniform(np.log(0.1), np.log(2.0),
                                          size=(4, 5))
    jf = -jg.fit(x0=jnp.asarray(x0), maxiter=100)["mll"]
    tf = -tg.fit(x0=x0, maxiter=100)["mll"]
    assert abs(tf - jf) <= 1e-6 * abs(jf), (tf, jf)


def test_saas_state_round_trip_both_ways(tmp_path):
    jg, tg = _pair(d=3, n=30, seed=6)
    lp = np.concatenate([np.log([0.3, 2.0, 3.0]), [np.log(1.2)],
                         [np.log(0.05)]])
    jg.update_hyperparams(jnp.asarray(lp))
    xq = np.random.default_rng(7).uniform(size=(5, 3))
    want = _np(jg.predict_mean_batched(jnp.asarray(xq)))
    tl = tgp.state_from_numpy(jg.state_dict(), device="cpu")
    assert tl.cfg.lengthscale_prior == "SAAS"
    assert tl.tausq == pytest.approx(0.05, rel=1e-12)
    np.testing.assert_allclose(_np(tl.predict_mean_batched(xq)), want,
                               rtol=1e-8)
    np.testing.assert_allclose(float(tl.neg_mll(lp)),
                               float(jg.neg_mll(jnp.asarray(lp))), rtol=RTOL)
    tl.save(str(tmp_path / "torch_saas"))
    jl = jgp.GP.load(str(tmp_path / "torch_saas"))
    assert jl.cfg.lengthscale_prior == "SAAS"
    assert jl.tausq == pytest.approx(0.05, rel=1e-12)
    np.testing.assert_allclose(_np(jl.predict_mean_batched(jnp.asarray(xq))),
                               want, rtol=1e-8)
    jg.save(str(tmp_path / "jax_saas"))
    t2 = tgp.GP.load(str(tmp_path / "jax_saas"), device="cpu")
    assert t2.tausq == pytest.approx(0.05, rel=1e-12)
