"""Parity of the port's linear algebra, MLL and optimizer with the JAX
package's, on the CPU: Cholesky with its jitter ladder, solves, the block
and rank-1 extensions, ``gp_mll``, and the lockstep L-BFGS.

Inputs come from a numpy seed and go through both packages, in float64, held
to rtol 1e-9 unless a test states otherwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bobe_tpu  # noqa: F401  (float64 in JAX)
from bobe_tpu.ops import chol as jchol
from bobe_tpu.ops import kernels as jkr
from bobe_tpu.ops import mll as jmll
from bobe_tpu.ops import optimize as jopt
from bobe_tpu_torch.ops import chol as tchol
from bobe_tpu_torch.ops import mll as tmll
from bobe_tpu_torch.ops import optimize as topt

RTOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _padded_gram(cap=64, n=40, d=3, seed=0, noise=1e-6):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(cap, d))
    x[n:] = 0.5
    mask = (np.arange(cap) < n).astype(np.float64)
    ls = rng.uniform(0.2, 0.8, size=d)
    amp = 1.7
    K = np.asarray(jkr.gram_masked("rbf", jnp.asarray(x), jnp.asarray(mask),
                                   jnp.asarray(ls), amp, noise))
    return x, mask, ls, amp, K


def test_cholesky_and_solves_match_jax():
    _, mask, _, amp, K = _padded_gram()
    b = np.random.default_rng(1).normal(size=(K.shape[0], 5))
    Lj = np.asarray(jchol.cholesky(jnp.asarray(K)))
    Lt = tchol.cholesky(_t(K))
    np.testing.assert_allclose(Lt.numpy(), Lj, rtol=RTOL, atol=1e-13)
    # padded factor is [[L, 0], [0, I]]
    np.testing.assert_array_equal(Lt[40:, 40:].numpy(), np.eye(24))
    np.testing.assert_allclose(
        tchol.cholesky_jittered(_t(K), _t(mask), amp).numpy(), Lj,
        rtol=RTOL, atol=1e-13)
    for bb in (b, b[:, 0]):
        np.testing.assert_allclose(
            tchol.cho_solve(Lt, _t(bb)).numpy(),
            np.asarray(jchol.cho_solve(jnp.asarray(Lj), jnp.asarray(bb))),
            rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(
            tchol.tri_solve(Lt, _t(bb)).numpy(),
            np.asarray(jchol.tri_solve(jnp.asarray(Lj), jnp.asarray(bb))),
            rtol=RTOL, atol=1e-12)


def test_cholesky_jittered_ladder_matches_jax_on_a_singular_matrix():
    """A rank-deficient Gram fails the zero-jitter rung in both packages;
    both climb the same ladder to the same finite factor."""
    rng = np.random.default_rng(2)
    v = rng.normal(size=(16, 3))
    K = v @ v.T  # rank 3
    mask = np.ones(16)
    assert not np.isfinite(tchol.cholesky(_t(K)).numpy()).all()
    Lj = np.asarray(jchol.cholesky_jittered(jnp.asarray(K),
                                            jnp.asarray(mask), 1.0))
    Lt = tchol.cholesky_jittered(_t(K), _t(mask), 1.0).numpy()
    assert np.isfinite(Lt).all()
    np.testing.assert_allclose(Lt, Lj, rtol=1e-7, atol=1e-9)


def test_block_and_rank1_extensions_match_jax():
    x, mask, ls, amp, K = _padded_gram(cap=64, n=30, seed=3)
    L = np.asarray(jchol.cholesky(jnp.asarray(K)))
    rng = np.random.default_rng(4)
    xn = rng.uniform(size=(3, 3))
    K21 = np.asarray(jkr.cross_kernel("rbf", jnp.asarray(xn), jnp.asarray(x),
                                      jnp.asarray(ls), amp)) * mask[None, :]
    K22 = np.asarray(jkr.cross_kernel("rbf", jnp.asarray(xn), jnp.asarray(xn),
                                      jnp.asarray(ls), amp)) + 1e-6 * np.eye(3)
    jL21, jL22 = jchol.extend_cholesky_block(jnp.asarray(L), jnp.asarray(K21),
                                             jnp.asarray(K22))
    tL21, tL22 = tchol.extend_cholesky_block(_t(L), _t(K21), _t(K22))
    np.testing.assert_allclose(tL21.numpy(), np.asarray(jL21), rtol=1e-8,
                               atol=1e-12)
    np.testing.assert_allclose(tL22.numpy(), np.asarray(jL22), rtol=1e-8,
                               atol=1e-12)

    Ln = L[:30, :30]
    k = K21[0, :30]
    want = np.asarray(jchol.rank1_extend(jnp.asarray(Ln), jnp.asarray(k),
                                         amp + 1e-6))
    got = tchol.rank1_extend(_t(Ln), _t(k), amp + 1e-6).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-12)


def test_gp_mll_matches_jax_and_batches_over_lanes():
    _, mask, _, _, K = _padded_gram(seed=5)
    y = np.random.default_rng(6).normal(size=K.shape[0]) * mask
    want = float(jmll.gp_mll(jnp.asarray(K), jnp.asarray(y), 40))
    got = float(tmll.gp_mll(_t(K), _t(y), 40))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    # a (R, cap, cap) batch of Grams gives the R values
    _, _, _, _, K2 = _padded_gram(seed=7)
    batch = tmll.gp_mll(_t(np.stack([K, K2])), _t(y), 40).numpy()
    want2 = float(jmll.gp_mll(jnp.asarray(K2), jnp.asarray(y), 40))
    np.testing.assert_allclose(batch, [want, want2], rtol=RTOL)


def test_distribution_logprobs_match_jax():
    x = np.asarray([0.05, 0.3, 1.0, 4.0])
    for spec in ({"name": "lognormal", "loc": 0.2, "scale": 0.7},
                 {"name": "halfcauchy", "scale": 0.5},
                 {"name": "uniform", "low": 0.01, "high": 5.0},
                 {"name": "normal", "loc": 1.0, "scale": 2.0},
                 {"name": "gamma", "concentration": 2.0, "rate": 1.5}):
        np.testing.assert_allclose(
            tmll.spec_logprob(spec, _t(x)).numpy(),
            np.asarray(jmll.spec_logprob(spec, jnp.asarray(x))), rtol=RTOL)


def _rosen_terms(x):
    return 100.0 * (x[..., 1:] - x[..., :-1] ** 2) ** 2 + (1.0 - x[..., :-1]) ** 2


@pytest.mark.parametrize("maxiter", [1, 5, 25])
def test_lockstep_lbfgs_follows_the_jax_optimizer(maxiter):
    """Same algorithm step for step (optax's L-BFGS direction, backtracking
    at 0.45 x 3, sigmoid box, z-clip, patience/ftol retirement): from the
    same x0 the endpoints agree. rtol 1e-6: the two runs round differently
    in the last bits and Rosenbrock's valley amplifies that over steps."""
    x0 = np.random.default_rng(0).uniform(-1.5, 1.5, size=(4, 3))
    bounds = np.asarray([[-2.0] * 3, [2.0] * 3])
    jx, jf = jopt.minimize_restarts(lambda x: jnp.sum(_rosen_terms(x)),
                                    jnp.asarray(x0),
                                    bounds=jnp.asarray(bounds),
                                    maxiter=maxiter, return_all=True)
    tx, tf = topt.minimize_restarts(lambda x: _rosen_terms(x).sum(dim=-1),
                                    _t(x0),
                                    bounds=_t(bounds), maxiter=maxiter,
                                    return_all=True)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-6,
                               atol=1e-9)


def test_lockstep_lbfgs_converges_and_retires_nan_lanes():
    target = torch.tensor([0.3, -0.2, 0.7], dtype=torch.float64)

    def fun(x):
        v = torch.sum((x - target) ** 2, dim=-1)
        # lane 1 evaluates to NaN from its start: retired, value inf
        return torch.where(torch.arange(x.shape[0]) == 1,
                           torch.full_like(v, float("nan")), v)

    x0 = _t(np.random.default_rng(0).uniform(-1, 1, size=(3, 3)))
    x_all, f_all = topt.minimize_restarts(fun, x0, bounds=(-1.0, 1.0),
                                          maxiter=200, return_all=True)
    assert np.isinf(float(f_all[1]))
    x, f = topt.minimize_restarts(fun, x0, bounds=(-1.0, 1.0), maxiter=200)
    np.testing.assert_allclose(x.numpy(), target.numpy(), atol=1e-4)
    assert float(f) < 1e-8
