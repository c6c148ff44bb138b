"""Parity of the port's ensemble HMC (bobe_tpu_torch.infer.ehmc, the HMC
helpers of infer/nuts.py, the sampler target and samplers.sample_gp_ensemble)
with the JAX package's, on the CPU.

Deterministic stages are compared on the same inputs in float64 at rtol
1e-9: the mass-matrix estimate, dual averaging, the warmup schedule, the
target density and its closed-form gradient against ``jax.grad``, a leapfrog
trajectory, and one ensemble transition fed the JAX package's own random
draws. The samplers draw from torch generators where JAX draws from its
keys, so whole runs are held statistically: Gaussian moments, and the MC
pool of a GP carried across by ``state_from_numpy`` against the JAX
package's pool on the same GP.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bobe_tpu  # noqa: F401  (float64 in JAX)
from bobe_tpu import samplers as jsamp
from bobe_tpu.infer import ehmc as jehmc
from bobe_tpu.infer import nuts as jnuts
from bobe_tpu.models import gp as jgp
from bobe_tpu_torch import acquisition as tacq
from bobe_tpu_torch import samplers as tsamp
from bobe_tpu_torch.infer import ehmc as tehmc
from bobe_tpu_torch.infer import nuts as tnuts
from bobe_tpu_torch.models import gp as tgp
from bobe_tpu_torch.utils.seed import set_global_seed

RTOL = 1e-9
COV = np.array([[1.0, 0.8], [0.8, 2.0]])
ICOV = torch.as_tensor(np.linalg.inv(COV))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _port_seed():
    set_global_seed(42)


def _gauss_vg(z):
    g = -(z @ ICOV)
    return 0.5 * torch.sum(z * g, dim=-1), g


def _fixed_gps(kernel, d, seed=0, n=30):
    """The same GP in both packages: hyperparameters fixed (not fitted) and
    noise 1e-6, so the two Cholesky factors agree far below rtol 1e-9."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, d))
    y = -10.0 * np.sum((x - 0.6) ** 2, axis=1)
    kw = dict(train_x=x, train_y=y, noise=1e-6, kernel=kernel,
              lengthscales=rng.uniform(0.3, 0.6, size=d), kernel_variance=3.0)
    return jgp.GP(**kw), tgp.GP(device="cpu", **kw)


def _jax_vg(jg, temp):
    apply = jsamp._nuts_logprob_apply(jg.cfg, False, 0.0, 0.0, "", float(temp))
    return jax.value_and_grad(lambda z: apply(jg.state, z))


def _targets(d, seed):
    """64 points in logit space, a quarter of them near saturation."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(64, d)) * 2.0
    z[:16] = rng.choice([-1.0, 1.0], size=(16, d)) * rng.uniform(
        20.0, 35.0, size=(16, d))
    return z


# ----------------------------------------------------------- deterministic

def test_mass_from_cov_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(3, 4, 4))
    covs = a @ np.swapaxes(a, 1, 2) + 0.1 * np.eye(4)
    got = tnuts._mass_from_cov(torch.as_tensor(covs), True, 37.0)
    for c in range(3):
        want = jnuts._mass_from_cov(jnp.asarray(covs[c]), True,
                                    jnp.asarray(37.0))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[c].numpy(), np.asarray(w), rtol=RTOL)
    var = rng.uniform(0.1, 3.0, size=(3, 4))
    got = tnuts._mass_from_cov(torch.as_tensor(var), False, 12.0)
    want = jnuts._mass_from_cov(jnp.asarray(var), False, jnp.asarray(12.0))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL)


def test_dual_averaging_matches_jax():
    accepts = np.random.default_rng(1).uniform(size=60)
    jda = jnuts._da_init(jnp.asarray(0.3))
    tda = tnuts._da_init(torch.tensor(0.3, dtype=torch.float64))
    # no update yet: the average is eps0 itself (tests/test_ehmc.py pins it)
    assert float(torch.exp(tda.log_eps_avg)) == pytest.approx(0.3, rel=1e-15)
    for a in accepts:
        jda = jnuts._da_update(jda, jnp.asarray(a))
        tda = tnuts._da_update(tda, torch.tensor(a, dtype=torch.float64))
        for g, w in zip(tda, jda):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL)


@pytest.mark.parametrize("num_warmup", [0, 24, 128, 512])
def test_warmup_schedule_matches_jax(num_warmup):
    got = tnuts._warmup_schedule(num_warmup)
    assert isinstance(got, np.ndarray) and got.dtype == bool
    assert got.shape == (num_warmup,)
    if num_warmup == 0:
        # the JAX package's schedule indexes an empty array and raises; the
        # port's is empty (no adaptation step, no mass update)
        with pytest.raises(IndexError):
            jnuts._warmup_schedule(0)
        return
    np.testing.assert_array_equal(got,
                                  np.asarray(jnuts._warmup_schedule(num_warmup)))


@pytest.mark.parametrize("kernel", ["rbf", "matern"])
@pytest.mark.parametrize("d", [2, 8])
def test_target_value_and_grad_match_jax(kernel, d):
    """The tempered GP mean plus the logit Jacobian and its closed-form
    gradient against ``jax.grad`` of the JAX package's target, at 64 points
    (16 near saturation). The gradient is held at rtol 1e-9 plus 1e-9 of
    its largest component: the JAX package's gradient of the matmul
    distance expansion sums terms ~|x/l|^2 times larger than where it
    cancels to zero."""
    jg, tg = _fixed_gps(kernel, d, seed=d)
    z = _targets(d, seed=10 + d)
    for temp in (1.0, 2.5):
        jl, jgr = jax.vmap(_jax_vg(jg, temp))(jnp.asarray(z))
        tl, tgr = tsamp._logprob_vg(tg, temp)(torch.as_tensor(z))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL)
        jgr = np.asarray(jgr)
        np.testing.assert_allclose(tgr.numpy(), jgr, rtol=RTOL,
                                   atol=1e-9 * np.abs(jgr).max())
        assert np.all(np.isfinite(tgr.numpy()))
    # the mean alone is models/gp.predict_mean
    x = torch.sigmoid(torch.as_tensor(z))
    m, _ = tgp.predict_mean_value_and_grad(tg.state, tg.cfg, x)
    np.testing.assert_allclose(m.numpy(), tg.predict_mean_batched(x).numpy(),
                               rtol=RTOL)


def test_leapfrog_trajectory_matches_jax():
    """25 leapfrog steps of three chains from fixed momenta under a dense
    mass, step for step against the JAX package's ``_leapfrog``."""
    d, C, n = 3, 3, 25
    jg, tg = _fixed_gps("rbf", d, seed=3)
    rng = np.random.default_rng(4)
    a = rng.normal(size=(d, d))
    cov = 0.3 * (a @ a.T) + 0.5 * np.eye(d)
    jmass = jnuts._mass_from_cov(jnp.asarray(cov), True, jnp.asarray(100.0))
    tmass = tnuts._mass_from_cov(torch.as_tensor(cov), True, 100.0)
    z0, p0 = rng.normal(size=(C, d)), rng.normal(size=(C, d))
    eps = np.asarray([0.05, 0.1, 0.2])
    jvg = _jax_vg(jg, 1.0)
    tvg = tsamp._logprob_vg(tg, 1.0)
    Z, P = torch.as_tensor(z0), torch.as_tensor(p0)
    L, G = tvg(Z)
    E = torch.as_tensor(eps)[:, None]
    want = []
    for c in range(C):
        z, p = jnp.asarray(z0[c]), jnp.asarray(p0[c])
        logp, grad = jvg(z)
        traj = []
        for _ in range(n):
            z, p, logp, grad = jnuts._leapfrog(jvg, z, p, grad, eps[c], jmass,
                                               True)
            traj.append((np.asarray(z), np.asarray(p), float(logp)))
        want.append(traj)
    for step in range(n):
        Z, P, L, G = tnuts._leapfrog(tvg, Z, P, G, E, tmass, True)
        for c in range(C):
            wz, wp, wl = want[c][step]
            np.testing.assert_allclose(Z[c].numpy(), wz, rtol=RTOL, atol=1e-12)
            np.testing.assert_allclose(P[c].numpy(), wp, rtol=RTOL, atol=1e-12)
            np.testing.assert_allclose(float(L[c]), wl, rtol=RTOL)


def test_ensemble_transition_with_jax_draws_matches_jax():
    """One 7-leapfrog transition of 16 chains, the port fed the momentum
    normals and accept uniforms that the JAX package draws from its key:
    the same chains move, to the same states."""
    d, C = 2, 16
    jg, tg = _fixed_gps("matern", d, seed=5)
    rng = np.random.default_rng(6)
    z0 = rng.normal(size=(C, d))
    jvg = jax.vmap(_jax_vg(jg, 1.0))
    tvg = tsamp._logprob_vg(tg, 1.0)
    jmass = jnuts.MassMatrix(jnp.eye(d), jnp.eye(d))
    tmass = tnuts.MassMatrix(torch.eye(d, dtype=torch.float64),
                             torch.eye(d, dtype=torch.float64))
    key = jax.random.PRNGKey(7)
    jl, jgr = jvg(jnp.asarray(z0))
    jout = jehmc._ensemble_transition(jvg, key, jnp.asarray(z0), jl, jgr, 0.4,
                                      7, jmass, True)
    k_mom, k_acc = jax.random.split(key)
    noise = jax.vmap(lambda k: jax.random.normal(k, (d,), dtype=jnp.float64))(
        jax.random.split(k_mom, C))
    u = jax.random.uniform(k_acc, (C,), dtype=jnp.float64)
    Z = torch.as_tensor(z0)
    L, G = tvg(Z)
    tout = tehmc._ensemble_transition(
        tvg, torch.as_tensor(np.asarray(noise)),
        torch.log(torch.as_tensor(np.asarray(u))), Z, L, G,
        torch.tensor(0.4, dtype=torch.float64), 7, tmass, True)
    for g, w in zip(tout, jout):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=1e-12)
    moved = np.any(tout[0].numpy() != z0, axis=1)
    assert 0 < moved.sum()


# ------------------------------------------------------------- statistical

def test_run_ensemble_matches_gaussian_moments():
    init = torch.as_tensor(np.random.default_rng(1).normal(size=(64, 2)) * 3.0)
    zs, logps, diag = tehmc.run_ensemble(_gauss_vg, init,
                                         torch.Generator().manual_seed(0),
                                         num_warmup=128, num_samples=32,
                                         thinning=2)
    x = zs.reshape(-1, 2).numpy()
    assert zs.shape == (32, 64, 2) and logps.shape == (32, 64)
    assert float(diag["mean_accept"]) > 0.6
    assert int(diag["n_divergent"]) == 0
    np.testing.assert_allclose(x.mean(0), 0.0, atol=0.15)
    np.testing.assert_allclose(np.cov(x, rowvar=False), COV, atol=0.35)


def test_run_ensemble_warm_restart_and_zero_warmup():
    init = torch.as_tensor(np.random.default_rng(2).normal(size=(64, 2)) * 3.0)
    _, _, diag = tehmc.run_ensemble(_gauss_vg, init,
                                    torch.Generator().manual_seed(3),
                                    num_warmup=128, num_samples=8, thinning=2)
    warm = (diag["step_size"], diag["mass_inv"], diag["mass_chol"])
    zs, _, d2 = tehmc.run_ensemble(_gauss_vg, diag["last_z"],
                                   torch.Generator().manual_seed(4),
                                   num_warmup=16, num_samples=32, thinning=2,
                                   warm=warm, adapt_mass=False)
    x = zs.reshape(-1, 2).numpy()
    assert float(d2["mean_accept"]) > 0.6
    np.testing.assert_allclose(x.mean(0), 0.0, atol=0.2)
    np.testing.assert_allclose(np.cov(x, rowvar=False), COV, atol=0.45)
    # zero adaptation steps sample at the warm step size
    eye = torch.eye(2, dtype=torch.float64)
    _, _, d0 = tehmc.run_ensemble(
        _gauss_vg, init[:8], torch.Generator().manual_seed(5), num_warmup=0,
        num_samples=4, thinning=1,
        warm=(torch.tensor(0.0625, dtype=torch.float64), eye, eye),
        adapt_mass=False)
    assert float(d0["step_size"]) == pytest.approx(0.0625, rel=1e-15)


@pytest.fixture(scope="module")
def pool_gps():
    """tests/test_ehmc.py's 60-point GP, fitted by the JAX package and
    carried across; the JAX package's cold EHMC pool on it (computed once)."""
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(60, 2))
    y = -0.5 * np.sum(((x - 0.55) / 0.12) ** 2, axis=1)
    jg = jgp.GP(train_x=jnp.asarray(x), train_y=jnp.asarray(y))
    jg.fit(n_restarts=2, maxiter=100, rng=rng)
    tg = tgp.state_from_numpy(jg.state_dict(), device="cpu")
    jpool = jsamp.sample_gp_ensemble(jg, np_rng=np.random.default_rng(1),
                                     rng_key=jax.random.PRNGKey(5),
                                     num_samples=1024)
    return jg, tg, jpool


def test_sample_gp_ensemble_pool_matches_jax(pool_gps):
    _, tg, jpool = pool_gps
    out = tsamp.sample_gp_ensemble(tg, np_rng=np.random.default_rng(2),
                                   generator=torch.Generator().manual_seed(6),
                                   num_samples=1024)
    assert out["method"] == "MCMC" and out["x"].shape == jpool["x"].shape
    assert np.all((out["x"] >= 0) & (out["x"] <= 1))
    np.testing.assert_allclose(out["x"].mean(0), jpool["x"].mean(0), atol=0.03)
    np.testing.assert_allclose(out["x"].std(0), jpool["x"].std(0), atol=0.03)
    np.testing.assert_allclose(out["logp"], tg.predict_mean_batched(
        out["x"]).numpy(), rtol=RTOL)
    ws, jws = out["warm_state"], jpool["warm_state"]
    assert set(ws) == set(jws)
    for k in ws:
        assert np.shape(ws[k]) == np.shape(jws[k]), k
    assert ws["kind"] == "ehmc" and not out["diagnostics"]["warm"]
    assert out["diagnostics"]["mean_accept"] > 0.5


def test_jax_warm_state_seeds_the_port(pool_gps):
    """A JAX warm state takes the port's warm path (24 fixed-mass
    re-adaptation transitions) and stays on the cold pool's mean."""
    jg, tg, jpool = pool_gps
    cold = tsamp.sample_gp_ensemble(tg, np_rng=np.random.default_rng(3),
                                    generator=torch.Generator().manual_seed(7),
                                    num_samples=512)
    warm = tsamp.sample_gp_ensemble(tg, np_rng=np.random.default_rng(4),
                                    generator=torch.Generator().manual_seed(8),
                                    num_samples=512,
                                    warm_state=jpool["warm_state"])
    assert warm["diagnostics"]["warm"]
    assert warm["diagnostics"]["mean_accept"] > 0.5
    np.testing.assert_allclose(warm["x"].mean(0), cold["x"].mean(0), atol=0.05)
    # and the port's warm state seeds the JAX package
    again = jsamp.sample_gp_ensemble(jg, np_rng=np.random.default_rng(5),
                                     rng_key=jax.random.PRNGKey(9),
                                     num_samples=512,
                                     warm_state=warm["warm_state"])
    np.testing.assert_allclose(again["x"].mean(0), cold["x"].mean(0),
                               atol=0.05)


def test_get_mc_samples_ehmc_dispatch_and_defaults(pool_gps):
    _, tg, _ = pool_gps
    out = tacq.get_mc_samples(tg, method="EHMC", num_samples=256,
                              np_rng=np.random.default_rng(3),
                              generator=torch.Generator().manual_seed(11))
    assert out["x"].shape[0] >= 256
    assert np.all((out["x"] >= 0) & (out["x"] <= 1))
    assert out["warm_state"]["kind"] == "ehmc"
    assert out["warm_state"]["num_chains"] == 64


def test_get_mc_samples_forwards_tuning_to_ehmc(pool_gps):
    """Explicit num_chains / warmup_steps / thinning reach the ensemble,
    and a matching warm_state is used."""
    _, tg, _ = pool_gps
    kw = dict(method="EHMC", num_samples=256, num_chains=16, warmup_steps=32,
              thinning=1)
    out = tacq.get_mc_samples(tg, np_rng=np.random.default_rng(3),
                              generator=torch.Generator().manual_seed(12),
                              **kw)
    assert out["warm_state"]["num_chains"] == 16
    assert out["warm_state"]["last_z"].shape == (16, 2)
    assert out["x"].shape[0] >= 256
    again = tacq.get_mc_samples(tg, np_rng=np.random.default_rng(4),
                                generator=torch.Generator().manual_seed(13),
                                warm_state=out["warm_state"], **kw)
    assert again["diagnostics"]["warm"]
