"""Parity of the port's batched NUTS (bobe_tpu_torch.infer.nuts and
samplers.sample_gp_nuts) with the JAX package's, on the CPU.

Deterministic, float64 at rtol 1e-9: the step-size search and whole NUTS
transitions (tree doublings, subtrees, U-turn checks, multinomial
proposals) of four chains at once, the port fed the momentum normals and
uniforms that the JAX package draws from its keys. The masks that freeze a
finished chain inside the lockstep batch are held to the chain run alone:
the same draws give the same chain. Whole runs are held statistically:
Gaussian moments, and the NUTS pool of a GP carried across by
``state_from_numpy`` against the JAX package's pool on the same GP.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bobe_tpu  # noqa: F401  (float64 in JAX)
from bobe_tpu import samplers as jsamp
from bobe_tpu.infer import nuts as jnuts
from bobe_tpu.models import gp as jgp
from bobe_tpu_torch import acquisition as tacq
from bobe_tpu_torch import samplers as tsamp
from bobe_tpu_torch.infer import nuts as tnuts
from bobe_tpu_torch.models import gp as tgp
from bobe_tpu_torch.utils.seed import set_global_seed

RTOL = 1e-9
MAX_DEPTH = 6
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
    """Row by row (no matmul across chains), so a chain's numbers do not
    depend on how many chains share the batch."""
    g = -torch.sum(z[:, None, :] * ICOV[None], dim=-1)
    return 0.5 * torch.sum(z * g, dim=-1), g


def _fixed_gps(kernel, d, seed=0, n=30):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, d))
    y = -10.0 * np.sum((x - 0.6) ** 2, axis=1)
    kw = dict(train_x=x, train_y=y, noise=1e-6, kernel=kernel,
              lengthscales=rng.uniform(0.3, 0.6, size=d), kernel_variance=3.0)
    return jgp.GP(**kw), tgp.GP(device="cpu", **kw)


def _jax_vg(jg):
    apply = jsamp._nuts_logprob_apply(jg.cfg, False, 0.0, 0.0, "", 1.0)
    return jax.value_and_grad(lambda z: apply(jg.state, z))


@jax.jit
def _jax_transition_draws(key):
    """What jnuts.nuts_step draws from ``key``, laid out as the port's
    per-transition block: the momentum normals, and the uniforms (direction
    per doubling as 0.25 for right and 0.75 for left, swap per doubling,
    then each subtree's leaves)."""
    d = 2
    k_mom, k_tree = jax.random.split(key)
    noise = jax.random.normal(k_mom, (d,), dtype=jnp.float64)
    dirs, swaps, leaves = [], [], []
    kc = k_tree
    for depth in range(MAX_DEPTH):
        kc, k_dir, k_sub, k_swap = jax.random.split(kc, 4)
        dirs.append(jnp.where(jax.random.bernoulli(k_dir), 0.25, 0.75))
        swaps.append(jax.random.uniform(k_swap, dtype=jnp.float64))
        ks = k_sub
        for _ in range(2 ** depth):
            ks, k_acc = jax.random.split(ks)
            leaves.append(jax.random.uniform(k_acc, dtype=jnp.float64))
    return noise, jnp.stack(dirs + swaps + leaves)


# ----------------------------------------------------------- deterministic

def test_find_reasonable_eps_matches_jax():
    jg, tg = _fixed_gps("rbf", 2, seed=1)
    jvg = _jax_vg(jg)
    z0 = np.random.default_rng(2).normal(size=(6, 2)) * 1.5
    z0[0] = [12.0, -15.0]  # a saturated start
    eye = jnp.eye(2)
    want, noise = [], []
    for c in range(6):
        key = jax.random.PRNGKey(100 + c)
        want.append(float(jnuts._find_reasonable_eps(
            jvg, jnp.asarray(z0[c]), key, jnuts.MassMatrix(eye, eye), True)))
        noise.append(np.asarray(jax.random.normal(key, (2,),
                                                  dtype=jnp.float64)))
    got = tnuts._find_reasonable_eps(
        tsamp._logprob_vg(tg, 1.0), torch.as_tensor(z0),
        torch.as_tensor(np.stack(noise)),
        tnuts._identity_mass(2, True, torch.float64, "cpu", (6,)), True)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    assert len(set(want)) > 1


def test_nuts_transitions_with_jax_draws_match_jax():
    """Four chains with their own dense masses and step sizes (from deep
    trees to single doublings) take three transitions in one batch; each
    matches the JAX package's single-chain ``nuts_step`` on the same draws:
    new state, acceptance statistic and divergence flag."""
    jg, tg = _fixed_gps("rbf", 2, seed=4)
    jvg = _jax_vg(jg)
    tvg = tsamp._logprob_vg(tg, 1.0)
    rng = np.random.default_rng(5)
    C = 4
    a = rng.normal(size=(C, 2, 2))
    covs = 0.2 * a @ np.swapaxes(a, 1, 2) + 0.3 * np.eye(2)
    eps = np.asarray([0.05, 0.3, 1.2, 6.0])
    tmass = tnuts._mass_from_cov(torch.as_tensor(covs), True, 50.0)
    jstep = jax.jit(lambda key, st, e, m: jnuts.nuts_step(jvg, key, st, e, m,
                                                          True, MAX_DEPTH))
    z0 = rng.normal(size=(C, 2))
    jstates = []
    for c in range(C):
        lp, g = jvg(jnp.asarray(z0[c]))
        jstates.append(jnuts.NutsCarry(jnp.asarray(z0[c]), lp, g))
    L, G = tvg(torch.as_tensor(z0))
    tstate = tnuts.NutsCarry(torch.as_tensor(z0), L, G)
    for t in range(3):
        noise, u, want = [], [], []
        for c in range(C):
            key = jax.random.PRNGKey(1000 * t + c)
            nz, uu = _jax_transition_draws(key)
            noise.append(np.asarray(nz))
            u.append(np.asarray(uu))
            jm = jnuts._mass_from_cov(jnp.asarray(covs[c]), True,
                                      jnp.asarray(50.0))
            st, acc, div = jstep(key, jstates[c], eps[c], jm)
            jstates[c] = st
            want.append((st, float(acc), bool(div)))
        tstate, acc, div, steps = tnuts.nuts_step(
            tvg, torch.as_tensor(np.stack(noise)), torch.as_tensor(np.stack(u)),
            tstate, torch.as_tensor(eps), tmass, True, MAX_DEPTH)
        assert 1 <= steps <= 2 ** MAX_DEPTH - 1
        for c in range(C):
            st, jacc, jdiv = want[c]
            np.testing.assert_allclose(tstate.z[c].numpy(), np.asarray(st.z),
                                       rtol=RTOL, atol=1e-12)
            np.testing.assert_allclose(float(tstate.logp[c]), float(st.logp),
                                       rtol=RTOL)
            np.testing.assert_allclose(tstate.grad[c].numpy(),
                                       np.asarray(st.grad), rtol=RTOL,
                                       atol=1e-12)
            np.testing.assert_allclose(float(acc[c]), jacc, rtol=RTOL,
                                       atol=1e-15)
            assert bool(div[c]) == jdiv


def test_masked_chains_equal_the_chain_run_alone():
    """C=4 chains in lockstep: every chain's samples, diagnostics and
    adapted kernel equal those of the same chain run alone with the same
    generator. The chains' trees differ in depth, so the lockstep runs
    leaves that are masked out for some of them."""
    init = torch.as_tensor(np.random.default_rng(3).normal(size=(4, 2)) * 2.0)
    seeds = [21, 22, 23, 24]
    kw = dict(num_warmup=40, num_samples=30, thinning=1, dense_mass=True)
    zs, logps, diag = tnuts.run_chain(
        _gauss_vg, init, [torch.Generator().manual_seed(s) for s in seeds],
        **kw)
    total_alone = 0
    for c in (0, 2):
        z1, l1, d1 = tnuts.run_chain(
            _gauss_vg, init[c:c + 1], [torch.Generator().manual_seed(seeds[c])],
            **kw)
        assert torch.equal(zs[c], z1[0]) and torch.equal(logps[c], l1[0])
        for k in ("mean_accept", "n_divergent", "step_size", "mass_inv",
                  "last_z"):
            assert torch.equal(diag[k][c], d1[k][0]), k
        total_alone = max(total_alone, d1["n_leapfrog"])
    # the batch ran more lockstep leaves than either chain alone needs
    assert diag["n_leapfrog"] > total_alone


# ------------------------------------------------------------- statistical

def test_run_chain_matches_gaussian_moments():
    init = torch.as_tensor(np.random.default_rng(1).normal(size=(4, 2)) * 3.0)
    zs, logps, diag = tnuts.run_chain(
        _gauss_vg, init, [torch.Generator().manual_seed(s) for s in range(4)],
        num_warmup=200, num_samples=400, thinning=1)
    x = zs.reshape(-1, 2).numpy()
    assert zs.shape == (4, 400, 2) and logps.shape == (4, 400)
    assert float(diag["mean_accept"].min()) > 0.6
    assert int(diag["n_divergent"].sum()) == 0
    np.testing.assert_allclose(x.mean(0), 0.0, atol=0.15)
    np.testing.assert_allclose(np.cov(x, rowvar=False), COV, atol=0.35)


@pytest.fixture(scope="module")
def pool_gps():
    """tests/test_ehmc.py's 60-point GP, fitted by the JAX package and
    carried across; the JAX package's NUTS pool on it (computed once)."""
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(60, 2))
    y = -0.5 * np.sum(((x - 0.55) / 0.12) ** 2, axis=1)
    jg = jgp.GP(train_x=jnp.asarray(x), train_y=jnp.asarray(y))
    jg.fit(n_restarts=2, maxiter=100, rng=rng)
    tg = tgp.state_from_numpy(jg.state_dict(), device="cpu")
    jpool = jsamp.sample_gp_nuts(jg, np_rng=np.random.default_rng(1),
                                 rng_key=jax.random.PRNGKey(6),
                                 warmup_steps=256, num_samples=512,
                                 thinning=2)
    return jg, tg, jpool


def test_sample_gp_nuts_pool_matches_jax(pool_gps):
    """Same settings as the JAX package's pool, and its chain count: on the
    tests' 8-device CPU mesh the JAX package rounds 4 chains up to 8, which
    the port (one device) does not."""
    _, tg, jpool = pool_gps
    out = tsamp.sample_gp_nuts(tg, np_rng=np.random.default_rng(2),
                               generator=torch.Generator().manual_seed(7),
                               num_chains=jpool["warm_state"]["num_chains"],
                               warmup_steps=256, num_samples=512, thinning=2)
    assert out["method"] == "MCMC" and out["x"].shape == jpool["x"].shape
    assert np.all((out["x"] >= 0) & (out["x"] <= 1))
    np.testing.assert_allclose(out["x"].mean(0), jpool["x"].mean(0), atol=0.03)
    np.testing.assert_allclose(out["x"].std(0), jpool["x"].std(0), atol=0.03)
    assert np.all(np.isfinite(out["logp"]))
    ws, jws = out["warm_state"], jpool["warm_state"]
    assert set(ws) == set(jws)
    for k in ws:
        assert np.shape(ws[k]) == np.shape(jws[k]), k
    assert np.all(out["diagnostics"]["mean_accept"] > 0.6)


def test_jax_nuts_warm_state_seeds_the_port(pool_gps):
    _, tg, jpool = pool_gps
    out = tsamp.sample_gp_nuts(tg, np_rng=np.random.default_rng(3),
                               generator=torch.Generator().manual_seed(8),
                               num_chains=jpool["warm_state"]["num_chains"],
                               warmup_steps=128, num_samples=256, thinning=2,
                               warm_state=jpool["warm_state"])
    assert out["diagnostics"]["warm"]
    np.testing.assert_allclose(out["x"].mean(0), jpool["x"].mean(0), atol=0.05)


def test_ehmc_warm_state_is_ignored_by_nuts(pool_gps):
    _, tg, _ = pool_gps
    ens = tsamp.sample_gp_ensemble(tg, np_rng=np.random.default_rng(4),
                                   generator=torch.Generator().manual_seed(9),
                                   num_samples=256)
    out = tsamp.sample_gp_nuts(tg, np_rng=np.random.default_rng(5),
                               generator=torch.Generator().manual_seed(10),
                               warmup_steps=64, num_samples=64, thinning=2,
                               warm_state=ens["warm_state"])
    assert out["x"].shape == (4 * 32, 2) and not out["diagnostics"]["warm"]


def test_get_mc_samples_nuts_dispatch_and_defaults(pool_gps):
    _, tg, _ = pool_gps
    out = tacq.get_mc_samples(tg, method="NUTS", num_samples=128,
                              warmup_steps=64,
                              np_rng=np.random.default_rng(6),
                              generator=torch.Generator().manual_seed(11))
    # 4 chains, thinning 4: 4 * 128 / 4 samples
    assert out["x"].shape == (128, 2)
    assert out["warm_state"]["kind"] == "nuts"
    assert out["warm_state"]["num_chains"] == 4
    assert out["warm_state"]["last_z"].shape == (4, 2)
    two = tacq.get_mc_samples(tg, method="NUTS", num_samples=64,
                              warmup_steps=64, num_chains=2, thinning=1,
                              np_rng=np.random.default_rng(7),
                              generator=torch.Generator().manual_seed(12))
    assert two["x"].shape == (128, 2) and two["warm_state"]["num_chains"] == 2
