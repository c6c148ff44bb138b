"""The port's device mesh (bobe_tpu_torch/parallel/mesh.py) on the CPU.

A mesh that names the CPU device two or three times runs the split, the
padding, the per-device threads and the gather that a mesh of cards runs
(the counterpart of the JAX package's tests on the conftest's 8 virtual CPU
devices). The sharded functions are held to the port's unsharded ones and
to the JAX package's on the same GP state (data and hyperparameters from a
numpy seed, GP noise 1e-3 so that both packages' factors agree far below
the tolerance), at rtol 1e-9; the call sites (acquisition, nested sampling,
EHMC, NUTS) to their unsharded runs with the production mesh set to such a
mesh. The JAX package's sharded predict is no oracle (its own test fails on
a CPU-only host): the port's is held to the JAX package's unsharded
predict.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bobe_tpu  # noqa: F401  (float64 in JAX)
from bobe_tpu.models import gp as jgp
from bobe_tpu.parallel import mesh as jmesh
from bobe_tpu_torch import acquisition as tacq
from bobe_tpu_torch import samplers as tsamp
from bobe_tpu_torch.infer.nuts import run_chain
from bobe_tpu_torch.models import gp as tgp
from bobe_tpu_torch.parallel import mesh as tmesh
from bobe_tpu_torch.utils.seed import set_global_seed, split_generator

RTOL = 1e-9
MESHES = {"cpu x2": ["cpu", "cpu"], "cpu x3": ["cpu"] * 3}


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
    """The same 3-d GP in both packages (hyperparameters fixed)."""
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(40, 3))
    y = -10.0 * np.sum((x - 0.45) ** 2, axis=1)
    kw = dict(train_x=x, train_y=y, noise=1e-3,
              lengthscales=np.asarray([0.35, 0.45, 0.4]), kernel_variance=3.0)
    return jgp.GP(**kw), tgp.GP(device="cpu", **kw)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


@pytest.mark.parametrize("n,m", [(19, 8), (16, 8), (7, 3), (1, 2), (6, 3)])
def test_pad_to_multiple_matches_jax(n, m):
    x = np.random.default_rng(n).uniform(size=(n, 2))
    jp, jn = jmesh.pad_to_multiple(jnp.asarray(x), m)
    tp, tn = tmesh.pad_to_multiple(torch.as_tensor(x), m)
    assert tn == jn == n
    np.testing.assert_array_equal(_np(tp), _np(jp))


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_predict_matches_unsharded_and_jax(gps, mesh):
    jg, tg = gps
    xq = np.random.default_rng(3).uniform(size=(19, 3))  # not a multiple
    mean_s, var_s = tmesh.sharded_predict(tg, xq, tmesh.get_mesh(MESHES[mesh]))
    mean_u, var_u = tgp.predict(tg.state, tg.cfg, torch.as_tensor(xq))
    assert mean_s.shape == (19,) and var_s.shape == (19,)
    np.testing.assert_allclose(_np(mean_s), _np(mean_u), rtol=1e-12)
    np.testing.assert_allclose(_np(var_s), _np(var_u), rtol=1e-12)
    jmean, jvar = jgp.predict(jg.state, jg.cfg, jnp.asarray(xq))
    np.testing.assert_allclose(_np(mean_s), _np(jmean), rtol=RTOL)
    np.testing.assert_allclose(_np(var_s), _np(jvar), rtol=RTOL)


@pytest.mark.parametrize("n_mc", [16, 19])
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("use_std", [True, False])
def test_sharded_wip_sweep_matches_jax_sharded(gps, n_mc, mesh, use_std):
    """An even and an uneven pool: the copies that pad the pool to the mesh
    never enter the integration mean (held to the JAX package's sharded
    sweep on the conftest's 8 devices, which pads to 8)."""
    jg, tg = gps
    assert len(jax.devices()) == 8, "conftest must fake 8 devices"
    mc = np.random.default_rng(n_mc).uniform(size=(n_mc, 3))
    got = tmesh.sharded_wip_sweep(tg, mc, use_std,
                                  tmesh.get_mesh(MESHES[mesh]))
    want = jmesh.sharded_wip_sweep(jg, jnp.asarray(mc), use_std=use_std)
    assert got.shape == (n_mc,)
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL)
    unsharded, _, _ = tacq._wip_sweep_core(tg, torch.as_tensor(mc), use_std)
    np.testing.assert_allclose(_np(got), _np(unsharded), rtol=1e-12)


def _quadratic_target(ctx):
    icov = ctx

    def vg(z):
        g = -(z @ icov)
        return 0.5 * torch.sum(z * g, dim=-1), g

    return vg


def test_sharded_nuts_matches_unsharded_chain_for_chain():
    """Each chain draws from its own generator, so splitting the chains
    over the mesh leaves every chain's draws, and on a target evaluated
    row by row its samples, as they were."""
    icov = torch.as_tensor(np.linalg.inv(np.array([[1.0, 0.6], [0.6, 1.5]])))
    init = torch.as_tensor(np.random.default_rng(0).normal(size=(8, 2)))
    kwargs = dict(num_warmup=64, num_samples=32, thinning=2, max_depth=5)
    gens = lambda: split_generator(torch.Generator().manual_seed(1), 8)
    zs_s, lp_s, diag_s = tmesh.sharded_nuts(
        _quadratic_target, icov, init, gens(),
        tmesh.get_mesh(["cpu"] * 4), **kwargs)
    zs_u, lp_u, diag_u = run_chain(_quadratic_target(icov), init, gens(),
                                   **kwargs)
    np.testing.assert_allclose(_np(zs_s), _np(zs_u), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(_np(lp_s), _np(lp_u), rtol=1e-12, atol=1e-14)
    for k in ("mean_accept", "step_size", "mass_inv", "last_z"):
        np.testing.assert_allclose(_np(diag_s[k]), _np(diag_u[k]),
                                   rtol=1e-12, atol=1e-14, err_msg=k)
    np.testing.assert_array_equal(_np(diag_s["n_divergent"]),
                                  _np(diag_u["n_divergent"]))
    assert diag_s["n_leapfrog"] <= diag_u["n_leapfrog"]


def test_sharded_nuts_splits_a_warm_kernel_with_the_chains(gps):
    """A warm start's per-chain step size and mass go with their chains."""
    _, tg = gps
    make_vg, ctx = tsamp._logprob_target(tg, 1.0)
    init = torch.as_tensor(np.random.default_rng(2).normal(size=(6, 3)))
    d = 3
    warm = (torch.linspace(0.2, 0.45, 6, dtype=torch.float64),
            torch.eye(d, dtype=torch.float64).repeat(6, 1, 1) * 0.5,
            torch.eye(d, dtype=torch.float64).repeat(6, 1, 1) * 2 ** 0.5)
    kwargs = dict(num_warmup=8, num_samples=8, thinning=2, max_depth=4,
                  warm=warm, adapt_mass=False)
    gens = lambda: split_generator(torch.Generator().manual_seed(3), 6)
    zs_s, _, diag_s = tmesh.sharded_nuts(make_vg, ctx, init, gens(),
                                         tmesh.get_mesh(["cpu"] * 3), **kwargs)
    # the same chains run in the mesh's groups of two, unsharded
    for lo in range(0, 6, 2):
        rows = slice(lo, lo + 2)
        zs_g, _, diag_g = run_chain(
            make_vg(ctx), init[rows], gens()[rows],
            **{**kwargs, "warm": tuple(t[rows] for t in warm)})
        np.testing.assert_array_equal(_np(zs_s[rows]), _np(zs_g))
        np.testing.assert_array_equal(_np(diag_s["mass_inv"][rows]),
                                      _np(diag_g["mass_inv"]))


def test_mesh_aligned_chains_rounds_up_to_the_mesh(monkeypatch):
    mesh3 = tmesh.get_mesh(["cpu"] * 3)
    monkeypatch.setattr(tsamp, "production_mesh", lambda device=None: mesh3)
    assert tsamp._mesh_aligned_chains(4, "cpu") == 6
    assert tsamp._mesh_aligned_chains(6, "cpu") == 6
    assert tsamp._mesh_aligned_chains(64, "cpu") == 66
    monkeypatch.setattr(tsamp, "production_mesh", lambda device=None: None)
    assert tsamp._mesh_aligned_chains(4, "cpu") == 4


def test_production_mesh_is_none_on_the_cpu_and_when_disabled(monkeypatch):
    monkeypatch.delenv("BOBE_TPU_NO_MESH", raising=False)
    monkeypatch.setenv("BOBE_TPU_MESH", "1")
    assert tmesh.production_mesh("cpu") is None
    if not torch.cuda.is_available():
        assert tmesh.production_mesh() is None
        assert tmesh.production_mesh("cuda") is None
    monkeypatch.setenv("BOBE_TPU_NO_MESH", "1")
    assert tmesh.production_mesh("cuda") is None
    assert tmesh.production_mesh("cpu") is None


@pytest.mark.parametrize("env,cards,want", [
    ({}, 2, None),
    ({"BOBE_TPU_MESH": "1"}, 2, ("cuda:0", "cuda:1")),
    ({"BOBE_TPU_MESH": "1"}, 4, ("cuda:0", "cuda:1", "cuda:2", "cuda:3")),
    ({"BOBE_TPU_MESH": "1"}, 1, None),
    ({"BOBE_TPU_MESH": "1", "BOBE_TPU_NO_MESH": "1"}, 2, None),
    ({"BOBE_TPU_MESH": "0"}, 2, None),
])
def test_production_mesh_is_opt_in(monkeypatch, env, cards, want):
    """On a host with several cards (the card count stands in here) the
    production mesh is every card only where BOBE_TPU_MESH=1 asks for it:
    the split is not yet shown to pay on two cards."""
    for k in ("BOBE_TPU_MESH", "BOBE_TPU_NO_MESH"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(tmesh, "_PRODUCTION_MESH", None)
    got = tmesh.production_mesh("cuda")
    assert got == (None if want is None
                   else tuple(torch.device(d) for d in want))


def test_replicas_are_made_once_per_state(gps):
    _, tg = gps
    tmesh._replicas.clear()
    mesh = tmesh.get_mesh(["cpu"] * 3)
    xq = torch.as_tensor(np.random.default_rng(4).uniform(size=(9, 3)))
    tmesh.sharded_predict(tg, xq, mesh)
    tmesh.sharded_predict(tg, xq, mesh)
    assert list(tmesh._replicas) == [(id(tg.state), "cpu")]


# ------------------------------------------------ the production call sites

@pytest.fixture
def cpu_mesh(monkeypatch):
    """The production mesh set to the CPU named three times at every call
    site that consults it."""
    mesh = tmesh.get_mesh(["cpu"] * 3)
    for mod in (tacq, tsamp):
        monkeypatch.setattr(mod, "production_mesh", lambda device=None: mesh)
    return mesh


def _wip_pool(gps, n):
    return {"x": np.random.default_rng(n).uniform(size=(n, 3))}


def test_wip_sweep_and_batch_with_the_production_mesh(gps, monkeypatch):
    _, tg = gps
    wip = tacq.WIPStd()
    acq_kwargs = {"mc_samples": _wip_pool(gps, 40), "mc_points_size": 40}
    monkeypatch.setattr(tacq, "REFINE_MAX_N", -1)
    want_pt = wip.get_next_point(tg, acq_kwargs=acq_kwargs,
                                 rng=np.random.default_rng(1))
    want_b = wip.get_next_batch(tg, n_batch=4, acq_kwargs=acq_kwargs,
                                rng=np.random.default_rng(1))
    mesh = tmesh.get_mesh(["cpu"] * 3)
    monkeypatch.setattr(tacq, "production_mesh", lambda device=None: mesh)
    got_pt = wip.get_next_point(tg, acq_kwargs=acq_kwargs,
                                rng=np.random.default_rng(1))
    got_b = wip.get_next_batch(tg, n_batch=4, acq_kwargs=acq_kwargs,
                               rng=np.random.default_rng(1))
    np.testing.assert_array_equal(got_pt[0], want_pt[0])
    np.testing.assert_allclose(got_pt[1], want_pt[1], rtol=1e-12)
    np.testing.assert_array_equal(got_b[0], want_b[0])
    np.testing.assert_allclose(got_b[1], want_b[1], rtol=1e-12)


def test_nested_sampling_with_the_production_mesh(gps, cpu_mesh):
    """The proposal batches split over the mesh: the same draws, so the
    same run."""
    _, tg = gps
    runs = []
    for mesh in (None, cpu_mesh):
        samples, logz, ok = tsamp.nested_sampling(
            tg, mode="acq", nlive=60, rng=np.random.default_rng(5),
            generator=torch.Generator().manual_seed(5), mesh=mesh)
        assert ok
        runs.append((samples, logz))
    (s_u, l_u), (s_m, l_m) = runs
    np.testing.assert_allclose(l_m["mean"], l_u["mean"], rtol=1e-9)
    np.testing.assert_allclose(s_m["x"], s_u["x"], rtol=1e-9)
    assert s_m["n_calls"] == s_u["n_calls"]


@pytest.mark.parametrize("sampler", ["ehmc", "nuts"])
def test_mcmc_pools_with_the_production_mesh(gps, monkeypatch, sampler):
    """EHMC splits its target's evaluation, NUTS its chains; every chain
    draws the same numbers on either layout. The GP mean and gradient of a
    chunk of the chains is a matrix product of another width than the
    whole batch's, whose roundoff differs at 1e-15 relative, and the
    dynamics amplify it over the run (measured: 1.5e-4 for the ensemble,
    whose step size and mass adapt on all chains, 1.8e-8 for NUTS): the
    samples agree to 1e-3, where a chain whose layout changed its math
    would be off by the posterior's width (~0.1).
    test_sharded_target_equals_the_chunked_target holds the split itself
    exactly."""
    _, tg = gps
    if sampler == "ehmc":
        run = lambda: tsamp.sample_gp_ensemble(
            tg, np_rng=np.random.default_rng(2),
            generator=torch.Generator().manual_seed(2), num_chains=6,
            num_samples=48, warmup_steps=24)
    else:
        run = lambda: tsamp.sample_gp_nuts(
            tg, np_rng=np.random.default_rng(2),
            generator=torch.Generator().manual_seed(2), num_chains=6,
            warmup_steps=24, num_samples=16, thinning=2)
    want = run()
    mesh = tmesh.get_mesh(["cpu"] * 3)
    monkeypatch.setattr(tsamp, "production_mesh", lambda device=None: mesh)
    got = run()
    assert got["x"].shape == want["x"].shape
    assert got["warm_state"]["num_chains"] == 6
    np.testing.assert_allclose(got["x"], want["x"], rtol=0, atol=1e-3)


def test_sharded_target_equals_the_chunked_target(gps):
    """The ensemble over the mesh equals, bit for bit, the ensemble whose
    target is evaluated in the mesh's chunks one after another on one
    device: the split, the threads and the gather change nothing."""
    from bobe_tpu_torch.infer.ehmc import run_ensemble

    _, tg = gps
    make_vg, ctx = tsamp._logprob_target(tg, 1.0)
    vg = make_vg(ctx)

    def chunked(z):
        parts = [vg(c) for c in torch.tensor_split(z, 3)]
        return tuple(torch.cat([p[i] for p in parts]) for i in range(2))

    z0 = torch.as_tensor(np.random.default_rng(0).normal(size=(6, 3)))
    kw = dict(num_warmup=24, num_samples=8, thinning=2)
    want = run_ensemble(chunked, z0, torch.Generator().manual_seed(2), **kw)
    got = run_ensemble(
        tmesh.sharded_target(make_vg, ctx, tmesh.get_mesh(["cpu"] * 3)),
        z0, torch.Generator().manual_seed(2), **kw)
    np.testing.assert_array_equal(_np(got[0]), _np(want[0]))
    np.testing.assert_array_equal(_np(got[1]), _np(want[1]))
