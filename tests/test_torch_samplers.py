"""Parity of the port's nested sampling (bobe_tpu_torch.infer, samplers) with
the JAX package's, on the CPU.

The deterministic parts (evidence quadrature, run merging, slice-sampling
geometry, settings, live seeding) are compared on identical inputs at rtol
1e-9. The sampler itself draws from torch generators where JAX draws from
its own keys, so a run is compared statistically: a GP state fitted by the
JAX package is carried across, both packages run convergence-mode NS on it,
and the two logZ agree within 3 combined sampler errors (``dlogz_sampler``).

Over a classifier-gated GP (a JAX ``GPwithClassifier`` state carried across,
fixed hyperparameters, noise 1e-6): the gated HMC target and its gradient
against ``jax.grad`` of the JAX package's gated target at rtol 1e-9 on
feasible and infeasible points, the gated live seeding (same numpy seed:
the same feasible fraction and live set), one gated EHMC transition fed the
JAX package's own draws at rtol 1e-9, and the warm-path plateau guard.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bobe_tpu  # noqa: F401  (float64 in JAX)
from bobe_tpu import samplers as jsamp
from bobe_tpu.infer import ehmc as jehmc
from bobe_tpu.infer import integrals as jint
from bobe_tpu.infer import nested as jnest
from bobe_tpu.infer import nuts as jnuts
from bobe_tpu.models import clf_gp as jcgp
from bobe_tpu.models import gp as jgp
from bobe_tpu.utils import seed as jseed
from bobe_tpu_torch import samplers as tsamp
from bobe_tpu_torch.infer import ehmc as tehmc
from bobe_tpu_torch.infer import integrals as tint
from bobe_tpu_torch.infer import nested as tnest
from bobe_tpu_torch.infer import nuts as tnuts
from bobe_tpu_torch.models import gp as tgp
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
def jax_gaussian_gp():
    """The JAX package's GP fitted to a 2-d Gaussian log-density
    (sigma 0.15), as tests/test_samplers.py builds it."""
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(120, 2))
    y = -0.5 * np.sum(((x - 0.5) / 0.15) ** 2, axis=1)
    gp = jgp.GP(train_x=jnp.asarray(x), train_y=jnp.asarray(y), noise=1e-8)
    gp.fit(n_restarts=4, maxiter=200)
    return gp


def _dead_points(n=400, seed=0):
    rng = np.random.default_rng(seed)
    logvol = -np.cumsum(rng.uniform(0.001, 0.02, size=n))
    logl = np.sort(rng.normal(size=n)) * 3.0
    sigma = rng.uniform(0.0, 0.1, size=n)
    return logl, logvol, sigma


def test_evidence_quadrature_matches_jax():
    logl, logvol, sigma = _dead_points()
    for sq in (False, True):
        np.testing.assert_allclose(
            tint.trapezoid_logz(logl, logvol, squared=sq, lv_start=-0.1),
            jint.trapezoid_logz(logl, logvol, squared=sq, lv_start=-0.1),
            rtol=RTOL)
    want = jint.logz_bounds_from_gp_sigma(logl, logvol, sigma)
    got = tint.logz_bounds_from_gp_sigma(logl, logvol, sigma)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL)
    np.testing.assert_allclose(
        tint.information_and_err(logl, logvol, want["mean"], 50),
        jint.information_and_err(logl, logvol, want["mean"], 50), rtol=RTOL)


def test_merge_runs_matches_jax():
    rng = np.random.default_rng(1)
    runs = []
    for i, bound in enumerate((-np.inf, -np.inf, 0.5)):
        n = 200 + 30 * i
        logl = np.sort(rng.normal(size=n))
        sched = np.concatenate([np.tile(50 - np.arange(5), (n - 50) // 5),
                                50 - np.arange(50)]).astype(float)
        runs.append((rng.uniform(size=(n, 2)), logl, sched[:n], bound))
    want = jnest.merge_runs(runs, logvol0=-0.2)
    got = tnest.merge_runs(runs, logvol0=-0.2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL)


def test_slice_geometry_and_settings_match_jax():
    rng = np.random.default_rng(2)
    x, e = rng.uniform(size=(16, 3)), rng.normal(size=(16, 3))
    jlo, jhi = jax.vmap(jnest._chord_bounds)(jnp.asarray(x), jnp.asarray(e))
    tlo, thi = tnest._chord_bounds(torch.as_tensor(x), torch.as_tensor(e))
    np.testing.assert_allclose(tlo.numpy(), np.asarray(jlo), rtol=RTOL)
    np.testing.assert_allclose(thi.numpy(), np.asarray(jhi), rtol=RTOL)
    u = rng.uniform(size=(4, 16))
    want = jnest._spec_candidates(jnp.asarray(u), jlo, jhi, 4)
    got = tnest._spec_candidates(torch.as_tensor(u), tlo, thi, 4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL)
    for mode in ("acq", "convergence"):
        for d in (2, 8, 30):
            assert tsamp.ns_settings(mode, d) == jsamp.ns_settings(mode, d)
    for d in (2, 12):
        assert tnest._resolve_spec(None, d) == jnest._resolve_spec(None, d)


def _frozen_slice_lanes(loglike_fn, gen, x_cur, l_cur, lstar, n_repeats,
                        max_shrink, spec, draw_dirs, max_iter=None):
    """The slice loop of infer/nested.py as it was before its body became
    the in-place ``_slice_step``: out of place, the lanes' activity read
    at the top of each iteration. Kept as the oracle of the rewrite;
    ``max_iter`` stops it early. Returns its whole state."""
    n, d = x_cur.shape
    dev, dt = x_cur.device, x_cur.dtype
    e = draw_dirs(x_cur)
    lo, hi = tnest._chord_bounds(x_cur, e)
    rep = torch.zeros(n, dtype=torch.int64, device=dev)
    shrink = torch.zeros(n, dtype=torch.int64, device=dev)
    nev = torch.zeros((), dtype=torch.int64, device=dev)
    lanes = torch.arange(n, device=dev)
    steps = torch.arange(spec, device=dev)
    it = 0
    limit = n_repeats * max_shrink if max_iter is None else max_iter
    while it < limit:
        active = rep < n_repeats
        if not bool(active.any()):
            break
        u = torch.rand((spec, n), generator=gen, dtype=dt, device=dev)
        ts, lo_end, hi_end = tnest._spec_candidates(u, lo, hi, spec)
        x_try = torch.clamp(x_cur[:, None, :] + ts[..., None] * e[:, None, :],
                            0.0, 1.0).reshape(n * spec, d)
        l_try = loglike_fn(x_try).reshape(n, spec)
        reachable = shrink[:, None] + steps[None, :] < max_shrink
        acc = (l_try > lstar) & reachable
        any_acc = torch.any(acc, dim=1)
        first = torch.argmax(acc.to(torch.int8), dim=1)
        ok = any_acc & active
        n_reach = torch.clamp(max_shrink - shrink, 0, spec)
        used = torch.where(any_acc, first + 1, n_reach)
        nev = nev + torch.sum(torch.where(active, used, torch.zeros_like(used)))
        x_acc = x_try.reshape(n, spec, d)[lanes, first]
        l_acc = l_try[lanes, first]
        x_cur = torch.where(ok[:, None], x_acc, x_cur)
        l_cur = torch.where(ok, l_acc, l_cur)
        nok = active & ~any_acc
        lo = torch.where(nok, lo_end, lo)
        hi = torch.where(nok, hi_end, hi)
        shrink = torch.where(nok, shrink + n_reach, shrink)
        complete = ok | (nok & (shrink >= max_shrink))
        rep = rep + complete.to(rep.dtype)
        e_new = draw_dirs(x_cur)
        lo_new, hi_new = tnest._chord_bounds(x_cur, e_new)
        e = torch.where(complete[:, None], e_new, e)
        lo = torch.where(complete, lo_new, lo)
        hi = torch.where(complete, hi_new, hi)
        shrink = torch.where(complete, torch.zeros_like(shrink), shrink)
        it += 1
    return {"x": x_cur, "l": l_cur, "e": e, "lo": lo, "hi": hi, "rep": rep,
            "shrink": shrink, "nev": nev, "it": it}


def _bump(x):
    """A narrow Gaussian bump: most slice candidates fall below a high
    threshold, so brackets shrink and some lanes spend their budget."""
    return -0.5 * torch.sum(((x - 0.5) / 0.08) ** 2, dim=-1)


def _slice_case(seed, n=24, d=3):
    rng = np.random.default_rng(seed)
    x0 = torch.as_tensor(0.5 + rng.uniform(-0.05, 0.05, size=(n, d)))
    chol = torch.linalg.cholesky(torch.as_tensor(
        np.diag(rng.uniform(0.02, 0.2, size=d))))

    def draw_dirs_of(gen):
        return lambda x: torch.randn((n, d), generator=gen,
                                     dtype=x.dtype) @ chol.T

    lstar = torch.min(_bump(x0)) - 0.5
    return x0, _bump(x0), lstar, draw_dirs_of


@pytest.mark.parametrize("spec", [1, 4])
def test_slice_step_matches_the_frozen_loop(spec):
    """The in-place step body (``_slice_step`` on ``_Lanes``) against the
    frozen out-of-place loop on the CPU, to the bit: after one iteration,
    after a few (brackets shrunk, some lanes on their next update), and to
    the end (``_slice_lanes``, some lanes out of shrink budget), with the
    generator left in the same state."""
    x0, l0, lstar, draw_dirs_of = _slice_case(21 + spec)
    n, d = x0.shape
    n_repeats, max_shrink = 3, 6
    for k in (1, 4, None):
        g_old = torch.Generator().manual_seed(5)
        g_new = torch.Generator().manual_seed(5)
        want = _frozen_slice_lanes(_bump, g_old, x0, l0, lstar, n_repeats,
                                   max_shrink, spec, draw_dirs_of(g_old),
                                   max_iter=k)
        if k is None:
            x, l, nev, it = tnest._slice_lanes(
                _bump, g_new, x0, l0, lstar, n_repeats, max_shrink, spec,
                draw_dirs_of(g_new))
            got = {"x": x, "l": l, "nev": nev, "it": it}
            # rejections happened: more calls than one per update
            assert int(nev) > n * n_repeats
        else:
            s = tnest._Lanes(n, d, spec, x0.dtype, x0.device)
            s.load(x0, l0, lstar, n_repeats, draw_dirs_of(g_new))
            for _ in range(k):
                tnest._slice_step(s, _bump, g_new, n_repeats, max_shrink,
                                  spec, draw_dirs_of(g_new))
            got = {key: getattr(s, key) for key in
                   ("x", "l", "e", "lo", "hi", "rep", "shrink", "nev")}
            got["it"] = k
            assert bool(s.any_active) == bool((want["rep"] < n_repeats).any())
            assert torch.equal(s.active, want["rep"] < n_repeats)
            if k > 1:
                assert bool((want["shrink"] > 0).any())
        for key, value in got.items():
            if key == "it":
                assert value == want[key]
            else:
                assert torch.equal(value, want[key]), (k, key)
        assert torch.equal(g_new.get_state(), g_old.get_state())


class _StaleStepGraph(tnest._SliceGraph):
    """The graph holder with the card's graph stood in for on the CPU:
    after the warm-up every call runs the step it kept at its capture, the
    first outer step's, as a replay runs the kernels captured then."""

    def run(self, step):
        if self.graph is None and self.warm < self.WARMUP:
            step()
            self.warm += 1
            return False
        if self.graph is None:
            self.graph = step
            self.captures += 1
        self.graph()
        return True

    def close(self):
        self.graph = None


def test_replace_batch_on_the_run_buffers_matches_eager():
    """Outer steps on one run's buffers (``_replace_batch(graph=...)``):
    each step's live set, survivors and threshold are loaded into the
    buffers the kept step reads, and the replacements, calls and
    iterations equal the eager path's bit for bit, step after step."""
    rng = np.random.default_rng(31)
    nlive, K, d = 40, 6, 3
    live_x = torch.as_tensor(0.5 + rng.uniform(-0.06, 0.06, size=(nlive, d)))
    live_l = _bump(live_x)
    g_eager = torch.Generator().manual_seed(9)
    g_graph = torch.Generator().manual_seed(9)
    holder = _StaleStepGraph(g_graph)
    n_inner = 0
    for _ in range(4):
        order = torch.argsort(live_l, stable=True)
        lstar = live_l[order[K - 1]]
        want = tnest._replace_batch(_bump, g_eager, live_x, live_l, order[K:],
                                    lstar, K, 3, 8, 2)
        got = tnest._replace_batch(_bump, g_graph, live_x, live_l, order[K:],
                                   lstar, K, 3, 8, 2, graph=holder)
        for a, b in zip(got[:3], want[:3]):
            assert torch.equal(a, b)
        assert got[3] == want[3]
        n_inner += got[3]
        live_x = live_x.index_copy(0, order[:K], got[0])
        live_l = live_l.index_copy(0, order[:K], got[1])
    assert torch.equal(g_graph.get_state(), g_eager.get_state())
    assert holder.captures == 1 and holder.warm == holder.WARMUP
    assert n_inner > holder.WARMUP


def test_seed_live_points_match_jax(jax_gaussian_gp):
    """Same numpy draws, same surrogate: the same live set; a plain GP has
    no infeasible plateau, so the ledger starts at log 1 = 0. The GP-mean
    values agree to rtol 1e-6: at noise 1e-8 the Gram's condition number is
    ~1e10, and alpha = K^-1 y from the two packages' Cholesky factors agrees
    to ~cond * eps."""
    jg = jax_gaussian_gp
    tg = tgp.state_from_numpy(jg.state_dict(), device="cpu")
    japply, jctx = jsamp._gp_loglike(jg)
    tapply, tctx = tsamp._gp_loglike(tg)
    jl = jsamp._seed_live_points(jg, lambda x: japply(jctx, x), 64, 2,
                                 np.random.default_rng(3))
    tl = tsamp._seed_live_points(tg, lambda x: tapply(tctx, x), 64, 2,
                                 np.random.default_rng(3))
    np.testing.assert_array_equal(tl[0], jl[0])
    np.testing.assert_allclose(tl[1], jl[1], rtol=1e-6)
    assert tl[2:] == pytest.approx(jl[2:]) and tl[2] == 0.0


def test_convergence_ns_on_a_jax_state_agrees_with_jax(jax_gaussian_gp):
    jg = jax_gaussian_gp
    tg = tgp.state_from_numpy(jg.state_dict(), device="cpu")
    _, jz, jok = jsamp.nested_sampling(jg, mode="convergence",
                                       rng=np.random.default_rng(4))
    samples, tz, tok = tsamp.nested_sampling(
        tg, mode="convergence", rng=np.random.default_rng(5),
        generator=torch.Generator().manual_seed(5))
    assert jok and tok
    for k in ("mean", "upper", "lower", "var", "std", "dlogz_sampler", "h",
              "dlogz_hyp", "err_total"):
        assert np.isfinite(tz[k]), k
    assert tz["lower"] <= tz["mean"] <= tz["upper"]
    s = np.hypot(jz["dlogz_sampler"], tz["dlogz_sampler"])
    assert abs(tz["mean"] - jz["mean"]) < 3.0 * s, (tz["mean"], jz["mean"], s)
    # both near the analytic value log(2 pi 0.15^2)
    assert abs(tz["mean"] - np.log(2 * np.pi * 0.15**2)) < 0.3
    assert samples["n_iter"] > 0 and samples["n_inner"] >= samples["n_iter"]
    assert samples["x"].shape[1] == 2
    np.testing.assert_allclose(samples["weights"].sum(), 1.0, rtol=1e-9)


def test_repeated_runs_merge_and_tighten_the_sampler_error(jax_gaussian_gp):
    tg = tgp.state_from_numpy(jax_gaussian_gp.state_dict(), device="cpu")
    one, z1, ok1 = tsamp.nested_sampling(tg, mode="convergence", nlive=100,
                                         rng=np.random.default_rng(6))
    _, z3, ok3 = tsamp.nested_sampling(tg, mode="convergence", nlive=100,
                                       n_runs=2, merge_with=[one["raw"]],
                                       rng=np.random.default_rng(7))
    assert ok1 and ok3
    assert z3["dlogz_sampler"] < z1["dlogz_sampler"]
    # dynamic=True is ported: a base run plus a posterior-bulk batch
    dyn, zd, okd = tsamp.nested_sampling(tg, mode="convergence", nlive=100,
                                         dynamic=True,
                                         rng=np.random.default_rng(8))
    assert okd and np.isfinite(zd["mean"]) and dyn["n_iter"] > 0
    assert abs(zd["mean"] - np.log(2 * np.pi * 0.15**2)) < 0.3


# ------------------------------------------------------- gated surrogates

GATED_MINUS_INF = -1e5


@pytest.fixture(scope="module")
def gated_gps():
    """The JAX package's SVM-gated GP (a bump with a failure region at
    x0 > 0.7, fixed hyperparameters, noise 1e-6) and the port's from its
    state dict."""
    rng = np.random.default_rng(11)
    x = rng.uniform(size=(60, 2))
    y = -30.0 * np.sum((x - np.array([0.45, 0.5])) ** 2, axis=1)
    y = np.where(x[:, 0] > 0.7, GATED_MINUS_INF, y)
    jseed.set_global_seed(2)
    jg = jcgp.GPwithClassifier(
        train_x=x, train_y=y, clf_type="svm", noise=1e-6,
        lengthscales=np.array([0.35, 0.4]), kernel_variance=2.0,
        clf_use_size=10, minus_inf=GATED_MINUS_INF, clf_threshold=100.0,
        gp_threshold=200.0)
    assert jg._clf_ctx is not None
    return jg, tgp.state_from_numpy(jg.state_dict(), device="cpu")


def _jax_gated_vg(jg, temp):
    apply = jsamp._nuts_logprob_apply(jg.cfg, True,
                                      float(jg.probability_threshold),
                                      float(jg.minus_inf), jg.clf_type,
                                      float(temp))
    ctx = (jg.state, jg._clf_ctx)
    return jax.vmap(jax.value_and_grad(lambda z: apply(ctx, z))), apply, ctx


def _gated_z(seed, n=64):
    """Logits of points over the whole box (both sides of the gate), a
    quarter of them near saturation."""
    rng = np.random.default_rng(seed)
    u = np.clip(rng.uniform(size=(n, 2)), 1e-3, 1 - 1e-3)
    z = np.log(u) - np.log1p(-u)
    z[: n // 4] = rng.choice([-1.0, 1.0], size=(n // 4, 2)) * rng.uniform(
        20.0, 35.0, size=(n // 4, 2))
    return z


@pytest.mark.parametrize("temp", [1.0, 2.5])
def test_gated_target_value_and_grad_match_jax(gated_gps, temp):
    """The gated tempered target and its closed-form gradient against
    ``jax.grad`` through the JAX package's hard gate: on the plateau the
    value is minus_inf / temp plus the Jacobian and only the Jacobian's
    gradient remains. rtol 1e-9 plus 1e-9 of the largest gradient
    component (tests/test_torch_ehmc.py states why)."""
    jg, tg = gated_gps
    z = _gated_z(3)
    jvg, _, _ = _jax_gated_vg(jg, temp)
    jl, jgr = jvg(jnp.asarray(z))
    tl, tgr = tsamp._logprob_vg(tg, temp)(torch.as_tensor(z))
    jl, jgr = np.asarray(jl), np.asarray(jgr)
    infeasible = jl < 0.5 * GATED_MINUS_INF / temp
    assert 0 < infeasible.sum() < len(z)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=RTOL)
    np.testing.assert_allclose(tgr.numpy(), jgr, rtol=RTOL,
                               atol=1e-9 * np.abs(jgr).max())
    # the plateau's gradient is the Jacobian's alone: sigmoid(-z) - sigmoid(z)
    x = 1.0 / (1.0 + np.exp(-z[infeasible]))
    np.testing.assert_allclose(tgr.numpy()[infeasible], 1.0 - 2.0 * x,
                               rtol=RTOL, atol=1e-15)


def test_gated_seed_live_points_match_jax(gated_gps):
    """Same numpy seed, same gate: the same feasible fraction (the ledger
    start log f_hat and its variance) and the same live set, strictly above
    the plateau."""
    jg, tg = gated_gps
    japply, jctx = jsamp._gp_loglike(jg)
    tapply, tctx = tsamp._gp_loglike(tg)
    jl = jsamp._seed_live_points(jg, lambda x: japply(jctx, x), 100, 2,
                                 np.random.default_rng(4))
    tl = tsamp._seed_live_points(tg, lambda x: tapply(tctx, x), 100, 2,
                                 np.random.default_rng(4))
    np.testing.assert_array_equal(tl[0], jl[0])
    np.testing.assert_allclose(tl[1], jl[1], rtol=RTOL)
    assert tl[2] == jl[2] and tl[3] == jl[3]
    assert -1.0 < tl[2] < -0.05 and np.all(tl[1] > GATED_MINUS_INF)


def test_gated_ensemble_transition_with_jax_draws_matches_jax(gated_gps):
    """One 6-leapfrog gated EHMC transition of 16 chains, some starting on
    the plateau, fed the JAX package's momentum normals and accept
    uniforms: the same chains move, to the same states."""
    jg, tg = gated_gps
    d, C = 2, 16
    z0 = _gated_z(5, n=C) * 0.5
    jvg, _, _ = _jax_gated_vg(jg, 1.0)
    tvg = tsamp._logprob_vg(tg, 1.0)
    jmass = jnuts.MassMatrix(jnp.eye(d), jnp.eye(d))
    tmass = tnuts.MassMatrix(torch.eye(d, dtype=torch.float64),
                             torch.eye(d, dtype=torch.float64))
    key = jax.random.PRNGKey(9)
    jl, jgr = jvg(jnp.asarray(z0))
    assert np.any(np.asarray(jl) < 0.5 * GATED_MINUS_INF)
    jout = jehmc._ensemble_transition(jvg, key, jnp.asarray(z0), jl, jgr,
                                      0.3, 6, jmass, True)
    k_mom, k_acc = jax.random.split(key)
    noise = jax.vmap(lambda k: jax.random.normal(k, (d,), dtype=jnp.float64))(
        jax.random.split(k_mom, C))
    u = jax.random.uniform(k_acc, (C,), dtype=jnp.float64)
    Z = torch.as_tensor(z0)
    L, G = tvg(Z)
    tout = tehmc._ensemble_transition(
        tvg, torch.as_tensor(np.asarray(noise)),
        torch.log(torch.as_tensor(np.asarray(u))), Z, L, G,
        torch.tensor(0.3, dtype=torch.float64), 6, tmass, True)
    for g, w in zip(tout, jout):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=1e-12)
    assert np.any(np.any(tout[0].numpy() != z0, axis=1))


def test_gated_warm_path_plateau_guard_matches_jax(gated_gps):
    """The fraction of cached chain ends still feasible equals the JAX
    package's; an ensemble warm state mostly on the plateau is rejected
    for a cold start, and the pool's logp is the gated mean."""
    jg, tg = gated_gps
    nc = 64
    rng = np.random.default_rng(6)
    u = np.column_stack([rng.uniform(0.75, 0.99, nc), rng.uniform(size=nc)])
    u[:8, 0] = 0.45
    last_z = np.log(u) - np.log1p(-u)
    ws = {"last_z": last_z, "step_size": 0.3, "mass_inv": np.eye(2),
          "mass_chol": np.eye(2), "kind": "ehmc", "num_chains": nc,
          "ndim": 2, "dense_mass": True, "temp": 1.0}
    _, apply, ctx = _jax_gated_vg(jg, 1.0)
    want = jsamp._plateau_frac_ok(apply, ctx, ws, jg, 1.0)
    got = tsamp._plateau_frac_ok(tsamp._logprob_vg(tg, 1.0), ws, tg, 1.0)
    assert got == want and got < 0.9
    out = tsamp.sample_gp_ensemble(tg, np_rng=np.random.default_rng(7),
                                   generator=torch.Generator().manual_seed(7),
                                   num_samples=256, warm_state=ws)
    assert not out["diagnostics"]["warm"]
    np.testing.assert_allclose(out["logp"],
                               tg.predict_mean_batched(out["x"]).numpy(),
                               rtol=RTOL)
    # the pool lives in the feasible region
    assert np.mean(out["logp"] > GATED_MINUS_INF) > 0.95
