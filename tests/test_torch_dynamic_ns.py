"""The port's dynamic nested sampling (bobe_tpu_torch.infer.nested
``run_nested_dynamic``, ``_decorrelate``, ``_batch_seed_probs``) against the
JAX package's, on the CPU.

* ``_batch_seed_probs`` is deterministic and exact.
* ``_decorrelate`` leaves every point above its bound, with its true
  likelihood, and no two points equal.
* The analytic cases of tests/test_dynamic_ns.py, ported: at a lower
  surrogate-call budget a dynamic run is as well calibrated as a static
  run of twice the live points and gives more posterior effective samples
  per call; over a gated plateau the restricted-support ledger carries
  through the base run, the batch and the merge; a batch with a bound
  merges as dynesty's combine says.
* On the same classifier-gated GP state, ``nested_sampling(dynamic=True)``
  of both packages gives logZ within 3 * sqrt(s_jax^2 + s_port^2) + 0.02
  (s the reported ``dlogz_sampler``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import logsumexp
from scipy.stats import norm

import bobe_tpu  # noqa: F401  (float64 in JAX)
from bobe_tpu import samplers as jsamp
from bobe_tpu.infer import nested as jnest
from bobe_tpu.models import clf_gp as jcgp
from bobe_tpu.utils import seed as jseed
from bobe_tpu_torch import samplers as tsamp
from bobe_tpu_torch.infer import integrals
from bobe_tpu_torch.infer import nested as tnest
from bobe_tpu_torch.models import gp as tgp
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


def _gaussian(d, sigma, center=0.5):
    def apply(ctx, x):
        return (-0.5 * torch.sum(((x - center) / sigma) ** 2, dim=-1)
                - 0.5 * d * np.log(2 * np.pi * sigma**2))
    truth = float(d * np.log(norm.cdf((1 - center) / sigma)
                             - norm.cdf(-center / sigma)))
    return apply, truth


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _logz(res):
    return float(logsumexp(integrals.logwt_from(res.dead_logl, res.logvol,
                                                lv_start=res.logvol0)))


def test_batch_seed_probs_match_jax_and_start_at_the_crossing():
    rng = np.random.default_rng(0)
    for logvol0 in (0.0, -0.7):
        logvol = logvol0 - np.cumsum(rng.uniform(0.001, 0.02, size=800))
        for above in (np.arange(800) >= 500, np.ones(800, bool)):
            np.testing.assert_array_equal(
                tnest._batch_seed_probs(logvol, above, logvol0),
                jnest._batch_seed_probs(logvol, above, logvol0))
    # tests/test_dynamic_ns.py's case: the boundary shell is ~1/nlive of
    # the local volume, shells shrink, weights normalise
    logvol = -np.arange(1, 1001) / 100
    p = tnest._batch_seed_probs(logvol, np.arange(1000) >= 700, 0.0)
    assert p.shape == (300,) and p[0] < 0.05
    assert np.all(np.diff(p) < 0) and np.isclose(p.sum(), 1.0)


def test_decorrelate_keeps_points_above_lstar_and_no_copies():
    apply, _ = _gaussian(3, 0.1)
    rng = np.random.default_rng(1)
    base = 0.5 + 0.05 * rng.normal(size=(10, 3))
    x0 = torch.as_tensor(np.repeat(base, 20, axis=0))  # 20 copies each
    l0 = apply(None, x0)
    lstar = torch.tensor(float(l0.min()) - 1.0, dtype=torch.float64)
    x, l, nev, it = tnest._decorrelate(lambda x: apply(None, x), _gen(2), x0,
                                       l0, lstar, n_repeats=5, max_shrink=40,
                                       spec=1)
    assert bool(torch.all(l > lstar))
    np.testing.assert_allclose(l.numpy(), apply(None, x).numpy(), rtol=1e-12)
    assert np.unique(x.numpy(), axis=0).shape[0] == x.shape[0]
    assert bool(torch.all(torch.any(x != x0, dim=1)))
    assert int(nev) >= 5 * x.shape[0] and it >= 5
    assert bool(torch.all((x >= 0) & (x <= 1)))


def test_dynamic_beats_static_at_equal_budget():
    """tests/test_dynamic_ns.py's contract on the port: a dynamic run
    (nlive base + an equal batch) against a static run at twice nlive, on a
    sharp Gaussian (sigma 2 % of the box, d=4): fewer surrogate calls,
    equally calibrated evidence, more posterior effective samples per
    call."""
    d, s = 4, 0.02
    apply, truth = _gaussian(d, s)

    def stats(res):
        lw = integrals.logwt_from(res.dead_logl, res.logvol)
        w = np.exp(lw - logsumexp(lw))
        return float(logsumexp(lw)), float(1.0 / np.sum(w**2))

    errs, effs, calls = {"dyn": [], "sta": []}, {"dyn": [], "sta": []}, \
        {"dyn": [], "sta": []}
    for seed in range(3):
        runs = {
            "dyn": tnest.run_nested_dynamic(apply, None, d, _gen(seed),
                                            nlive=250, dlogz=0.05,
                                            rng=np.random.default_rng(seed)),
            "sta": tnest.run_nested(apply, None, d, _gen(seed + 100),
                                    nlive=500, dlogz=0.05,
                                    rng=np.random.default_rng(seed))}
        for k, r in runs.items():
            assert r.success
            lz, ess = stats(r)
            errs[k].append(abs(lz - truth))
            effs[k].append(ess / r.n_calls)
            calls[k].append(r.n_calls)
    assert np.mean(calls["dyn"]) < np.mean(calls["sta"]), calls
    assert np.mean(errs["dyn"]) < np.mean(errs["sta"]) + 0.1, errs
    assert np.mean(errs["dyn"]) < 0.25, errs
    assert np.mean(effs["dyn"]) > np.mean(effs["sta"]), effs


def test_dynamic_ns_with_plateau_ledger():
    """tests/test_dynamic_ns.py's gated case: a Gaussian inside
    {x0 >= 0.6} (the boundary at 1.5 sigma), a minus_inf plateau over the
    rest; rejection-seeded feasible live points with the ledger at the log
    feasible fraction carry through the base run, the batch and the
    merge."""
    d, sigma, c0, cut, minus_inf = 2, 0.1, 0.75, 0.6, -1e10
    center = torch.tensor([c0, 0.5], dtype=torch.float64)

    def apply(ctx, x):
        ll = (-0.5 * torch.sum(((x - center) / sigma) ** 2, dim=-1)
              - 0.5 * d * np.log(2 * np.pi * sigma**2))
        return torch.where(x[:, 0] >= cut, ll, torch.full_like(ll, minus_inf))

    m0 = norm.cdf((1.0 - c0) / sigma) - norm.cdf((cut - c0) / sigma)
    mb = norm.cdf(0.5 / sigma) - norm.cdf(-0.5 / sigma)
    lz_true = float(np.log(m0) + np.log(mb))
    rng = np.random.default_rng(5)
    pool = rng.uniform(size=(20000, d))
    logl = apply(None, torch.as_tensor(pool)).numpy()
    ok = logl > minus_inf
    idx = rng.choice(np.sum(ok), size=250, replace=False)
    res = tnest.run_nested_dynamic(apply, None, d, _gen(12), nlive=250,
                                   dlogz=0.01, live_x=pool[ok][idx],
                                   live_logl=logl[ok][idx], rng=rng,
                                   logvol0=float(np.log(ok.mean())))
    assert res.success and res.logvol0 == pytest.approx(np.log(ok.mean()))
    assert abs(_logz(res) - lz_true) < 0.2, (_logz(res), lz_true)
    assert np.all(res.dead_logl > minus_inf)


def test_merge_batch_with_bound_hand_computed():
    """A refinement batch with a finite bound adds live points only at
    deaths at or above it (tests/test_dynamic_ns.py's hand computation)."""
    base = (np.zeros((3, 1)), np.array([1.0, 3.0, 5.0]),
            np.array([2.0, 2.0, 2.0]), -np.inf)
    batch = (np.ones((2, 1)), np.array([4.0, 6.0]), np.array([2.0, 2.0]), 3.0)
    _, logls, logvol, sched = tnest.merge_runs([base, batch])
    np.testing.assert_array_equal(logls, [1.0, 3.0, 4.0, 5.0, 6.0])
    np.testing.assert_array_equal(sched, [2.0, 4.0, 4.0, 4.0, 2.0])
    np.testing.assert_allclose(
        logvol, np.cumsum([np.log(2 / 3)] + [np.log(4 / 5)] * 3
                          + [np.log(2 / 3)]), rtol=1e-12)


def test_dynamic_ns_on_a_gated_jax_state_agrees_with_jax():
    """The JAX package's SVM-gated GP carried across; a convergence-mode
    dynamic NS in each package (200 live points): logZ within
    3 * sqrt(s_jax^2 + s_port^2) + 0.02, both ledgers starting at the log
    feasible fraction."""
    rng = np.random.default_rng(11)
    x = rng.uniform(size=(60, 2))
    y = -30.0 * np.sum((x - np.array([0.45, 0.5])) ** 2, axis=1)
    y = np.where(x[:, 0] > 0.7, -1e10, y)
    jseed.set_global_seed(2)
    jg = jcgp.GPwithClassifier(
        train_x=x, train_y=y, clf_type="svm", noise=1e-6,
        lengthscales=np.array([0.35, 0.4]), kernel_variance=2.0,
        clf_use_size=10, minus_inf=-1e10, clf_threshold=100.0,
        gp_threshold=200.0)
    tg = tgp.state_from_numpy(jg.state_dict(), device="cpu")
    _, jz, jok = jsamp.nested_sampling(jg, mode="convergence", nlive=200,
                                       dynamic=True,
                                       rng=np.random.default_rng(3))
    ts, tz, tok = tsamp.nested_sampling(tg, mode="convergence", nlive=200,
                                        dynamic=True,
                                        rng=np.random.default_rng(4),
                                        generator=_gen(4))
    assert jok and tok
    tol = 3.0 * np.hypot(jz["dlogz_sampler"], tz["dlogz_sampler"]) + 0.02
    assert abs(tz["mean"] - jz["mean"]) < tol, (tz, jz)
    assert tz["lower"] <= tz["mean"] <= tz["upper"]
    assert np.all(ts["logl"] > -1e10)
    np.testing.assert_allclose(ts["weights"].sum(), 1.0, rtol=1e-9)
    # the gated GP mean at the samples
    np.testing.assert_allclose(
        ts["logl"], tg.predict_mean_batched(ts["x"]).numpy(), rtol=1e-9)
    assert np.isfinite(float(jnp.asarray(jz["mean"])))
