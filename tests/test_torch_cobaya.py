"""The port's Cobaya path against the JAX package's, on a stand-in ``cobaya``
package written to a temporary directory (neither cobaya nor its theory codes
are installed): the adapter (names, labels, bounds, log prior volume, values,
both ``get_valid_point`` surfaces and the dict hybrid, the recorded LCDM-lite
schema, the YAML path), the adapter pickled with plain pickle and evaluated
in forkserver workers, the pools' reference draws, ``BOBE``'s initial design
and an end-to-end run to convergence.

The stand-in is a package on ``sys.path`` rather than modules injected into
``sys.modules`` because pool workers import it when they rebuild the model.
Its model is made from a seed with numpy.
"""
import json
import os
import pickle
import sys
import textwrap

import numpy as np
import pytest
import torch

from bobe_tpu.bo import BOBE as JaxBOBE
from bobe_tpu.likelihood import CobayaLikelihood as JaxCobaya
from bobe_tpu.parallel import pool as jpool
from bobe_tpu_torch.bo import BOBE
from bobe_tpu_torch.likelihood import CobayaLikelihood
from bobe_tpu_torch.parallel import pool as tpool

RTOL = 1e-12
HERE = os.path.dirname(os.path.abspath(__file__))
RECORDED = os.path.join(HERE, "data", "cobaya_lcdm_lite_surface.json")

_FAKE_MODEL = textwrap.dedent('''
    """Stand-in cobaya.model: a seeded Gaussian model, or the recorded
    LCDM-lite surface, with the get_valid_point surface of cobaya 3.2+
    ('3.2'), of earlier releases ('pre3.2', a LogPosterior namedtuple) or of
    some 3.1.x releases ('hybrid', a dict without the keyword)."""
    import collections
    import json

    import numpy as np

    LogPosterior = collections.namedtuple(
        "LogPosterior", ["logpost", "logpriors", "loglikes"])


    class _Parameterization:
        def __init__(self, names, labels):
            self._names, self._labels = names, labels

        def sampled_params(self):
            return {k: None for k in self._names}

        def labels(self):
            return dict(self._labels)


    class _Prior:
        def __init__(self, bounds):
            self._bounds = bounds

        def bounds(self, confidence_for_unbounded=1.0):
            return np.array(self._bounds)  # (d, 2), as cobaya returns them


    class Model:
        def __init__(self, info):
            spec = info["fake"]
            self.surface = spec.get("surface", "3.2")
            if "recorded" in spec:
                rec = json.load(open(spec["recorded"]))
                names, labels = rec["sampled_params"], rec["labels"]
                bounds = np.asarray(rec["bounds"], dtype=float)
            elif "bounds" in spec:
                bounds = np.asarray(spec["bounds"], dtype=float)
                names = [f"p{i}" for i in range(len(bounds))]
                labels = {n: n for n in names}
            else:
                d = int(spec["d"])
                rng = np.random.default_rng(spec["seed"])
                lo = rng.uniform(-2.0, 0.0, d)
                bounds = np.stack([lo, lo + rng.uniform(1.0, 3.0, d)], 1)
                names = [f"p{i}" for i in range(d)]
                labels = {n: f"\\\\theta_{i}" for i, n in enumerate(names)}
                labels["derived"] = "D"
            self.parameterization = _Parameterization(names, labels)
            self.prior = _Prior(bounds)
            width = bounds[:, 1] - bounds[:, 0]
            self.mu = bounds[:, 0] + width * spec.get("mu_frac", 0.5)
            self.sig = width * spec.get("sig_frac", 0.1)
            self.fail_above = spec.get("fail_above")

        def logpost(self, x, make_finite=False):
            x = np.asarray(x, dtype=float)
            if self.fail_above is not None and x[0] > self.fail_above:
                return -np.inf  # the theory code failed
            z = (x - self.mu) / self.sig
            return float(-0.5 * z @ z - np.sum(np.log(self.sig))
                         - 0.5 * len(x) * np.log(2 * np.pi))

        def get_valid_point(self, max_tries, ignore_fixed_ref, random_state,
                            **kw):
            if self.surface != "3.2" and kw:
                raise TypeError(f"unexpected keyword(s) {sorted(kw)}")
            lo, hi = self.prior._bounds[:, 0], self.prior._bounds[:, 1]
            pt = np.clip(self.mu + 2.0 * self.sig
                         * random_state.standard_normal(len(self.mu)), lo, hi)
            lp = self.logpost(pt)
            if self.surface == "pre3.2":
                return pt, LogPosterior(lp, None, None)
            return pt, {"logpost": lp}


    def get_model(info):
        return Model(info)
''')

_FAKE_YAML = textwrap.dedent('''
    """Stand-in cobaya.yaml."""
    import yaml


    def yaml_load(text):
        return yaml.safe_load(text)
''')


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture()
def fake_cobaya(tmp_path, monkeypatch):
    pkg = tmp_path / "fake_site" / "cobaya"
    pkg.mkdir(parents=True)
    (pkg / "__init__.py").write_text('"""Stand-in cobaya package."""\n')
    (pkg / "model.py").write_text(_FAKE_MODEL)
    (pkg / "yaml.py").write_text(_FAKE_YAML)
    drop = lambda: [sys.modules.pop(k) for k in list(sys.modules)
                    if k == "cobaya" or k.startswith("cobaya.")]
    drop()
    monkeypatch.syspath_prepend(str(pkg.parent))
    yield
    drop()


def _info(**spec):
    base = {"seed": 5, "d": 3}
    base.update(spec)
    return {"fake": base}


def _same_adapters(lk, jk, rng):
    assert lk.param_list == jk.param_list
    assert lk.param_labels == jk.param_labels
    np.testing.assert_array_equal(lk.param_bounds, np.asarray(jk.param_bounds))
    assert lk.param_bounds.shape == (2, lk.ndim)
    np.testing.assert_allclose(lk.logprior_vol, jk.logprior_vol, rtol=RTOL)
    lo, hi = lk.param_bounds
    for x in rng.uniform(lo, hi, size=(12, lk.ndim)):
        np.testing.assert_allclose(lk(x), jk(x), rtol=RTOL)


@pytest.mark.parametrize("surface", ["3.2", "pre3.2", "hybrid"])
def test_adapter_matches_the_jax_package(fake_cobaya, surface):
    info = _info(surface=surface, fail_above=0.0)
    lk = CobayaLikelihood(info, name="fake", minus_inf=-1e8)
    jk = JaxCobaya(info, name="fake", minus_inf=-1e8)
    _same_adapters(lk, jk, np.random.default_rng(0))
    # a failed evaluation floors at minus_inf before the volume shift
    x = lk.param_bounds[1] - 1e-6
    assert lk(x) == -1e8 + lk.logprior_vol == jk(x)
    for s in range(4):
        pt, lp = lk._get_single_valid_point(np.random.default_rng(s))
        jpt, jlp = jk._get_single_valid_point(np.random.default_rng(s))
        np.testing.assert_array_equal(pt, jpt)
        np.testing.assert_allclose(lp, jlp, rtol=RTOL)
        assert lp == lk(pt)


def test_recorded_lcdm_lite_schema(fake_cobaya):
    rec = json.load(open(RECORDED))
    info = {"fake": {"recorded": RECORDED}}
    lk = CobayaLikelihood(info, name="lcdm_lite")
    jk = JaxCobaya(info, name="lcdm_lite")
    assert lk.param_list == rec["sampled_params"] and lk.ndim == 6
    np.testing.assert_array_equal(lk.param_bounds.T, np.asarray(rec["bounds"]))
    assert lk.param_labels == [rec["labels"][k] for k in rec["sampled_params"]]
    widths = np.diff(np.asarray(rec["bounds"]), axis=1).ravel()
    np.testing.assert_allclose(lk.logprior_vol, np.sum(np.log(widths)),
                               rtol=RTOL)
    _same_adapters(lk, jk, np.random.default_rng(1))


def test_yaml_path_text_and_dict_agree(fake_cobaya, tmp_path):
    text = "fake:\n  seed: 9\n  d: 2\n"
    path = tmp_path / "model.yaml"
    path.write_text(text)
    by_dict = CobayaLikelihood({"fake": {"seed": 9, "d": 2}})
    rng = np.random.default_rng(2)
    for src in (str(path), text):
        _same_adapters(CobayaLikelihood(src), by_dict, rng)
        _same_adapters(CobayaLikelihood(src), JaxCobaya(src), rng)


def test_adapter_pickles_with_plain_pickle(fake_cobaya):
    lk = CobayaLikelihood(_info(surface="pre3.2"), confidence_for_unbounded=0.99,
                          minus_inf=-1e9, name="pickled")
    back = pickle.loads(pickle.dumps(lk))
    assert back.cobaya_model is not lk.cobaya_model  # rebuilt, not shipped
    assert (back.name, back.minus_inf) == ("pickled", -1e9)
    _same_adapters(back, lk, np.random.default_rng(3))
    assert back._get_single_valid_point(np.random.default_rng(4))[1] == \
        lk._get_single_valid_point(np.random.default_rng(4))[1]


def test_forkserver_workers_match_the_serial_pool_and_the_jax_draws(
        fake_cobaya, monkeypatch):
    """Through plain pickle (cloudpickle hidden), 2 forkserver workers
    evaluate the adapter as the serial pool does, and draw the reference
    points the JAX package's MultiprocessPool draws for the same rng."""
    info = _info(d=2)
    jk = JaxCobaya(info)
    jmp = jpool.MultiprocessPool(n_workers=2)
    try:
        want = jmp.get_cobaya_initial_points(jk, 6,
                                             rng=np.random.default_rng(8))
    finally:
        jmp.close()
    monkeypatch.setitem(sys.modules, "cloudpickle", None)
    lk = CobayaLikelihood(info)
    mp = tpool.MultiprocessPool(n_workers=2)
    try:
        got = mp.get_cobaya_initial_points(lk, 6, rng=np.random.default_rng(8))
        pts = np.random.default_rng(5).uniform(*lk.param_bounds, size=(9, 2))
        vals = mp.run_map_objective(lk, pts)
    finally:
        mp.close()
    assert len(got) == len(want) == 6
    for (pt, lp), (jpt, jlp) in zip(got, want):
        np.testing.assert_array_equal(pt, jpt)
        np.testing.assert_allclose(lp, jlp, rtol=RTOL)
    np.testing.assert_array_equal(
        vals, tpool.SerialPool().run_map_objective(lk, pts))
    # the serial pool draws from the rng itself (not one seed per point)
    serial = tpool.SerialPool().get_cobaya_initial_points(
        lk, 2, rng=np.random.default_rng(8))
    rng = np.random.default_rng(8)
    np.testing.assert_array_equal(serial[1][0],
                                  [lk._get_single_valid_point(rng)
                                   for _ in range(2)][1][0])


def test_a_worker_that_cannot_import_cobaya_fails_fast(fake_cobaya,
                                                       monkeypatch, tmp_path):
    """The stand-in removed from the workers' path: the pool raises instead
    of respawning workers whose likelihood does not load."""
    lk = CobayaLikelihood(_info(d=2))
    monkeypatch.setattr(sys, "path", [p for p in sys.path
                                      if "fake_site" not in p])
    mp = tpool.MultiprocessPool(n_workers=2)
    try:
        with pytest.raises(RuntimeError, match="could not load the likelihood"):
            mp.get_cobaya_initial_points(lk, 2, rng=np.random.default_rng(0))
    finally:
        mp.close()


@pytest.mark.parametrize("pool", ["serial", "distributed"])
def test_bobe_initial_design_matches_the_jax_package(fake_cobaya, tmp_path,
                                                     pool):
    """Sobol points then the Cobaya draws, deduped: the port's design and
    values equal the JAX package's for the same seed (the distributed pool
    outside a torch.distributed job is a pool of size 1)."""
    info = _info(d=2)
    kw = dict(loglikelihood=info, n_sobol_init=6, n_cobaya_init=2, seed=3,
              likelihood_name="cobaya_design", save=False,
              verbosity="WARNING")
    bobe = BOBE(pool=pool, device="cpu", save_dir=str(tmp_path), **kw)
    ref = JaxBOBE(pool="serial", save_dir=str(tmp_path), **kw)
    assert isinstance(bobe.loglikelihood, CobayaLikelihood)
    assert bobe.gp.npoints == ref.gp.npoints == 8
    np.testing.assert_allclose(bobe.gp.train_x.numpy(),
                               np.asarray(ref.gp.train_x), rtol=RTOL)
    np.testing.assert_allclose(bobe.gp.train_y_raw.numpy(),
                               np.asarray(ref.gp.train_y_raw), rtol=RTOL)
    np.testing.assert_allclose(bobe.best_f, ref.best_f, rtol=RTOL)


def test_bobe_run_through_the_stand_in_converges(fake_cobaya, tmp_path):
    """tests/test_cobaya_adapter.py's end-to-end run in the port: a
    normalised Gaussian log-posterior (sd 0.15) at the centre of
    [0, 2] x [-1, 1], reference draws around its peak, WIPStd with a uniform
    MC pool. With the log-prior-volume shift the evidence is the Gaussian's
    mass in the box."""
    from scipy.stats import norm

    info = {"fake": {"bounds": [[0.0, 2.0], [-1.0, 1.0]], "sig_frac": 0.075}}
    bobe = BOBE(loglikelihood=info, n_sobol_init=12, n_cobaya_init=4, seed=7,
                save_dir=str(tmp_path), verbosity="WARNING", pool="serial",
                device="cpu")
    np.testing.assert_allclose(bobe.loglikelihood.cobaya_model.sig, 0.15)
    res = bobe.run(acq="wipstd", min_evals=16, max_evals=60, batch_size=2,
                   logz_threshold=0.3, ns_n_points=8,
                   mc_points_method="uniform", num_hmc_warmup=64,
                   num_hmc_samples=64, mc_points_size=32)
    truth = float(2 * np.log(norm.cdf(1.0 / 0.15) - norm.cdf(-1.0 / 0.15)))
    assert np.isfinite(res["logz"]["mean"])
    assert res["logz"]["mean"] == pytest.approx(truth, abs=0.5)
