"""Parity of the port's classifier-gated GP (bobe_tpu_torch.models.clf_gp,
models.classifiers) and the DSLP prior with the JAX package's, on the CPU.

* DSLP: the GP objective with the DSLP lengthscale prior at rtol 1e-9.
* SVM: the JAX package trains scikit-learn's SVC; the port has its own SMO
  solver. On ~200 seeded planck-like points the two agree on the label of
  every training point and on >= 99.5 % of 10,000 uniform points (measured:
  99.99 %), and the port's dual solution meets KKT within 1e-3.
* nn / ellipsoid: AdamW from the same initial parameters over the same
  permutations: parameters and probabilities at rtol 1e-10 (measured
  ~1e-14).
* GPwithClassifier: a JAX state carried across (svm, nn and ellipsoid
  classifiers) gives the same gated predictions at rtol 1e-9; the same
  updates give the same GP subset; state dicts and npz files load in both
  directions.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bobe_tpu  # noqa: F401  (float64 in JAX)
from bobe_tpu.models import classifiers as jclf
from bobe_tpu.models import clf_gp as jcgp
from bobe_tpu.models import gp as jgp
from bobe_tpu.utils import seed as jseed
from bobe_tpu_torch.models import classifiers as tclf
from bobe_tpu_torch.models import clf_gp as tcgp
from bobe_tpu_torch.models import gp as tgp
from bobe_tpu_torch.models import toys
from bobe_tpu_torch.utils import seed as tseed
from bobe_tpu_torch.utils.core import (get_threshold_for_nsigma, scale_from_unit,
                                       scale_to_unit)

RTOL = 1e-9
MINUS_INF = -1e5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _clf_data(n=40, d=2, seed=0):
    """tests/test_clf_gp.py's data: a Gaussian bump with a minus_inf
    failure region (x0 > 0.8)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, d))
    y = -50.0 * np.sum((x - 0.4) ** 2, axis=1)
    return x, np.where(x[:, 0] > 0.8, MINUS_INF, y)


def _gp_kwargs(d, seed=1):
    """Fixed hyperparameters and noise 1e-6, so both packages' Cholesky
    factors agree far below rtol 1e-9."""
    rng = np.random.default_rng(seed)
    return dict(noise=1e-6, lengthscales=rng.uniform(0.3, 0.6, size=d),
                kernel_variance=3.0, clf_use_size=10, minus_inf=MINUS_INF,
                clf_threshold=100.0, gp_threshold=200.0)


_FAST = {"nn": {"n_epochs": 20, "n_restarts": 1},
         "ellipsoid": {"n_epochs": 20, "n_restarts": 1}, "svm": {}}


def _jax_clf_gp(kind, n=40, seed=0):
    x, y = _clf_data(n, seed=seed)
    jseed.set_global_seed(3)
    return jcgp.GPwithClassifier(train_x=x, train_y=y, clf_type=kind,
                                 clf_settings=_FAST[kind], **_gp_kwargs(2))


def _queries(n=500, seed=9):
    return np.random.default_rng(seed).uniform(size=(n, 2))


# ------------------------------------------------------------------ DSLP

def test_dslp_neg_mll_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.uniform(size=(30, 3))
    y = -10.0 * np.sum((x - 0.6) ** 2, axis=1) + 0.01 * rng.normal(size=30)
    kw = dict(train_x=x, train_y=y, noise=1e-6, lengthscale_prior="DSLP")
    jg, tg = jgp.GP(**kw), tgp.GP(device="cpu", **kw)
    lps = rng.uniform(np.log(0.1), np.log(2.0), size=(4, 4))
    for lp in lps:
        want = float(jg.neg_mll(jnp.asarray(lp)))
        got = float(tg.neg_mll(lp))
        np.testing.assert_allclose(got, want, rtol=RTOL)
    # restart lanes at once
    lanes = tgp.neg_mll(tg.state, tg.cfg, torch.as_tensor(lps))
    np.testing.assert_allclose(
        lanes.numpy(), [float(jg.neg_mll(jnp.asarray(lp))) for lp in lps],
        rtol=RTOL)
    assert tg.state_dict()["lengthscale_prior_spec"] == "DSLP"
    # the SAAS prior builds on the same data (tests/test_torch_saas.py
    # holds it to the JAX package)
    saas = tgp.GP(device="cpu", **{**kw, "lengthscale_prior": "SAAS"})
    assert saas.state_dict()["lengthscale_prior_spec"] == "SAAS"


# -------------------------------------------------------------------- SVM

def _planck_like_labels(n=200, seed=21):
    """~200 seeded planck-like points in the unit cube (a quarter from the
    reference draws near the posterior, the rest uniform, the failure
    region at minus_inf) and the clf GP's labels at its d=6 threshold."""
    loglike, bounds, _, _ = toys.make_planck_like()
    rng = np.random.default_rng(seed)
    ref_x, ref_y = toys.planck_like_ref_draws(loglike, bounds, n // 4, rng)
    u = rng.uniform(size=(n - n // 4, 6))
    ys = []
    for p in scale_from_unit(u, bounds):
        try:
            ys.append(loglike(p))
        except RuntimeError:
            ys.append(-1e10)
    x = np.vstack([scale_to_unit(ref_x, bounds), u])
    y = np.concatenate([ref_y, ys])
    thr = max(75.0, get_threshold_for_nsigma(20, 6))
    return x, np.where(y < y.max() - thr, 0, 1)


def test_svm_matches_sklearn_on_planck_like_data():
    from sklearn.svm import SVC

    x, lab = _planck_like_labels()
    assert 0 < lab.sum() < len(lab)
    params, metrics, predict = tclf.train_svm_classifier(x, lab, device="cpu")
    sk = SVC(kernel="rbf", gamma="scale", C=1e7).fit(x, lab)
    np.testing.assert_array_equal(predict(torch.as_tensor(x)).numpy(), lab)
    np.testing.assert_array_equal(sk.predict(x), lab)
    q = np.random.default_rng(5).uniform(size=(10000, 6))
    agree = np.mean(predict(torch.as_tensor(q)).numpy() == sk.predict(q))
    assert agree >= 0.995, agree
    # the layout of the JAX package: padded support vectors, zero coef
    n_sv = metrics["n_support_vectors"]
    sv = params["support_vectors"]
    assert sv.shape[0] % tclf.SV_PAD == 0 and sv.shape[0] >= n_sv
    assert torch.all(params["dual_coef"][n_sv:] == 0)
    assert n_sv == len(sk.support_)
    np.testing.assert_allclose(float(params["gamma"]), sk._gamma, rtol=1e-12)
    assert metrics["kkt_violation"] < 1e-3


def test_smo_meets_kkt_and_the_decision_of_sklearn():
    """The dual solution from the kernel matrix directly: feasible, KKT
    violation max_{I_up} -y G - min_{I_low} -y G below the tolerance, and
    decision values close to scikit-learn's."""
    from sklearn.svm import SVC

    x, lab = _planck_like_labels(seed=22)
    y = np.where(lab > 0, 1.0, -1.0)
    gamma = tclf.rbf_gamma_scale(x)
    K = tclf.rbf_kernel_matrix(x, x, gamma)
    C = 1e7
    alpha, rho, n_iter, violation = tclf.smo_solve(K, y, C)
    assert np.all(alpha >= 0) and np.all(alpha <= C)
    assert abs(np.dot(y, alpha)) < 1e-6 * max(1.0, alpha.sum())
    G = y * (K @ (y * alpha)) - 1.0
    up = np.where(y > 0, alpha < C, alpha > 0)
    low = np.where(y > 0, alpha > 0, alpha < C)
    kkt = np.max(-y[up] * G[up]) - np.min(-y[low] * G[low])
    assert kkt < 1e-3 and violation < 1e-3 and n_iter > 0
    sk = SVC(kernel="rbf", gamma="scale", C=1e7).fit(x, lab)
    q = np.random.default_rng(6).uniform(size=(2000, 6))
    mine = tclf.rbf_kernel_matrix(q, x, gamma) @ (y * alpha) - rho
    theirs = sk.decision_function(q)
    scale = np.max(np.abs(theirs))
    assert np.max(np.abs(mine - theirs)) < 1e-3 * scale


def test_svm_decision_replay_matches_jax():
    x, lab = _planck_like_labels(seed=23)
    jp, _, jpred = jclf.train_svm_classifier(x, lab)
    tp = tclf.params_to_device({k: np.asarray(v) for k, v in jp.items()},
                               "cpu")
    q = np.random.default_rng(7).uniform(size=(3000, 6))
    np.testing.assert_array_equal(
        tclf._svm_apply(tp, torch.as_tensor(q)).numpy(),
        np.asarray(jpred(jnp.asarray(q))))


# --------------------------------------------------- nn / ellipsoid (AdamW)

def _init_params(kind, d, best_pt, seed=13):
    """Seeded initial parameters in the JAX package's layout and scales (He
    normal layers, zero biases; a 0.1-scaled lower triangle)."""
    rng = np.random.default_rng(seed)
    if kind == "nn":
        dims = (d, 32, 32, 1)
        return {"layers": [(rng.normal(size=(dims[i], dims[i + 1]))
                            * np.sqrt(2.0 / dims[i]), np.zeros(dims[i + 1]))
                           for i in range(3)]}
    return {"flat_L": rng.normal(size=d * (d + 1) // 2) * 0.1,
            "alpha": np.asarray(1.0), "beta": np.asarray(0.0),
            "mu": np.asarray(best_pt, dtype=np.float64)}


def _to_jax(params):
    if "layers" in params:
        return {"layers": tuple((jnp.asarray(w), jnp.asarray(b))
                                for w, b in params["layers"])}
    return {k: jnp.asarray(v) for k, v in params.items()}


@pytest.mark.parametrize("kind", ["nn", "ellipsoid"])
def test_adamw_training_matches_jax(kind):
    """One restart from the same initial parameters, 30 epochs over the
    same permutations (the restart seed from the same global numpy
    generator): parameters and probabilities at rtol 1e-10."""
    rng = np.random.default_rng(31)
    x = rng.uniform(size=(90, 2))
    lab = (np.sum((x - 0.45) ** 2, axis=1) < 0.12).astype(int)
    best_pt = np.array([0.45, 0.45])
    init = _init_params(kind, 2, best_pt)
    settings = {"n_restarts": 1, "n_epochs": 30, "batch_size": 32}
    jseed.set_global_seed(11)
    tseed.set_global_seed(11)
    jp, jm, jpred = jclf.CLASSIFIER_REGISTRY[kind]["train_fn"](
        x, lab, dict(settings), init_params=_to_jax(init), best_pt=best_pt)
    tp, tm, tpred = tclf.CLASSIFIER_REGISTRY[kind]["train_fn"](
        x, lab, dict(settings), init_params=init, best_pt=best_pt,
        device="cpu")
    want = tclf.params_to_numpy(tclf.params_to_device(
        {k: (v if k != "layers" else [(np.asarray(w), np.asarray(b))
                                      for w, b in v])
         for k, v in jp.items()}, "cpu"))
    got = tclf.params_to_numpy(tp)
    flat = lambda p: (np.concatenate([np.ravel(a) for wb in p["layers"]
                                      for a in wb]) if "layers" in p else
                      np.concatenate([np.ravel(p[k]) for k in sorted(p)]))
    moved = np.max(np.abs(flat(got) - flat(init)))
    assert moved > 1e-3  # training changed the parameters
    np.testing.assert_allclose(flat(got), flat(want), rtol=1e-10,
                               atol=1e-12 * np.max(np.abs(flat(want))))
    np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-10)
    q = _queries(300)
    np.testing.assert_allclose(tpred(torch.as_tensor(q)).numpy(),
                               np.asarray(jpred(jnp.asarray(q))), rtol=1e-10)


def test_training_keeps_the_previous_parameters_when_every_restart_diverges():
    x = np.random.default_rng(2).uniform(size=(20, 2))
    lab = (x[:, 0] > 0.5).astype(int)
    x[3, 1] = np.nan  # every loss is NaN
    init = _init_params("ellipsoid", 2, [0.5, 0.5])
    tseed.set_global_seed(1)
    params, metrics, _ = tclf.train_ellipsoid_classifier(
        x, lab, {"n_epochs": 2, "n_restarts": 2}, init_params=init,
        device="cpu")
    assert np.isnan(metrics["loss"])
    np.testing.assert_array_equal(params["flat_L"].numpy(), init["flat_L"])


# ------------------------------------------------------- GPwithClassifier

@pytest.mark.parametrize("kind", ["svm", "nn", "ellipsoid"])
def test_gated_predictions_of_a_jax_state_match_jax(kind):
    jg = _jax_clf_gp(kind)
    assert jg.use_clf and jg.clf_params is not None
    tg = tgp.state_from_numpy(jg.state_dict(), device="cpu")
    assert isinstance(tg, tcgp.GPwithClassifier)
    assert tg.npoints == jg.npoints == 40 and tg.gp_size == int(jg.state.n)
    assert tg.gp_size < tg.npoints and tg._clf_ctx is not None
    q = _queries()
    qj = jnp.asarray(q)
    mean = tg.predict_mean_batched(q).numpy()
    np.testing.assert_allclose(mean, np.asarray(jg.predict_mean_batched(qj)),
                               rtol=RTOL)
    # the variance amp - |V|^2 cancels: as tests/test_torch_gp.py holds it
    np.testing.assert_allclose(tg.predict_var_batched(q).numpy(),
                               np.asarray(jg.predict_var_batched(qj)),
                               rtol=1e-7, atol=1e-12)
    (tm, tv), (jm, jv) = tg.predict_batched(q), jg.predict_batched(qj)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=RTOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-7,
                               atol=1e-12)
    lp = np.log(np.r_[jg.lengthscales, jg.kernel_variance]) + 0.1
    np.testing.assert_allclose(
        tg.predict_mean_with_params(lp, q).numpy(),
        np.asarray(jg.predict_mean_with_params(jnp.asarray(lp), qj)),
        rtol=RTOL)
    if kind == "svm":
        # the failure region is gated, the bump is not
        assert np.all(mean[q[:, 0] > 0.9] == MINUS_INF)
        assert np.all(mean[np.sum((q - 0.4) ** 2, axis=1) < 0.01] > MINUS_INF)


def test_update_and_rebuild_match_jax():
    """An appending update extends both GPs alike; a new incumbent that
    moves the GP-subset cut rebuilds both on the same subset, with the
    hyperparameters kept and the identity pad block at the new capacity.
    The subsets are identical; the means after an update agree to rtol
    1e-6 (each package's extended or rebuilt factor carries ~cond * eps)."""
    x, y = _clf_data(30, seed=1)
    jseed.set_global_seed(3)
    jg = jcgp.GPwithClassifier(train_x=x, train_y=y, clf_type="svm",
                               **_gp_kwargs(2))
    tg = tgp.state_from_numpy(jg.state_dict(), device="cpu")
    steps = [(np.array([[0.41, 0.39], [0.41, 0.39]]), np.array([-0.5, -0.6])),
             (np.array([[0.42, 0.40], [0.9, 0.1]]), np.array([150.0, MINUS_INF])),
             (np.array([[0.43, 0.41]]), np.array([500.0]))]
    sizes = []
    for new_x, new_y in steps:
        jg.update(new_x, new_y)
        tg.update(new_x, new_y)
        assert tg.clf_data_size == jg.clf_data_size
        assert tg.gp_size == int(jg.state.n)
        np.testing.assert_array_equal(tg.train_x.numpy(),
                                      np.asarray(jg.train_x))
        np.testing.assert_array_equal(tg.train_y_clf, jg.train_y_clf)
        np.testing.assert_allclose(tg.lengthscales.numpy(),
                                   np.asarray(jg.lengthscales), rtol=RTOL)
        q = _queries(200, seed=len(sizes))
        np.testing.assert_allclose(
            tg.predict_mean_batched(q).numpy(),
            np.asarray(jg.predict_mean_batched(jnp.asarray(q))), rtol=1e-6)
        sizes.append(tg.gp_size)
    # the intra-batch duplicate was dropped; the incumbent at 500 drops
    # every row below 300 from the GP
    assert tg.clf_data_size == 30 + 4
    assert sizes[-1] < sizes[-2]
    st = tg.state
    n = st.n
    eye = torch.eye(st.cap - n, dtype=st.chol.dtype)
    assert torch.equal(st.chol[n:, n:], eye) and st.cap % 128 == 0
    np.testing.assert_allclose(tg.kernel_variance, 3.0, rtol=RTOL)


def test_state_dict_and_npz_round_trip_both_ways(tmp_path):
    jg = _jax_clf_gp("nn")
    tg = tgp.state_from_numpy(jg.state_dict(), device="cpu")
    q = _queries(300, seed=4)
    want = tg.predict_mean_batched(q).numpy()
    # port -> JAX through the state dict
    back = jcgp.GPwithClassifier.from_state_dict(tg.state_dict())
    np.testing.assert_allclose(
        np.asarray(back.predict_mean_batched(jnp.asarray(q))), want,
        rtol=RTOL)
    # port -> JAX through an npz file, and back into the port
    path = str(tmp_path / "clf_gp")
    tg.save(path)
    jl = jcgp.GPwithClassifier.load(path)
    np.testing.assert_allclose(
        np.asarray(jl.predict_mean_batched(jnp.asarray(q))), want, rtol=RTOL)
    tl = tcgp.GPwithClassifier.load(path, device="cpu")
    assert isinstance(tl, tcgp.GPwithClassifier) and tl.clf_type == "nn"
    np.testing.assert_allclose(tl.predict_mean_batched(q).numpy(), want,
                               rtol=RTOL)
    # copy keeps the class, the classifier and the subset
    cp = tg.copy()
    assert isinstance(cp, tcgp.GPwithClassifier)
    assert cp.gp_size == tg.gp_size and cp.npoints == tg.npoints
    np.testing.assert_allclose(cp.predict_mean_batched(q).numpy(), want,
                               rtol=RTOL)


def test_classifier_disables_on_equal_labels_and_random_points():
    x, y = _clf_data(40)
    kw = {**_gp_kwargs(2), "clf_threshold": 1e9, "gp_threshold": 2e9}
    g = tcgp.GPwithClassifier(train_x=x, train_y=y, clf_type="svm",
                              device="cpu", **kw)
    # every label is 1: no classifier, plain predictions
    assert not g.use_clf and g._clf_ctx is None
    assert g.gp_size == g.npoints == 40
    g = tcgp.GPwithClassifier(train_x=x, train_y=y, clf_type="svm",
                              device="cpu", **_gp_kwargs(2))
    assert g.use_clf and g.cfg.lengthscale_prior == "DSLP"
    rng = np.random.default_rng(7)
    for _ in range(10):
        pt = g.get_random_point(rng=rng)
        assert pt.shape == (2,) and pt[0] <= 0.8
