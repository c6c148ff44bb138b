"""The port end to end on the CPU: ``BOBE(...).run(acq="wipstd")`` with the
default EHMC MC pool, with ``mc_points_method="NS"`` and ``"NUTS"``, and a
run without a successful NS that falls back to final NUTS samples, on a 2-d
Gaussian toy with an analytic evidence; a classifier-gated run
(``use_clf=True``) on a 2-d toy with a failure region that ends on the
final dynamic NS (``do_final_ns=True``); the constructor branch that once
raised (the device server) now building a client that touches no device;
the GP options reaching BOBE's GP.

These runs are small-budget counterparts of tests/test_bo_2d.py's with a
loose threshold, checked against the analytic logZ.
"""
import os

import numpy as np
import pytest
import torch

from bobe_tpu_torch import bo, config
from bobe_tpu_torch.bo import BOBE
from bobe_tpu_torch.models import toys
from bobe_tpu_torch.models.gp import GP
from bobe_tpu_torch.parallel.pool import make_pool


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _bobe(tmp_path, **kw):
    loglike, bounds, _ = toys.make_gaussian(2, sigma=0.15)
    args = dict(loglikelihood=loglike, param_list=["a", "b"],
                param_bounds=bounds, likelihood_name="gauss_port",
                n_sobol_init=16, seed=5, save_dir=str(tmp_path),
                verbosity="WARNING", pool="serial", device="cpu")
    args.update(kw)
    return BOBE(**args)


def test_slice_end_to_end_on_a_gaussian(tmp_path):
    _, _, logz_true = toys.make_gaussian(2, sigma=0.15)
    bobe = _bobe(tmp_path)
    results = bobe.run(acq="wipstd", mc_points_method="NS", min_evals=20,
                       max_evals=60, max_gp_size=60, logz_threshold=0.5,
                       convergence_n_iters=1, fit_n_points=4, batch_size=4,
                       ns_n_points=4, mc_points_size=64, do_final_ns=False)
    for key in ("gp", "likelihood", "results_manager", "best_val", "best_pt",
                "logz", "termination_reason", "samples"):
        assert key in results
    logz = results["logz"]
    assert np.isfinite(logz["mean"])
    assert abs(logz["mean"] - logz_true) < 0.5, (logz, logz_true)
    assert results["gp"].npoints <= 60
    assert results["gp"].state.x.device.type == "cpu"
    samples = results["samples"]
    assert samples["x"].shape[1] == 2 and len(samples["weights"]) > 0
    # samples are in the physical box
    assert samples["x"].min() >= 0.0 and samples["x"].max() <= 1.0
    base = os.path.join(str(tmp_path), "gauss_port")
    for suffix in ("_results.pkl", ".txt", ".paramnames", ".ranges",
                   "_stats.json", "_timing.json", "_intermediate.json",
                   "_gp.npz"):
        assert os.path.exists(base + suffix), f"missing {suffix}"
    timing = results["results_manager"].get_timing_summary()["phase_times"]
    assert timing["Nested Sampling"] > 0 and timing["GP Training"] > 0


@pytest.mark.parametrize("init_kw,item", [
    ({"server": "/tmp/bobe.sock"}, "server"),
])
def test_unported_construction_branches_raise(tmp_path, init_kw, item):
    """The branches that raised NotImplementedError are ported: nothing
    raises it, and ``server=`` builds a device-server client
    (client.ServerBOBE; tests/test_torch_server.py runs it) whose
    constructor captures its arguments and sets up nothing on a device."""
    from bobe_tpu_torch.client import ServerBOBE

    assert not hasattr(config, "ROADMAP_ITEMS")
    assert not hasattr(config, "not_ported")
    bobe = _bobe(tmp_path, **init_kw)
    assert isinstance(bobe, ServerBOBE)
    assert bobe._server_socket == init_kw[item]
    assert bobe._server_init["seed"] == 5
    assert bobe._server_init["device"] == "cpu"
    assert bobe.gp is None and not hasattr(bobe, "device")
    assert not os.path.exists(os.path.join(str(tmp_path), "gauss_port_gp.npz"))


def _check_gaussian_run(results, logz_true):
    assert results["termination_reason"] == "LogZ converged"
    logz = results["logz"]
    assert np.isfinite(logz["mean"])
    assert abs(logz["mean"] - logz_true) < 0.5, (logz, logz_true)
    samples = results["samples"]
    assert samples["x"].min() >= 0.0 and samples["x"].max() <= 1.0
    timing = results["results_manager"].get_timing_summary()["phase_times"]
    assert timing["MCMC Sampling"] > 0


def test_default_run_converges_with_the_ehmc_pool(tmp_path):
    """``run(acq="wipstd")`` with its own defaults: the EHMC MC pool, its
    refreshes re-warmed from the previous one's adapted kernel."""
    _, _, logz_true = toys.make_gaussian(2, sigma=0.15)
    bobe = _bobe(tmp_path, save=False)
    results = bobe.run(acq="wipstd", min_evals=20, max_evals=60,
                       max_gp_size=60, logz_threshold=0.5, fit_n_points=4,
                       ns_n_points=4)
    _check_gaussian_run(results, logz_true)
    ws = bobe._nuts_warm
    assert ws["kind"] == "ehmc" and ws["num_chains"] == 64
    assert ws["last_z"].shape == (64, 2)


def test_nuts_pool_run_converges(tmp_path):
    _, _, logz_true = toys.make_gaussian(2, sigma=0.15)
    bobe = _bobe(tmp_path, save=False)
    results = bobe.run(acq="wipstd", mc_points_method="NUTS", min_evals=20,
                       max_evals=60, max_gp_size=60, logz_threshold=0.5,
                       fit_n_points=4, ns_n_points=4, num_hmc_warmup=64,
                       num_hmc_samples=128)
    _check_gaussian_run(results, logz_true)
    assert bobe._nuts_warm["kind"] == "nuts"


@pytest.mark.parametrize("init_kw", [
    {"gp_kwargs": {"input_warp": True}},
    {"gp_kwargs": {"lengthscale_prior": "SAAS"}},
    {"optimizer": "adam"},
])
def test_gp_options_reach_the_gp(tmp_path, init_kw):
    """BOBE's gp_kwargs and optimizer reach its GP (the options themselves
    are held to the JAX package in tests/test_torch_warp.py,
    test_torch_saas.py and test_torch_optimizers.py)."""
    bobe = _bobe(tmp_path, n_sobol_init=8, save=False, **init_kw)
    cfg = bobe.gp.cfg
    assert cfg.input_warp == ("input_warp" in init_kw.get("gp_kwargs", {}))
    assert (cfg.lengthscale_prior == "SAAS") == \
        ("lengthscale_prior" in init_kw.get("gp_kwargs", {}))
    assert bobe.gp.optimizer_method == init_kw.get("optimizer", "lbfgs")
    assert np.isfinite(float(bobe.gp.neg_mll(
        np.log(bobe.gp.get_hyperparams().numpy()))))


def test_no_successful_ns_falls_back_to_nuts_samples(tmp_path):
    """A run that ends before any NS (min_evals > max_evals) returns final
    NUTS samples at the JAX package's settings: 4 chains, 2000 transitions
    per dimension, every 4th kept, in the physical box, with the GP mean as
    their logl."""
    bobe = _bobe(tmp_path, n_sobol_init=8, save=False)
    results = bobe.run(acq="wipstd", min_evals=1000, max_evals=12,
                       batch_size=4, fit_n_points=4)
    assert not results["logz"]
    assert results["termination_reason"] == "Maximum evaluations reached"
    samples = results["samples"]
    n = bo.FINAL_NUTS["num_chains"] * bo.FINAL_NUTS["samples_per_dim"] * 2 \
        // bo.FINAL_NUTS["thinning"]
    assert samples["x"].shape == (n, 2)
    assert samples["x"].min() >= 0.0 and samples["x"].max() <= 1.0
    assert np.all(np.isfinite(samples["logl"]))
    np.testing.assert_array_equal(samples["weights"], np.ones(n))
    timing = results["results_manager"].get_timing_summary()["phase_times"]
    assert timing["MCMC Sampling"] > 0


def test_pools_and_device(monkeypatch):
    assert type(make_pool("auto")).__name__ == "SerialPool"
    with pytest.raises(ValueError):
        make_pool("mpi")
    monkeypatch.setattr(config, "_DEVICE", None)
    assert config.get_device() == torch.device("cuda")
    assert config.resolve_device("cpu") == torch.device("cpu")
    assert config.DTYPE == torch.float64
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_no_card_and_no_device_raises(tmp_path, monkeypatch):
    """The default device is cuda: without a card, BOBE(...) and GP(...)
    given no device= raise and name device="cpu" instead of running on
    the CPU unasked."""
    monkeypatch.setattr(config, "_DEVICE", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        config.resolve_device(None)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _bobe(tmp_path, device=None)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        GP(train_x=np.full((4, 2), 0.5), train_y=np.zeros(4))


GATED_CENTER = np.array([0.55, 0.5])


def _gated_loglike(x):
    """A normalised Gaussian (sigma 0.1) whose likelihood code fails for
    x0 < 0.3, 2.5 sigma from its peak: the adapter turns the failures into
    minus_inf. Over the unit box logZ is the Gaussian mass in
    [0.3, 1] x [0, 1]."""
    x = np.asarray(x)
    if x[0] < 0.3:
        raise RuntimeError("the likelihood code failed")
    return float(-0.5 * np.sum(((x - GATED_CENTER) / 0.1) ** 2)
                 - np.log(2 * np.pi * 0.01))


@pytest.mark.parametrize("clf_type", ["svm", "nn", "ellipsoid"])
def test_clf_construction_trains_the_classifier(tmp_path, clf_type):
    bobe = _bobe(tmp_path, loglikelihood=_gated_loglike, n_sobol_init=24,
                 use_clf=True, clf_type=clf_type, save=False)
    gp = bobe.gp
    assert type(gp).__name__ == "GPwithClassifier" and gp.clf_type == clf_type
    assert gp.use_clf and gp._clf_ctx is not None
    assert gp.cfg.lengthscale_prior == "DSLP"
    assert min(gp.train_y_clf) <= bobe.minus_inf < min(gp.train_y_raw)
    assert gp.gp_size < gp.npoints == gp.clf_data_size


def test_clf_run_ends_with_the_final_dynamic_ns(tmp_path):
    """use_clf=True, do_final_ns=True and min_evals above max_evals: no NS
    in the loop, so the run ends on the final fit, the dynamic NS and (when
    the measured noise asks) the top-up, timed as "Nested Sampling"; the
    classifier retrains after every batch ("Classifier Training")."""
    from scipy.stats import norm

    logz_true = float(np.log(norm.cdf(4.5) - norm.cdf(-2.5))
                      + np.log(norm.cdf(5.0) - norm.cdf(-5.0)))
    bobe = _bobe(tmp_path, loglikelihood=_gated_loglike, n_sobol_init=16,
                 seed=3, use_clf=True, clf_type="svm", save=False)
    results = bobe.run(acq="wipstd", min_evals=1000, max_evals=32,
                       max_gp_size=200, logz_threshold=0.1, fit_n_points=4,
                       batch_size=4, ns_n_points=8, do_final_ns=True)
    logz = results["logz"]
    assert np.isfinite(logz["mean"]) and logz["dlogz_sampler"] > 0
    assert abs(logz["mean"] - logz_true) < 0.3, (logz, logz_true)
    assert results["termination_reason"] in ("LogZ converged",
                                             "Maximum evaluations reached")
    rm = results["results_manager"]
    info = rm.gp_info
    assert info["classifier_used"] and info["classifier_type"] == "svm"
    gp = results["gp"]
    assert info["classifier_training_set_size"] == gp.clf_data_size == 32
    assert gp.gp_size < gp.clf_data_size
    assert min(gp.train_y_clf) <= bobe.minus_inf
    samples = results["samples"]
    assert samples["x"].min() >= 0.0 and samples["x"].max() <= 1.0
    assert np.all(samples["weights"] > 0)
    assert np.all(samples["x"][:, 0] >= 0.3 - 0.05)
    timing = rm.get_timing_summary()["phase_times"]
    assert timing["Nested Sampling"] > 0 and timing["Classifier Training"] > 0
