"""The port's ``BOBE(resume=True)`` on the CPU: resuming from the port's own
files and from files the JAX package wrote (its GP npz and its run's
results), a fresh start when the GP file is broken, a resume without a file
argument from the run's own save path, and the short-circuit of a run that
had already converged below the new threshold, with no likelihood call.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bobe_tpu  # noqa: F401  (float64 in JAX)
from bobe_tpu.models import gp as jgp
from bobe_tpu.utils.results import BOBEResults as JaxResults
from bobe_tpu_torch import bo
from bobe_tpu_torch.bo import BOBE
from bobe_tpu_torch.models import toys


@pytest.fixture(autouse=True)
def _short_final_nuts(monkeypatch):
    """Runs cut at max_evals end on the final NUTS samples: cut their depth
    (what is tested here is the resume, not the sampler)."""
    monkeypatch.setattr(bo, "FINAL_NUTS", {"num_chains": 2,
                                           "warmup_steps": 32,
                                           "samples_per_dim": 32,
                                           "thinning": 1})


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


class _Counting:
    """The 2-d Gaussian toy's likelihood, counting its calls."""

    def __init__(self):
        self.fn, self.bounds, self.logz = toys.make_gaussian(2, sigma=0.15)
        self.calls = 0

    def __call__(self, x):
        self.calls += 1
        return self.fn(x)


def _bobe(tmp_path, like, **kw):
    args = dict(loglikelihood=like, param_list=["a", "b"],
                param_bounds=like.bounds, likelihood_name="resume_port",
                n_sobol_init=16, seed=5, save_dir=str(tmp_path),
                verbosity="WARNING", pool="serial", device="cpu")
    args.update(kw)
    return BOBE(**args)


def _jax_files(tmp_path, like, converged, delta=0.02, last_iter=7):
    """The files a JAX package run leaves: its GP npz and its results
    (acquisition, best values and one convergence check), written by the
    JAX package itself."""
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(20, 2))
    y = np.asarray([like.fn(like.bounds[0] + xi * (like.bounds[1]
                                                  - like.bounds[0]))
                    for xi in x])
    gp = jgp.GP(train_x=jnp.asarray(x), train_y=jnp.asarray(y), noise=1e-6,
                lengthscales=jnp.asarray([0.2, 0.2]), kernel_variance=2.0)
    gp.save(os.path.join(str(tmp_path), "resume_port_gp"))
    rm = JaxResults(output_file="resume_port", save_dir=str(tmp_path),
                    param_names=["a", "b"], param_labels=["a", "b"],
                    param_bounds=like.bounds, likelihood_name="resume_port")
    for i in range(1, last_iter + 1):
        rm.update_acquisition(i, 1.0 / i, "WIPStd")
        rm.update_best_loglike(i, -5.0 + 0.5 * i)
    rm.update_convergence(last_iter, {"mean": like.logz, "upper":
                                      like.logz + delta,
                                      "lower": like.logz - delta,
                                      "std": 0.01}, converged, 0.05)
    rm.converged = converged
    rm.save_intermediate()
    return x, y


def test_resume_from_jax_package_files(tmp_path):
    """The JAX package's GP npz and results restore the GP rows, the start
    iteration and the best value; no Sobol design is evaluated."""
    like = _Counting()
    x, y = _jax_files(tmp_path, like, converged=False)
    bobe = _bobe(tmp_path, like, resume=True,
                 resume_file=os.path.join(str(tmp_path), "resume_port"))
    assert like.calls == 0
    assert bobe.gp.npoints == 20
    np.testing.assert_allclose(bobe.gp.train_x.numpy(), x, rtol=0)
    assert bobe.start_iteration == 7
    assert bobe.best_f == pytest.approx(max(max(y), -5.0 + 0.5 * 7))
    assert not bobe.prev_converged


def test_converged_resume_short_circuits_without_a_likelihood_call(tmp_path):
    """A resume of a run that converged at delta 0.02, asked for a threshold
    of 0.05, ends at once ("Already converged in previous run") with the
    earlier evidence and no likelihood call; with a threshold below the
    earlier delta it continues."""
    like = _Counting()
    _jax_files(tmp_path, like, converged=True, delta=0.02)
    bobe = _bobe(tmp_path, like, resume=True)  # from its own save path
    assert bobe.prev_converged and bobe.prev_convergence_delta == \
        pytest.approx(0.02)
    res = bobe.run(acq="wipstd", logz_threshold=0.05, max_evals=40)
    assert like.calls == 0
    assert res["termination_reason"] == "Already converged in previous run"
    assert res["logz"]["mean"] == pytest.approx(like.logz)
    bobe2 = _bobe(tmp_path, like, resume=True)
    res2 = bobe2.run(acq="wipstd", logz_threshold=0.01, max_evals=22,
                     min_evals=1000, mc_points_method="uniform",
                     num_hmc_samples=64)
    assert like.calls > 0
    assert res2["termination_reason"] == "Maximum evaluations reached"


def test_broken_gp_file_starts_fresh(tmp_path):
    like = _Counting()
    with open(os.path.join(str(tmp_path), "resume_port_gp.npz"), "wb") as f:
        f.write(b"not an npz file")
    bobe = _bobe(tmp_path, like, resume=True)
    assert bobe.fresh_start
    assert bobe.gp.npoints == 16 and like.calls == 16
    assert bobe.start_iteration == 0


def test_resume_from_the_ports_own_files(tmp_path):
    """A run with save=True cut at max_evals, then resume=True from its own
    files: the GP holds every row of the first run, the iteration count
    continues from the first run's last, and the run goes on."""
    like = _Counting()
    first = _bobe(tmp_path, like, save_step=1)
    r1 = first.run(acq="wipstd", mc_points_method="uniform", min_evals=1000,
                   max_evals=24, num_hmc_samples=64, batch_size=4)
    assert r1["termination_reason"] == "Maximum evaluations reached"
    n1, it1 = r1["gp"].npoints, first.current_iteration
    calls1 = like.calls
    second = _bobe(tmp_path, like, resume=True)
    assert like.calls == calls1
    assert second.gp.npoints == n1
    np.testing.assert_allclose(second.gp.train_x.numpy(),
                               r1["gp"].train_x.numpy(), rtol=0)
    assert second.start_iteration == it1
    r2 = second.run(acq="wipstd", mc_points_method="uniform", min_evals=1000,
                    max_evals=n1 + 4, num_hmc_samples=64, batch_size=4)
    assert r2["gp"].npoints == n1 + 4
    assert second.current_iteration == it1 + 1
