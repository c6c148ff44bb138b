"""BOBE orchestrator: the Bayesian-Optimisation-for-Bayesian-Evidence loop.

Counterpart of ``bobe_tpu/bo.py``: construct with a likelihood, call
``run()`` and receive logZ + posterior samples computed on a GP surrogate
that is actively refined by evidence-weighted acquisition.

The port runs the WIPV/WIPStd loop with an EHMC (the default), NUTS, NS or
uniform MC pool, and the EI/LogEI optimization loop, over a plain GP or,
with ``use_clf=True``, a classifier-gated one (models/clf_gp.py), with the
GP's options (``gp_kwargs``: the input warp, the SAAS prior) and its fit's
``optimizer`` ('lbfgs', 'adam' or 'scipy'):

* initial design = scrambled Sobol (+ Cobaya reference draws + user
  points), deduped, scaled to the unit cube;
* adaptive refit schedule by training-set size;
* WIP loop: greedy batches, the MC-pool refresh overlapped with the
  likelihood batch on a thread (an EHMC/NUTS refresh re-warms from the
  previous one's adapted kernel, ``warm_state``), NS-on-schedule with the
  logZ-bound convergence delta = (upper - lower) / 2 < threshold for
  ``convergence_n_iters`` successive checks, then a final-precision merged
  NS pass;
* ``do_final_ns=True`` on a run that did not converge: a final fit, a
  dynamic NS of merged runs and a top-up to the measured sampler noise;
* without a successful NS in the run, final posterior samples from NUTS;
* EI/LogEI: one point per iteration, ended when the acquisition's value
  stays below ``ei_goal`` for ``convergence_n_iters`` checks;
* ``resume=True``: the GP file and the run's results of an earlier run (of
  either package) are loaded and the run continues from its last
  iteration, or ends at once if it had converged below the new threshold;
* the results dict and the result files of the JAX package.

The likelihood is a callable, a ``Likelihood``, or a Cobaya model given
by its YAML path, YAML text or info dict (``CobayaLikelihood``). The GP
state lives on ``device`` (``config.get_device()``, cuda, by default;
without a card the constructor raises unless given ``device="cpu"``);
likelihood evaluations run on the host through the evaluation pool (in
process, in worker processes with ``pool="multiprocess"``, or on every rank
of a torch.distributed job with ``pool="distributed"``, where the ranks
other than 0 serve evaluations inside the constructor and never touch a
device).

With ``server=<socket>`` or ``BOBE_TPU_SERVER`` set, ``BOBE(...)`` returns
a client of a persistent device server instead (``client.ServerBOBE``): its
constructor captures the arguments and touches no device, and its ``run()``
runs on the server, which calls the likelihood back in this process.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from . import config
from .acquisition import EI, WIPV, LogEI, WIPStd, get_mc_samples
from .client import ServerBOBE, client_mode
from .likelihood import Likelihood, make_likelihood
from .models.clf_gp import GPwithClassifier
from .models.gp import GP
from .parallel.pool import EvalPool, make_pool
from .samplers import nested_sampling
from .utils import trace
from .utils.core import (get_threshold_for_nsigma, kl_divergence_gaussian,
                         resample_equal, scale_from_unit, scale_to_unit)
from .utils.log import get_logger, update_verbosity
from .utils.results import BOBEResults
from .utils.seed import get_numpy_rng, new_torch_generator, set_global_seed

log = get_logger("bo")

_ACQ_FUNCS = {"ei": EI, "logei": LogEI, "wipv": WIPV, "wipstd": WIPStd}
_MC_METHODS = ("EHMC", "NUTS", "NS", "uniform")
# largest nlive multiplier of the final NS passes and their top-up (see
# _ns_boost): the environment's BOBE_TPU_NS_BOOST_CAP, as in the JAX
# package, else 16
NS_BOOST_CAP = 16


def ns_boost_cap() -> int:
    return int(os.environ.get("BOBE_TPU_NS_BOOST_CAP", NS_BOOST_CAP))


# the final NUTS samples of a run without a successful NS: 4 chains, 512
# warmup transitions, 2000 transitions per dimension, every 4th kept
FINAL_NUTS = {"num_chains": 4, "warmup_steps": 512, "samples_per_dim": 2000,
              "thinning": 4}


def load_gp_file(filename: str, clf: bool, device=None):
    """The GP (or classifier GP) saved as ``filename`` (.npz) by either
    package, on ``device``."""
    cls = GPwithClassifier if clf else GP
    return cls.load(filename, device=device)


def load_gp_statedict(state_dict: Dict[str, Any], clf: bool, device=None):
    """The GP (or classifier GP) of a ``state_dict()`` of either package, on
    ``device``."""
    cls = GPwithClassifier if clf else GP
    return cls.from_state_dict(state_dict, device=device)


class BOBE:
    """Bayesian evidence via GP-surrogate Bayesian optimization."""

    def __new__(cls, *args, server: Optional[str] = None, **kwargs):
        # with a device server (``server=`` or BOBE_TPU_SERVER) the run is
        # the server's: the client's BOBE (client.py) captures the
        # arguments and touches no device
        if server is not None or client_mode():
            return ServerBOBE(*args, server=server, **kwargs)
        return super().__new__(cls)

    def __init__(self,
                 loglikelihood: Union[Callable, str, Dict[str, Any], Likelihood],
                 param_list: Optional[List[str]] = None,
                 param_bounds=None,
                 param_labels: Optional[List[str]] = None,
                 likelihood_name: Optional[str] = None,
                 confidence_for_unbounded: float = 0.9999995,
                 gp_kwargs: Optional[Dict[str, Any]] = None,
                 n_cobaya_init: int = 4,
                 n_sobol_init: int = 16,
                 init_train_x=None,
                 init_train_y=None,
                 resume: bool = False,
                 resume_file: Optional[str] = None,
                 save_dir: str = ".",
                 save: bool = True,
                 save_step: int = 5,
                 optimizer: str = "lbfgs",
                 acq: str = "WIPV",
                 use_clf: bool = False,
                 clf_type: str = "svm",
                 clf_nsigma_threshold: float = 20,
                 clf_use_size: int = 10,
                 clf_update_step: int = 1,
                 minus_inf: float = -1e10,
                 seed: Optional[int] = None,
                 verbosity: str = "INFO",
                 pool: Union[str, EvalPool] = "auto",
                 server: Optional[str] = None,
                 device=None):
        update_verbosity(verbosity)
        self.pool = make_pool(pool) if isinstance(pool, str) else pool
        self.is_main = self.pool.is_main_process
        # setup runs under close-on-exit: a failure on rank 0 must still
        # broadcast EXIT (pool.close() is idempotent) to the worker ranks
        # waiting in worker_loop
        try:
            self.loglikelihood = make_likelihood(
                loglikelihood, param_list, param_bounds, param_labels,
                likelihood_name, confidence_for_unbounded, minus_inf)
            self.ndim = len(self.loglikelihood.param_list)
            if not self.is_main:
                # a worker rank serves likelihood evaluations until rank 0
                # closes the pool; it never resolves or touches a device
                # (its card may be hidden)
                set_global_seed(seed)
                self.pool.worker_loop(self.loglikelihood)
                return
            self.device = config.resolve_device(device)
            self._setup_main_process(seed, optimizer, save, save_dir,
                                     save_step, n_cobaya_init, n_sobol_init,
                                     acq, use_clf, clf_type,
                                     clf_nsigma_threshold, minus_inf, resume)
            if resume:
                # without a file, a resume continues from this run's own
                # save path
                self._handle_resume(resume_file if resume_file is not None
                                    else self.save_path, use_clf)
            if self.fresh_start:
                train_x, train_y = self._get_initial_training_data(
                    n_cobaya_init, n_sobol_init, init_train_x, init_train_y)
                clf = ({"clf_type": clf_type, "clf_use_size": clf_use_size,
                        "clf_update_step": clf_update_step,
                        "clf_nsigma_threshold": clf_nsigma_threshold}
                       if use_clf else None)
                self._initialize_gp(train_x, train_y, optimizer,
                                    dict(gp_kwargs or {}), clf)
        except BaseException:
            self.pool.close()
            raise

        # best-point bookkeeping (a resumed run keeps the better of its
        # results' best value and the GP's)
        y_raw = self.gp.train_y_raw.cpu().numpy()
        idx = int(np.argmax(y_raw))
        self.best_pt = np.asarray(scale_from_unit(
            self.gp.train_x[idx].cpu().numpy(),
            self.loglikelihood.param_bounds)).reshape(-1)
        best_from_gp = float(y_raw[idx])
        if best_from_gp > getattr(self, "best_f", -np.inf):
            self.best_f = best_from_gp
        self.best = {n: f"{float(v):.6f}"
                     for n, v in zip(self.loglikelihood.param_list, self.best_pt)}
        log.info(f"Initial best point {self.best} with value = {self.best_f:.6f}")
        if self.save:
            self.gp.save(f"{self.save_path}_gp")
        self.prev_samples = None

    def _setup_main_process(self, seed, optimizer, save, save_dir, save_step,
                            n_cobaya_init, n_sobol_init, acq, use_clf,
                            clf_type, clf_nsigma_threshold, minus_inf,
                            resume):
        set_global_seed(seed)
        self.np_rng = get_numpy_rng()
        self.output_file = self.loglikelihood.name
        self.save, self.save_step, self.save_dir = save, save_step, save_dir
        if self.save:
            os.makedirs(self.save_dir, exist_ok=True)
        self.save_path = os.path.join(self.save_dir, self.output_file)
        self.optimizer = optimizer
        self.minus_inf = minus_inf
        self.results_manager = BOBEResults(
            output_file=self.output_file, save_dir=self.save_dir,
            param_names=self.loglikelihood.param_list,
            param_labels=self.loglikelihood.param_labels,
            param_bounds=self.loglikelihood.param_bounds,
            settings={"n_cobaya_init": n_cobaya_init,
                      "n_sobol_init": n_sobol_init, "acq": acq,
                      "use_clf": use_clf, "clf_type": clf_type,
                      "clf_nsigma_threshold": clf_nsigma_threshold,
                      "minus_inf": minus_inf, "seed": seed,
                      "device": str(self.device)},
            likelihood_name=self.loglikelihood.name,
            resume_from_existing=resume)
        self.fresh_start = not resume
        self.start_iteration = 0
        self.best_pt_iteration = 0
        self.prev_converged = False
        self.prev_convergence_delta = None

    def _handle_resume(self, resume_file, use_clf):
        """Load ``<resume_file>_gp.npz`` (either package's) and restore the
        start iteration, the best value and the earlier convergence from the
        run's results; on any error, log it and start fresh."""
        gp_file = resume_file + "_gp"
        try:
            log.info(f"Attempting to resume from {gp_file}")
            self.gp = load_gp_file(gp_file, use_clf, device=self.device)
            _ = self.gp.predict_mean_single(self.gp.train_x[0])
            log.info(f"Loaded GP with {self.gp.npoints} points")
            rm = self.results_manager
            if rm.is_resuming():
                self.start_iteration = rm.get_last_iteration()
                if rm.best_loglike_values:
                    self.best_f = max(rm.best_loglike_values)
                    i = rm.best_loglike_values.index(self.best_f)
                    self.best_pt_iteration = rm.best_loglike_iterations[i]
                if rm.converged and rm.convergence_history:
                    last = rm.convergence_history[-1]
                    self.prev_converged = True
                    self.prev_convergence_delta = last.delta
                    log.info(f"Previous run converged with "
                             f"delta={last.delta:.6f}")
            self.fresh_start = False
        except Exception as e:
            log.error(f"Failed to resume from {gp_file}: {e}; starting fresh")
            self.fresh_start = True

    # ------------------------------------------------------------------ init

    def _get_initial_training_data(self, n_cobaya_init, n_sobol_init,
                                   init_train_x=None, init_train_y=None):
        """Sobol points, then (for a Cobaya likelihood) ``n_cobaya_init``
        draws from its reference distribution, then the user's points;
        deduped, in the unit cube."""
        from scipy.stats import qmc

        if n_sobol_init + n_cobaya_init == 0:
            raise ValueError("Need n_sobol_init or n_cobaya_init > 0")
        n = max(2, n_sobol_init)
        self.results_manager.start_timing("True Objective Evaluations")
        unit = qmc.Sobol(d=self.ndim, scramble=True, rng=self.np_rng).random(n)
        pts = scale_from_unit(unit, self.loglikelihood.param_bounds)
        log.info(f"Evaluating {n} Sobol initial points")
        vals = np.asarray(self.pool.run_map_objective(
            self.loglikelihood, pts)).reshape(-1, 1)
        if self.loglikelihood.is_cobaya and n_cobaya_init > 0:
            log.info(f"Drawing {n_cobaya_init} Cobaya reference points")
            draws = self.pool.get_cobaya_initial_points(
                self.loglikelihood, n_cobaya_init, rng=self.np_rng)
            pts = np.vstack([pts, np.asarray([p for p, _ in draws])])
            vals = np.vstack([vals, np.asarray([[v] for _, v in draws])])
        if init_train_x is not None and init_train_y is not None:
            ix = np.atleast_2d(np.asarray(init_train_x))
            iy = np.atleast_2d(np.asarray(init_train_y)).reshape(-1, 1)
            if ix.shape[0] != iy.shape[0] or ix.shape[1] != self.ndim:
                raise ValueError("init_train_x/init_train_y shape mismatch")
            log.info(f"Adding {len(ix)} user-provided initial points")
            pts = np.vstack([pts, ix])
            vals = np.vstack([vals, iy])
        elif (init_train_x is None) != (init_train_y is None):
            raise ValueError("init_train_x and init_train_y must come together")
        uniq, idx = np.unique(pts, axis=0, return_index=True)
        if len(uniq) < len(pts):
            log.warning(f"Removed {len(pts) - len(uniq)} duplicate initial points")
            pts, vals = pts[np.sort(idx)], vals[np.sort(idx)]
        self.results_manager.end_timing("True Objective Evaluations")
        return (scale_to_unit(pts, self.loglikelihood.param_bounds),
                vals.reshape(-1))

    def _initialize_gp(self, train_x, train_y, optimizer, gp_kwargs,
                       clf=None):
        """The GP, or with ``clf`` (type, use size, update step, n-sigma
        threshold) the classifier-gated GP: its classifier separates points
        within the n-sigma threshold (at least 75) of the incumbent, its GP
        holds those within twice that."""
        gp_kwargs.update({"train_x": train_x, "train_y": train_y,
                          "param_names": self.loglikelihood.param_list,
                          "optimizer": optimizer, "device": self.device})
        if clf is not None:
            clf_threshold = max(75.0, get_threshold_for_nsigma(
                clf["clf_nsigma_threshold"], self.ndim))
            gp_kwargs.update({
                "clf_type": clf["clf_type"],
                "clf_use_size": clf["clf_use_size"],
                "clf_update_step": clf["clf_update_step"],
                "probability_threshold": 0.5, "minus_inf": self.minus_inf,
                "clf_threshold": clf_threshold,
                "gp_threshold": 2 * clf_threshold})
            self.gp = GPwithClassifier(**gp_kwargs)
        else:
            self.gp = GP(**gp_kwargs)
        self.results_manager.start_timing("GP Training")
        log.info(f"Hyperparameters before refit: {self.gp.hyperparams_dict()}")
        self.gp.fit(n_restarts=4, maxiter=500, rng=self.np_rng)
        log.info(f"Hyperparameters after refit: {self.gp.hyperparams_dict()}")
        self.results_manager.end_timing("GP Training")

    # --------------------------------------------------------------- helpers

    def update_gp(self, new_pts_u, new_vals, step=0, verbose=True):
        """Add data + adaptive refit schedule by training-set size."""
        self.results_manager.start_timing("GP Training")
        self.n_points_since_last_fit += new_pts_u.shape[0]
        n = self.gp.npoints
        if n < 200:
            refit_threshold, maxiter, n_restarts = min(2, self.fit_n_points), 300, 8
        elif n < 750:
            refit_threshold, maxiter, n_restarts = self.fit_n_points, 250, 4
        else:
            refit_threshold, maxiter, n_restarts = max(40, self.fit_n_points), 200, 4

        with trace.span("gp.update"):
            self.gp.update(new_pts_u, np.asarray(new_vals).reshape(-1))
            if self.n_points_since_last_fit >= refit_threshold:
                log.info(f"Refitting GP hyperparameters with "
                         f"{self.gp.npoints} points")
                self.gp.fit(n_restarts=n_restarts, maxiter=maxiter,
                            rng=self.np_rng)
                self.n_points_since_last_fit = 0
        self.results_manager.end_timing("GP Training")
        self.results_manager.update_gp_hyperparams(
            step, self.gp.lengthscales.tolist(), self.gp.kernel_variance)
        if isinstance(self.gp, GPwithClassifier):
            self.results_manager.start_timing("Classifier Training")
            self.gp.train_classifier()
            self.results_manager.end_timing("Classifier Training")

    def get_next_batch(self, acq_kwargs, n_batch, n_restarts, maxiter,
                       early_stop_patience, step, verbose=True):
        self.results_manager.start_timing("Acquisition Optimization")
        log.info(f"Optimizing acquisition '{self.acquisition.name}' "
                 f"for the next {n_batch} point(s)")
        with trace.span("acq.batch"):
            new_pts_u, acq_vals = self.acquisition.get_next_batch(
                gp=self.gp, n_batch=n_batch, acq_kwargs=acq_kwargs,
                n_restarts=n_restarts, maxiter=maxiter,
                early_stop_patience=early_stop_patience, rng=self.np_rng)
        self.results_manager.end_timing("Acquisition Optimization")
        acq_val = float(np.mean(acq_vals))
        if verbose:
            log.info(f"Mean acquisition value {acq_val:.4e} at new points")
        self.results_manager.update_acquisition(step, acq_val,
                                                self.acquisition.name)
        return np.atleast_2d(new_pts_u), np.asarray(acq_vals)

    def evaluate_likelihood(self, new_pts_u, step, verbose=True):
        new_pts_u = np.atleast_2d(np.asarray(new_pts_u))
        new_pts = scale_from_unit(new_pts_u, self.loglikelihood.param_bounds)
        self.results_manager.start_timing("True Objective Evaluations")
        new_vals = np.asarray(
            self.pool.run_map_objective(self.loglikelihood, new_pts)).reshape(-1)
        self.results_manager.end_timing("True Objective Evaluations")

        i_best = int(np.argmax(new_vals))
        if float(new_vals[i_best]) > self.best_f:
            self.best_f = float(new_vals[i_best])
            self.best_pt = np.asarray(new_pts[i_best]).reshape(-1)
            self.best = {n: f"{float(v):.6f}" for n, v in
                         zip(self.loglikelihood.param_list, self.best_pt)}
            self.best_pt_iteration = step
        log.info(f"Evaluated objective at {len(new_pts)} new points "
                 f"(best this batch: {new_vals[i_best]:.4f})")
        return new_vals

    def check_max_evals_and_gpsize(self, current_evals) -> bool:
        if current_evals >= self.max_evals:
            self.termination_reason = "Maximum evaluations reached"
            self.results_dict["termination_reason"] = self.termination_reason
            return True
        if self.gp.npoints >= self.max_gp_size:
            self.termination_reason = "Maximum GP size reached"
            self.results_dict["termination_reason"] = self.termination_reason
            return True
        return False

    def check_convergence_ei(self, step, acq_val) -> bool:
        val = np.asarray(acq_val, dtype=np.float64).reshape(-1)[-1]
        if self.acquisition.name.lower() == "ei":
            val = np.log(val + 1e-100)
        if val < self.ei_goal_log:
            self.convergence_counter += 1
            if self.convergence_counter >= self.convergence_n_iters:
                log.info(f"{self.acquisition.name} convergence achieved after "
                         f"{self.convergence_n_iters} successive iterations")
                return True
            log.info(f"{self.acquisition.name} convergence iteration "
                     f"{self.convergence_counter}/{self.convergence_n_iters}")
            return False
        self.convergence_counter = 0
        return False

    def check_convergence_logz(self, step, logz_dict, equal_samples,
                               equal_logl, verbose=True,
                               save_checkpoint=True) -> bool:
        delta = (logz_dict["upper"] - logz_dict["lower"]) / 2.0
        delta_crosscheck = logz_dict.get("std", np.inf)
        converged = delta < self.logz_threshold

        equal_samples = scale_from_unit(np.asarray(equal_samples),
                                        self.loglikelihood.param_bounds)
        if self.prev_samples is not None:
            prev = self.prev_samples["x"]
            kl = kl_divergence_gaussian(
                np.mean(prev, 0), np.atleast_2d(np.cov(prev, rowvar=False)),
                np.mean(equal_samples, 0),
                np.atleast_2d(np.cov(equal_samples, rowvar=False)))
            log.info(f"Successive KL: symmetric={kl.get('symmetric', 0):.4f}")
            self.results_manager.update_kl_divergences(step, kl)
        self.prev_samples = {"x": equal_samples, "logl": np.asarray(equal_logl)}

        log.info(f"Convergence check: delta = {delta:.4f}, step = {step}, "
                 f"threshold = {self.logz_threshold}")
        if converged:
            self.convergence_counter += 1
            if self.convergence_counter >= self.convergence_n_iters:
                log.info("LogZ convergence achieved")
            else:
                log.info(f"Convergence iteration "
                         f"{self.convergence_counter}/{self.convergence_n_iters}")
                converged = False
        else:
            self.convergence_counter = 0
        # the post-counter decision is what gets recorded
        self.results_manager.update_convergence(step, logz_dict, converged,
                                                self.logz_threshold)

        if (delta < self.min_delta_seen and delta_crosscheck < 1.0
                and save_checkpoint and self.save):
            self.min_delta_seen = delta
            ckpt = f"{self.output_file}_checkpoint"
            if not converged:
                self.results_manager.save_intermediate(gp=self.gp, filename=ckpt)
                # chains in physical coordinates (the NS dict is unit-cube)
                ckpt_samples = dict(self.ns_samples)
                ckpt_samples["x"] = scale_from_unit(
                    np.asarray(self.ns_samples["x"]),
                    self.loglikelihood.param_bounds)
                self.results_manager.save_chain_files(ckpt_samples,
                                                      filename=ckpt)
                if verbose:
                    log.info(f"New minimum delta {delta:.4f}; checkpoint saved")
        return converged

    def finalise_results(self):
        gp_info = {"gp_training_set_size": int(self.gp.npoints),
                   "gp_final_best_loglike": float(self.best_f)}
        if isinstance(self.gp, GPwithClassifier):
            gp_info.update({
                "classifier_used": bool(self.gp.use_clf),
                "classifier_type": str(self.gp.clf_type),
                "classifier_training_set_size": int(self.gp.clf_data_size),
                "classifier_use_threshold": int(self.gp.clf_use_size),
                "classifier_probability_threshold": float(
                    self.gp.probability_threshold)})
        else:
            gp_info.update({"classifier_used": False, "classifier_type": None,
                            "classifier_training_set_size": 0})
        logz_dict = self.results_dict.get("logz", {})
        if not logz_dict:
            log.warning("No logz information found; nested sampling never ran")
        if self.save:
            self.gp.save(f"{self.save_path}_gp")
        self.results_manager.finalize(
            samples_dict=self.samples_dict or {}, logz_dict=logz_dict,
            converged=self.converged, termination_reason=self.termination_reason,
            gp_info=gp_info, write=self.save)
        self.results_dict = {
            "gp": self.gp, "likelihood": self.loglikelihood,
            "results_manager": self.results_manager, "best_val": self.best_f,
            "best_pt": self.best_pt, "logz": logz_dict,
            "termination_reason": self.termination_reason,
            "samples": self.samples_dict}

    # -------------------------------------------------------------- main run

    def run(self, acq: Union[str, Tuple[str, ...]] = "wipstd",
            min_evals: int = 200, max_evals: int = 1500,
            max_gp_size: int = 1200, logz_threshold: float = 0.01,
            convergence_n_iters: int = 1, ei_goal: float = 1e-10,
            do_final_ns: bool = False, fit_n_points: int = 10,
            batch_size: int = 4, ns_n_points: int = 10,
            num_hmc_warmup: Optional[int] = None, num_hmc_samples: int = 512,
            mc_points_size: int = 64, thinning: Optional[int] = None,
            num_chains: Optional[int] = None,
            mc_points_method: str = "EHMC", zeta_ei: float = 0.01):
        if not self.is_main:
            return None
        acqs = [acq] if isinstance(acq, str) else list(acq)
        for a in acqs:
            if a.lower() not in _ACQ_FUNCS:
                raise ValueError(f"Invalid acquisition '{a}'; options: "
                                 f"{list(_ACQ_FUNCS)}")
        if mc_points_method not in _MC_METHODS:
            raise ValueError(f"Unknown MC sample method '{mc_points_method}'")
        try:
            self.min_evals, self.max_evals = min_evals, max_evals
            self.max_gp_size, self.logz_threshold = max_gp_size, logz_threshold
            self.samples_dict, self.results_dict = {}, {}

            # a resumed run that had converged below this threshold ends
            # here, with no likelihood call
            if self.prev_converged and self.prev_convergence_delta is not None:
                if self.prev_convergence_delta < logz_threshold:
                    log.info("Previous run already converged below the new "
                             "threshold; skipping the BO loop")
                    rm = self.results_manager
                    self.converged = True
                    self.termination_reason = \
                        "Already converged in previous run"
                    if rm.convergence_history:
                        self.results_dict["logz"] = dict(
                            rm.convergence_history[-1].logz_dict)
                    if rm.final_samples is not None:
                        self.samples_dict = {"x": rm.final_samples,
                                             "weights": rm.final_weights,
                                             "logl": rm.final_loglikes}
                    self.finalise_results()
                    return self.results_dict
                log.info("Previous run converged above the new threshold; "
                         "continuing")

            self.convergence_n_iters = convergence_n_iters
            self.ei_goal_log = np.log(ei_goal)
            self.zeta_ei = zeta_ei
            self.do_final_ns = do_final_ns
            self.fit_n_points, self.ns_n_points = fit_n_points, ns_n_points
            self.batch_size = batch_size
            # load balance: a batch of a multiple of the pool's size
            if self.pool.is_distributed \
                    and self.batch_size % self.pool.size != 0:
                self.batch_size = max(
                    (self.batch_size // self.pool.size) * self.pool.size,
                    self.pool.size)
                log.info(f"Adjusted batch_size to {self.batch_size} "
                         f"(multiple of {self.pool.size} pool processes)")
            self.n_points_since_last_fit = 0
            self.n_points_since_last_ns = 0
            self.num_hmc_warmup, self.num_hmc_samples = num_hmc_warmup, num_hmc_samples
            self.mc_points_size, self.hmc_thinning = mc_points_size, thinning
            self.hmc_num_chains, self.mc_points_method = num_chains, mc_points_method
            self.converged = False
            self.convergence_counter = 0
            self.min_delta_seen = np.inf
            self.termination_reason = "Max evaluation budget reached"
            self.results_manager.settings.update({
                "min_evals": min_evals, "max_evals": max_evals,
                "max_gp_size": max_gp_size, "logz_threshold": logz_threshold,
                "convergence_n_iters": convergence_n_iters, "ei_goal": ei_goal,
                "do_final_ns": do_final_ns, "fit_n_points": fit_n_points,
                "batch_size": self.batch_size, "ns_n_points": ns_n_points,
                "num_hmc_warmup": num_hmc_warmup,
                "num_hmc_samples": num_hmc_samples,
                "mc_points_size": mc_points_size, "thinning": thinning,
                "num_chains": num_chains, "mc_points_method": mc_points_method,
                "zeta_ei": zeta_ei})

            self.current_iteration = self.start_iteration
            for a in acqs:
                if a.lower() in ("wipv", "wipstd"):
                    self.run_weighted_integrated_posterior(
                        _ACQ_FUNCS[a.lower()], ii=self.current_iteration)
                else:
                    self.acquisition = _ACQ_FUNCS[a.lower()](
                        optimizer=self.optimizer)
                    self.run_EI(ii=self.current_iteration)

            log.info(f"Final best point {self.best} with value = "
                     f"{self.best_f:.6f} (iteration {self.best_pt_iteration})")
            log.info(f"Sampling stopped: {self.termination_reason}")
            self.finalise_results()
            return self.results_dict
        finally:
            self.pool.close()

    # ----------------------------------------------------------------- loops

    def run_EI(self, ii: int = 0):
        """The EI/LogEI loop: one point per iteration (50 restarts), the GP
        updated, until the acquisition goal (check_convergence_ei), the
        evaluation budget or the GP size ends it."""
        current_evals = self.gp.npoints
        self.convergence_counter = 0  # successive checks count per phase
        converged = False
        while not converged:
            ii += 1
            log.info(f"Iteration {ii} of {self.acquisition.name}, "
                     f"objective evals {current_evals}/{self.max_evals}")
            best_y = (float(torch.max(self.gp.train_y))
                      if self.gp.gp_size else 0.0)
            acq_kwargs = {"zeta": self.zeta_ei, "best_y": best_y}
            new_pts_u, acq_vals = self.get_next_batch(
                acq_kwargs, n_batch=1, n_restarts=50, maxiter=300,
                early_stop_patience=50, step=ii)
            new_vals = self.evaluate_likelihood(new_pts_u, ii)
            current_evals += 1
            self.update_gp(new_pts_u, new_vals, step=ii)
            self.results_manager.update_best_loglike(ii, self.best_f)
            converged = self.check_convergence_ei(ii, acq_vals)
            if self.save and ii % self.save_step == 0:
                self.results_manager.save_intermediate(gp=self.gp)
            if converged:
                self.termination_reason = \
                    f"{self.acquisition.name.upper()} goal reached"
                self.results_dict["termination_reason"] = \
                    self.termination_reason
                break
            if self.check_max_evals_and_gpsize(current_evals):
                break
        self.current_iteration = ii

    def _ns_boost(self, dlogz_s: float, lo: int) -> int:
        """nlive multiplier (as a count of merged base-nlive runs) that
        brings the NS sampler noise down to half the logz threshold: noise
        scales ~ 1/sqrt(nlive), so the factor is the squared noise/target
        ratio, clipped to [lo, ns_boost_cap()]. An unknown noise level
        (dlogz_s <= 0) gets 2."""
        if dlogz_s <= 0:
            return 2
        return int(np.clip(np.ceil((2.0 * dlogz_s / self.logz_threshold) ** 2),
                           lo, max(lo, ns_boost_cap())))

    def _refresh_mc_samples(self, np_rng=None, generator=None,
                            phase: str = "MCMC Sampling"):
        # the overlapped caller passes its own phase name: that span runs
        # concurrently with "True Objective Evaluations" and must not count
        # toward the additive main-thread wall time
        self.results_manager.start_timing(phase)
        try:
            with trace.span("mc.refresh", sync=True):
                self.mc_samples = get_mc_samples(
                    self.gp, warmup_steps=self.num_hmc_warmup,
                    num_samples=self.num_hmc_samples,
                    thinning=self.hmc_thinning,
                    num_chains=self.hmc_num_chains,
                    np_rng=np_rng if np_rng is not None else self.np_rng,
                    generator=(generator if generator is not None
                               else new_torch_generator(self.device)),
                    method=self.mc_points_method,
                    warm_state=getattr(self, "_nuts_warm", None))
            # the adapted EHMC/NUTS kernel: the next refresh re-warms from
            # it (a short fixed-mass step-size re-adaptation) instead of a
            # full warmup against a barely changed surrogate posterior
            self._nuts_warm = self.mc_samples.get("warm_state")
        finally:
            self.results_manager.end_timing(phase)

    def _start_refresh_async(self):
        """Launch the MC-pool refresh on a thread so its device work overlaps
        the host-side likelihood batch. The thread gets a torch generator
        seeded now, on the main thread (a deterministic position in the seed
        chain), and a spawned child numpy Generator, so no generator is ever
        shared between threads. Joined before update_gp, so the thread only
        reads the pre-batch GP state."""
        gen = new_torch_generator(self.device)
        child_rng = self.np_rng.spawn(1)[0]
        holder = {}
        request = trace.current_request()

        def _run():
            # the refresh's spans carry the iteration that started it
            trace.adopt(request)
            try:
                self._refresh_mc_samples(np_rng=child_rng, generator=gen,
                                         phase="MCMC Sampling (overlapped)")
            except Exception as e:  # re-run synchronously on join
                holder["error"] = e

        t = threading.Thread(target=_run, name="bobe-refresh", daemon=True)
        t.start()
        holder["thread"] = t
        return holder

    def _join_refresh(self, holder):
        self.results_manager.start_timing("MCMC Join Wait")
        with trace.span("mc.join_wait"):
            holder["thread"].join()
        self.results_manager.end_timing("MCMC Join Wait")
        if "error" in holder:
            log.warning(f"async MC refresh failed ({holder['error']!r}); "
                        "re-running synchronously")
            self._refresh_mc_samples()

    def run_weighted_integrated_posterior(self, acq_func_class, ii: int = 0):
        if self.converged:
            log.info(f"Skipping {acq_func_class.name}: already converged")
            return
        self.acquisition = acq_func_class(optimizer=self.optimizer)
        acq_name = self.acquisition.name
        current_evals = self.gp.npoints
        # convergence_n_iters successive checks are required per phase
        self.convergence_counter = 0
        self._refresh_mc_samples()
        self.ns_samples = None
        ns_success = False
        logz_keys = ["mean", "upper", "lower", "dlogz_sampler", "err_total"]

        while not self.converged:
            ii += 1
            with trace.span("bo.iteration", request=ii):
                self.n_points_since_last_ns += self.batch_size
                ns_flag = (self.n_points_since_last_ns >= self.ns_n_points
                           and current_evals >= self.min_evals)
                log.info(f"Iteration {ii} of {acq_name}, objective evals "
                         f"{current_evals}/{self.max_evals}")

                acq_kwargs = {"mc_samples": self.mc_samples,
                              "mc_points_size": self.mc_points_size}
                new_pts_u, acq_vals = self.get_next_batch(
                    acq_kwargs, n_batch=self.batch_size, n_restarts=1,
                    maxiter=100, early_stop_patience=10, step=ii)
                # the MC-pool refresh runs concurrently with the likelihood
                # batch; NS iterations must sample the post-update
                # surrogate, so they never overlap the refresh
                will_ns = ns_flag and (acq_vals[-1] <= self.logz_threshold)
                refresh_job = None if will_ns else self._start_refresh_async()
                new_vals = self.evaluate_likelihood(new_pts_u, ii)
                if refresh_job is not None:
                    self._join_refresh(refresh_job)
                current_evals += self.batch_size
                self.update_gp(new_pts_u, new_vals, step=ii)
                self.results_manager.update_best_loglike(ii, self.best_f)

                if will_ns:
                    self.results_manager.start_timing("Nested Sampling")
                    ns_samples, logz_dict, ns_success = nested_sampling(
                        gp=self.gp, mode="convergence", dlogz=0.01,
                        equal_weights=False, rng=self.np_rng)
                    self.results_manager.end_timing("Nested Sampling")
                    logz_str = ", ".join(f"{k}={logz_dict[k]:.4f}"
                                         for k in logz_keys if k in logz_dict)
                    log.info(f"NS success = {ns_success}, "
                             f"LogZ info: {logz_str}")
                    self.ns_samples = ns_samples
                    if ns_success:
                        eq_x, eq_l = resample_equal(
                            ns_samples["x"], ns_samples["logl"],
                            weights=ns_samples["weights"], rng=self.np_rng)
                        self.mc_samples = {"x": eq_x, "logl": eq_l,
                                           "weights": np.ones(eq_x.shape[0]),
                                           "method": "NS",
                                           "best": ns_samples["best"]}
                        self.results_dict["logz"] = logz_dict
                        self.converged = self.check_convergence_logz(
                            ii, logz_dict, eq_x, eq_l)
                        if self.converged:
                            self.termination_reason = "LogZ converged"
                            self.results_dict["termination_reason"] = \
                                self.termination_reason
                    self.n_points_since_last_ns = 0

                log.info(f"Current best point {self.best} with value = "
                         f"{self.best_f:.6f} "
                         f"(iteration {self.best_pt_iteration})")
                if self.save and ii % self.save_step == 0:
                    self.results_manager.save_intermediate(gp=self.gp)
                if self.converged:
                    break
                if self.check_max_evals_and_gpsize(current_evals):
                    break

        self.current_iteration = ii

        if self.converged and ns_success:
            # final-precision NS: re-run at the same settings until the
            # sampler noise is at half the threshold, merged at the
            # dead-point level with the convergence run (same GP state)
            dlogz_s = float(self.results_dict.get("logz", {}).get(
                "dlogz_sampler", 0.0))
            if dlogz_s > self.logz_threshold:
                boost = self._ns_boost(dlogz_s, lo=2)
                log.info(f"Final-precision NS: {boost} extra base-nlive runs "
                         f"merged (sampler noise {dlogz_s:.3f} "
                         f"> threshold {self.logz_threshold})")
                prior_raw = (self.ns_samples or {}).get("raw")
                self.results_manager.start_timing("Nested Sampling")
                ns_samples, logz_dict, ok = nested_sampling(
                    gp=self.gp, mode="convergence", dlogz=0.01,
                    n_runs=boost,
                    merge_with=[prior_raw] if prior_raw is not None else None,
                    equal_weights=False, rng=self.np_rng)
                self.results_manager.end_timing("Nested Sampling")
                if ok:
                    self.ns_samples = ns_samples
                    self.results_dict["logz"] = logz_dict
                    log.info("Final-precision LogZ: " + ", ".join(
                        f"{k}={logz_dict[k]:.4f}"
                        for k in logz_keys if k in logz_dict))

        if self.do_final_ns and not self.converged:
            ns_success = self._final_dynamic_ns(ii, logz_keys) or ns_success

        if self.ns_samples is not None and ns_success:
            samples = self.ns_samples["x"]
            weights = self.ns_samples["weights"]
            loglikes = self.ns_samples["logl"]
        else:
            log.info("No successful NS results; falling back to NUTS samples")
            self.results_manager.start_timing("MCMC Sampling")
            mc = get_mc_samples(self.gp, method="NUTS",
                                num_chains=FINAL_NUTS["num_chains"],
                                warmup_steps=FINAL_NUTS["warmup_steps"],
                                num_samples=(FINAL_NUTS["samples_per_dim"]
                                             * self.ndim),
                                thinning=FINAL_NUTS["thinning"],
                                np_rng=self.np_rng,
                                generator=new_torch_generator(self.device))
            self.results_manager.end_timing("MCMC Sampling")
            samples, loglikes = mc["x"], mc["logp"]
            weights = np.ones(samples.shape[0])
        self.samples_dict = {
            "x": scale_from_unit(np.asarray(samples),
                                 self.loglikelihood.param_bounds),
            "weights": np.asarray(weights), "logl": np.asarray(loglikes)}

    def _final_dynamic_ns(self, ii: int, logz_keys) -> bool:
        """The final pass of a run that did not converge: a final fit, then
        a dynamic NS of ``_ns_boost`` merged runs (from the last convergence
        NS's sampler noise), topped up with static runs merged at the
        dead-point level until the measured noise reaches half the
        threshold (at most ns_boost_cap() runs in all). Adopted only on
        success, so a failed final pass keeps an earlier NS. Returns its
        success."""
        self.results_manager.start_timing("GP Training")
        self.gp.fit(n_restarts=4, maxiter=500, rng=self.np_rng)
        self.results_manager.end_timing("GP Training")
        log.info("Final Nested Sampling")
        self.results_manager.start_timing("Nested Sampling")
        dlogz_s = float(self.results_dict.get("logz", {}).get(
            "dlogz_sampler", 0.0))
        boost = self._ns_boost(dlogz_s, lo=1)
        final_samples, logz_dict, final_ok = nested_sampling(
            gp=self.gp, mode="convergence", dlogz=0.01, n_runs=boost,
            dynamic=True, rng=self.np_rng)
        if final_ok:
            # the final run measures its own noise: after b1 runs it is s1,
            # and threshold/2 needs b1 * ceil((2 s1 / threshold)^2) runs
            measured = float(logz_dict.get("dlogz_sampler", 0.0))
            want = min(boost * self._ns_boost(measured, lo=1),
                       max(boost, ns_boost_cap()))
            if want > boost and measured > self.logz_threshold / 2.0:
                log.info(f"Final NS top-up: {want - boost} more runs "
                         f"(measured sampler noise {measured:.3f} > "
                         f"threshold/2 = {self.logz_threshold / 2:.3f})")
                raw = final_samples.get("raw")
                top_samples, top_logz, top_ok = nested_sampling(
                    gp=self.gp, mode="convergence", dlogz=0.01,
                    n_runs=want - boost,
                    merge_with=[raw] if raw is not None else None,
                    dynamic=False, rng=self.np_rng)
                if top_ok:
                    final_samples, logz_dict = top_samples, top_logz
                    remeasured = float(top_logz.get("dlogz_sampler",
                                                    measured))
                    if remeasured > self.logz_threshold / 2.0:
                        log.info(
                            f"Final NS top-up: merged sampler noise "
                            f"{remeasured:.3f} still above threshold/2 = "
                            f"{self.logz_threshold / 2:.3f} (merge cap "
                            f"{ns_boost_cap()}); err_total carries it")
        self.results_manager.end_timing("Nested Sampling")
        log.info("Final LogZ: " + ", ".join(
            f"{k}={logz_dict[k]:.4f}" for k in logz_keys if k in logz_dict))
        if not final_ok:
            return False
        self.ns_samples = final_samples
        eq_x, eq_l = resample_equal(
            final_samples["x"], final_samples["logl"],
            weights=final_samples["weights"], rng=self.np_rng)
        self.converged = self.check_convergence_logz(
            ii + 1, logz_dict, eq_x, eq_l, save_checkpoint=False)
        self.results_dict["logz"] = logz_dict
        if self.converged:
            self.termination_reason = "LogZ converged"
            self.results_dict["termination_reason"] = self.termination_reason
        return True

    def run_WIPStd(self, ii: int = 0):
        return self.run_weighted_integrated_posterior(WIPStd, ii)

    def run_WIPV(self, ii: int = 0):
        return self.run_weighted_integrated_posterior(WIPV, ii)
