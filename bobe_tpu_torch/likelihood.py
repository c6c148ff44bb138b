"""Likelihood adapters: wrap user callables and Cobaya models for safe,
host-side scalar evaluation (counterpart of bobe_tpu/likelihood.py).

Exceptions / NaN / Inf collapse to ``minus_inf`` (failed regions are data,
not errors), bounds are validated as (2, d), and Cobaya log-posteriors get
the log-prior-volume shift so logZ matches Cobaya's normalization. Cobaya
itself is an optional dependency, imported when a ``CobayaLikelihood`` is
built.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

from .utils.log import get_logger

log = get_logger("likelihood")


class Likelihood:
    """Safe wrapper around a user log-likelihood callable.

    Parameters: loglikelihood(x: (d,) ndarray) -> float; param_list names;
    param_bounds (2, d); minus_inf floor for failed evaluations.
    """

    # BOBE draws n_cobaya_init initial points from the reference
    # distribution of a Cobaya likelihood; a device server's stand-in for a
    # client's Cobaya likelihood sets this on its instance
    is_cobaya = False

    def __init__(self, loglikelihood: Callable,
                 param_list: Optional[List[str]],
                 param_labels: Optional[List[str]] = None,
                 param_bounds=None,
                 name: Optional[str] = None,
                 minus_inf: float = -1e10):
        self.logl = loglikelihood
        if param_list is None or not all(isinstance(p, str) for p in param_list):
            raise ValueError("param_list must be a list of parameter-name strings")
        self.param_list = list(param_list)
        self.ndim = len(self.param_list)
        self.param_labels = (list(param_labels) if param_labels is not None
                             else [f"x_{{{i+1}}}" for i in range(self.ndim)])
        if param_bounds is None:
            log.warning("No param_bounds provided; assuming the unit cube.")
            self.param_bounds = np.array([[0.0, 1.0]] * self.ndim).T
        else:
            param_bounds = np.asarray(param_bounds, dtype=np.float64)
            if param_bounds.shape != (2, self.ndim):
                raise ValueError(
                    f"param_bounds must have shape (2, {self.ndim}); got {param_bounds.shape}")
            self.param_bounds = param_bounds
        self.name = name or "loglikelihood"
        self.minus_inf = float(minus_inf)
        # sum-of-logs, NOT log-of-product: ~30 dims of 1e10-wide (or 1e-9-
        # wide) ranges overflow/underflow the product to inf/0 and poison
        # every evaluation with the +/-inf shift
        self.logprior_vol = float(
            np.sum(np.log(self.param_bounds[1] - self.param_bounds[0])))
        log.info(f"Initialized likelihood '{self.name}' with {self.ndim} params; "
                 f"log prior volume = {self.logprior_vol:.4f}")

    def _safe_eval(self, x: np.ndarray) -> float:
        try:
            val = float(self.logl(x))
        except Exception:
            log.debug(f"Likelihood evaluation failed at {x}", exc_info=True)
            return self.minus_inf
        if np.isnan(val) or np.isinf(val) or val < self.minus_inf:
            return self.minus_inf
        return val

    def __call__(self, X) -> float:
        """Evaluate at a single point (batching is the pool's job)."""
        X = np.atleast_1d(np.asarray(X, dtype=np.float64))
        if X.ndim > 1:
            if X.shape[0] != 1:
                raise ValueError("__call__ expects a single point; use the "
                                 "evaluation pool for batches")
            X = X.reshape(-1)
        if X.shape[0] != self.ndim:
            raise ValueError(f"Input shape {X.shape} does not match ndim {self.ndim}")
        return self._safe_eval(X)


class CobayaLikelihood(Likelihood):
    """Cobaya-model adapter (optional dependency).

    Builds the model from a YAML path, YAML text or info dict, pulls the
    sampled-parameter names, bounds (with ``confidence_for_unbounded``) and
    LaTeX labels, and adds the log-prior volume to each log-posterior
    evaluation so evidences are normalized the way Cobaya reports them.

    The adapter pickles as its info dict and settings, never as its model: a
    Cobaya ``Model`` holds theory codes that do not pickle. Unpickling (in a
    pool worker) builds the worker's own model with ``get_model(info)``, as
    each MPI rank of the original BOBE does, so ``cobaya`` (or whatever
    module stands in for it) must be importable there.
    """

    is_cobaya = True

    def __init__(self, input_file_dict: Union[str, Dict[str, Any]],
                 confidence_for_unbounded: float = 0.9999995,
                 minus_inf: float = -1e10,
                 name: str = "CobayaLikelihood"):
        try:
            from cobaya.model import get_model
            from cobaya.yaml import yaml_load
        except ImportError as e:
            raise ImportError(
                "cobaya is required for CobayaLikelihood; install it, or "
                "provide a plain callable instead.") from e

        if isinstance(input_file_dict, str):
            # a YAML file path as well as YAML text: a path fed to yaml_load
            # parses as a bare string and fails with a confusing schema error
            if os.path.isfile(input_file_dict):
                with open(input_file_dict) as f:
                    info = yaml_load(f.read())
            else:
                info = yaml_load(input_file_dict)
        else:
            info = input_file_dict
        model = get_model(info)
        param_list = list(model.parameterization.sampled_params())
        bounds = np.asarray(model.prior.bounds(
            confidence_for_unbounded=confidence_for_unbounded)).T
        labels = [model.parameterization.labels()[k] for k in param_list]

        self.cobaya_model = model
        self._info = info
        self._confidence_for_unbounded = confidence_for_unbounded
        super().__init__(
            loglikelihood=self._logpost, param_list=param_list,
            param_labels=labels, param_bounds=bounds, name=name,
            minus_inf=minus_inf)

    def _logpost(self, x) -> float:
        return self.cobaya_model.logpost(x, make_finite=False)

    def __reduce__(self):
        return (type(self), (self._info, self._confidence_for_unbounded,
                             self.minus_inf, self.name))

    def __call__(self, X) -> float:
        val = super().__call__(X)
        if val <= self.minus_inf:
            val = self.minus_inf
        return val + self.logprior_vol

    def _get_single_valid_point(self, rng: np.random.Generator):
        """One valid point from the Cobaya reference distribution and its
        shifted log-posterior (run on the pool's workers).

        ``logposterior_as_dict`` arrived in cobaya 3.2; older models reject
        the keyword and return a LogPosterior namedtuple with a ``.logpost``
        attribute (some 3.1.x releases a dict) instead. Both surfaces are
        read."""
        try:
            pt, res = self.cobaya_model.get_valid_point(
                max_tries=1000, ignore_fixed_ref=False,
                logposterior_as_dict=True, random_state=rng)
            lp = res["logpost"]
        except TypeError:
            pt, res = self.cobaya_model.get_valid_point(
                max_tries=1000, ignore_fixed_ref=False, random_state=rng)
            lp = res["logpost"] if isinstance(res, dict) else res.logpost
        if lp < self.minus_inf:
            lp = self.minus_inf
        return pt, lp + self.logprior_vol


def make_likelihood(loglikelihood, param_list=None, param_bounds=None,
                    param_labels=None, likelihood_name=None,
                    confidence_for_unbounded: float = 0.9999995,
                    minus_inf: float = -1e10) -> Likelihood:
    """BOBE's likelihood argument as a ``Likelihood``: an instance as it is,
    a Cobaya YAML path, YAML text or info dict as a ``CobayaLikelihood``, a
    callable wrapped with the given names, bounds and labels."""
    if isinstance(loglikelihood, Likelihood):
        return loglikelihood
    if isinstance(loglikelihood, (str, dict)):
        return CobayaLikelihood(
            input_file_dict=loglikelihood,
            confidence_for_unbounded=confidence_for_unbounded,
            minus_inf=minus_inf,
            name=likelihood_name or "CobayaLikelihood")
    if callable(loglikelihood):
        return Likelihood(loglikelihood=loglikelihood, param_list=param_list,
                          param_bounds=param_bounds, param_labels=param_labels,
                          name=likelihood_name, minus_inf=minus_inf)
    raise ValueError("loglikelihood must be a callable, Cobaya YAML path, "
                     "Cobaya info dict, or Likelihood instance")
