"""Likelihood adapter: wraps a user callable for safe, host-side scalar
evaluation (copied from bobe_tpu/likelihood.py).

Exceptions / NaN / Inf collapse to ``minus_inf`` (failed regions are data,
not errors) and bounds are validated as (2, d). The Cobaya adapter is not
ported yet.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from . import config
from .utils.log import get_logger

log = get_logger("likelihood")


class Likelihood:
    """Safe wrapper around a user log-likelihood callable.

    Parameters: loglikelihood(x: (d,) ndarray) -> float; param_list names;
    param_bounds (2, d); minus_inf floor for failed evaluations.
    """

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
    """Cobaya-model adapter (not ported yet)."""

    def __init__(self, *args, **kwargs):
        raise config.not_ported("The Cobaya likelihood adapter", "cobaya")
