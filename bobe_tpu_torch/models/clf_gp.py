"""Classifier-gated GP surrogate.

Counterpart of ``bobe_tpu/models/clf_gp.py``: the full dataset (the
``minus_inf`` failures included) trains a feasibility classifier; the GP
itself holds only the points within ``gp_threshold`` of the incumbent; a
prediction where the classifier says infeasible is ``minus_inf`` (mean) or
the noise floor (variance).

* ``npoints`` is the classifier-set size, ``gp_size`` the GP's row count.
* The classifier's parameters are ``_clf_ctx``, read by the samplers to gate
  the GP mean in their loops.
* An update that only appends extends the Cholesky factor; an update that
  moves the GP-subset cut (a better incumbent drops rows) rebuilds the GP
  with the fitted hyperparameters kept.
* ``state_dict`` is the JAX package's layout, so a state saved by either
  package loads in the other.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..utils import trace
from ..utils.core import get_threshold_for_nsigma
from ..utils.log import get_logger
from ..utils.seed import get_numpy_rng
from .classifiers import (CLASSIFIER_REGISTRY, params_to_device,
                          params_to_numpy, predict_proba_apply)
from .gp import (DEDUP_ATOL, DEDUP_RTOL, GP, SAFE_NOISE_FLOOR,
                 _restore_fit_basins, _restore_warp, refresh)

log = get_logger("clf_gp")


def _item(v):
    return v.item() if isinstance(v, np.ndarray) and v.shape == () else v


class GPwithClassifier(GP):
    def __init__(self, train_x=None, train_y=None,
                 clf_type: str = "svm", clf_settings: Optional[Dict] = None,
                 clf_use_size: int = 10, clf_update_step: int = 1,
                 probability_threshold: float = 0.5, minus_inf: float = -1e5,
                 clf_threshold: float = 250.0, gp_threshold: float = 500.0,
                 train_clf_on_init: bool = True,
                 **gp_kwargs):
        if train_x is None or train_y is None:
            raise ValueError("GPwithClassifier requires train_x and train_y "
                             "(the classifier needs labeled data)")
        if isinstance(train_x, torch.Tensor):
            train_x = train_x.detach().cpu().numpy()
        if isinstance(train_y, torch.Tensor):
            train_y = train_y.detach().cpu().numpy()
        self.train_x_clf = np.atleast_2d(np.asarray(train_x, dtype=np.float64))
        self.train_y_clf = np.asarray(train_y, dtype=np.float64).reshape(-1)
        self.clf_type = clf_type.lower()
        if self.clf_type not in CLASSIFIER_REGISTRY:
            raise ValueError(f"Unsupported classifier type: {self.clf_type}")
        self.clf_settings = dict(clf_settings or {})
        self.clf_use_size = int(clf_use_size)
        self.clf_update_step = int(clf_update_step)
        self.probability_threshold = float(probability_threshold)
        self.minus_inf = float(minus_inf)
        self.clf_threshold = float(clf_threshold)
        self.gp_threshold = float(gp_threshold)
        self.clf_params = None
        self.clf_metrics: Dict[str, Any] = {}

        gp_kwargs.setdefault("lengthscale_prior", "DSLP")
        x_gp, y_gp = self._filter_gp_subset()
        super().__init__(train_x=x_gp, train_y=y_gp, **gp_kwargs)

        self.use_clf = self.clf_data_size >= self.clf_use_size
        if self.use_clf and train_clf_on_init:
            self.train_classifier()

    # ------------------------------------------------------------- dataset

    def _filter_gp_subset(self):
        if self.train_y_clf.size == 0:
            return self.train_x_clf, self.train_y_clf
        mask = self.train_y_clf > (self.train_y_clf.max() - self.gp_threshold)
        return self.train_x_clf[mask], self.train_y_clf[mask]

    @property
    def clf_data_size(self) -> int:
        return self.train_x_clf.shape[0]

    @property
    def npoints(self) -> int:
        """The whole dataset's size (the classifier set); ``gp_size`` is the
        GP's row count."""
        return self.clf_data_size

    @property
    def _clf_ctx(self):
        """The classifier's parameters when it gates, else None."""
        if self.use_clf and self.clf_params is not None:
            return self.clf_params
        return None

    # ----------------------------------------------------------- classifier

    def train_classifier(self):
        if not self.use_clf and self.clf_data_size >= self.clf_use_size:
            log.info(f"Classifier data size ({self.clf_data_size}) reached "
                     f"use size ({self.clf_use_size}); enabling classifier.")
            self.use_clf = True
        if self.use_clf:
            with trace.span("clf.train"):
                self._train_classifier()

    def _train_classifier(self):
        labels = np.where(
            self.train_y_clf < self.train_y_clf.max() - self.clf_threshold, 0, 1)
        if np.all(labels == labels[0]):
            log.debug("All classifier labels identical; disabling for now")
            self.use_clf = False
            return
        best_pt = self.train_x_clf[int(np.argmax(self.train_y_clf))]
        train_fn = CLASSIFIER_REGISTRY[self.clf_type]["train_fn"]
        params, metrics, _ = train_fn(
            self.train_x_clf, labels, self.clf_settings,
            init_params=self.clf_params, best_pt=best_pt, device=self.device)
        if params is None:
            # nothing usable (every restart diverged with no warm start):
            # keep the previous classifier rather than drop the gate
            log.warning("classifier training failed; keeping previous "
                        f"classifier ({'none' if self.clf_params is None else 'active'})")
            return
        self.clf_params, self.clf_metrics = params, metrics
        log.debug(f"Trained {self.clf_type} classifier on {self.clf_data_size} "
                  f"points: {self.clf_metrics}")

    def _gate(self, x):
        """Classifier probabilities for a batch (chunked like the GP
        predicts), or None when the classifier does not gate."""
        if self._clf_ctx is None:
            return None
        proba = predict_proba_apply(self.clf_type)
        return self._map_chunked(lambda xe: proba(self.clf_params, xe), x)

    def gated(self, p, value, fill):
        """``value`` where the classifier probability ``p`` passes the
        threshold, else ``fill``."""
        return torch.where(p >= self.probability_threshold, value,
                           torch.full_like(value, fill))

    # ------------------------------------------------------------ prediction

    def predict_mean_batched(self, x):
        x = self._as_points(x)
        mean = super().predict_mean_batched(x)
        p = self._gate(x)
        return mean if p is None else self.gated(p, mean, self.minus_inf)

    def predict_var_batched(self, x):
        x = self._as_points(x)
        var = super().predict_var_batched(x)
        p = self._gate(x)
        return var if p is None else self.gated(p, var, SAFE_NOISE_FLOOR)

    def predict_batched(self, x):
        x = self._as_points(x)
        mean, var = super().predict_batched(x)
        p = self._gate(x)
        if p is None:
            return mean, var
        return (self.gated(p, mean, self.minus_inf),
                self.gated(p, var, SAFE_NOISE_FLOOR))

    def predict_mean_with_params(self, log_params, x):
        # the alternate-basin evidence must see the same gate as the mean
        x = self._as_points(x)
        mean = super().predict_mean_with_params(log_params, x)
        p = self._gate(x)
        return mean if p is None else self.gated(p, mean, self.minus_inf)

    # --------------------------------------------------------------- updates

    def update(self, new_x, new_y):
        if isinstance(new_x, torch.Tensor):
            new_x = new_x.detach().cpu().numpy()
        if isinstance(new_y, torch.Tensor):
            new_y = new_y.detach().cpu().numpy()
        new_x = np.atleast_2d(np.asarray(new_x, dtype=np.float64))
        new_y = np.asarray(new_y, dtype=np.float64).reshape(-1)

        keep = []
        for i in range(new_x.shape[0]):
            # against the dataset and the rows of this batch kept so far,
            # at the GP-level dedup tolerances
            prior = (np.vstack([self.train_x_clf, new_x[keep]])
                     if keep else self.train_x_clf)
            dup = np.any(np.all(np.isclose(prior, new_x[i],
                                           atol=DEDUP_ATOL, rtol=DEDUP_RTOL),
                                axis=1))
            if dup:
                log.debug(f"Point {new_x[i]} already in dataset; skipping")
            else:
                keep.append(i)
        if not keep:
            return
        new_x, new_y = new_x[keep], new_y[keep]

        old_max = self.train_y_clf.max() if self.train_y_clf.size else -np.inf
        self.train_x_clf = np.vstack([self.train_x_clf, new_x])
        self.train_y_clf = np.concatenate([self.train_y_clf, new_y])

        new_max = self.train_y_clf.max()
        cutoff_old = old_max - self.gp_threshold
        cutoff_new = new_max - self.gp_threshold
        membership_changed = cutoff_new > cutoff_old and np.any(
            (self.train_y_clf[:-len(new_y)] <= cutoff_new)
            & (self.train_y_clf[:-len(new_y)] > cutoff_old))

        add_mask = new_y > cutoff_new
        if membership_changed:
            x_gp, y_gp = self._filter_gp_subset()
            self._rebuild(x_gp, y_gp)
            log.debug(f"GP subset rebuilt: clf size {self.clf_data_size}, "
                      f"gp size {self.gp_size}")
        elif np.any(add_mask):
            super().update(new_x[add_mask], new_y[add_mask])

    def _rebuild(self, x_gp, y_gp):
        """A fresh GP on the new subset with the fitted hyperparameters (its
        capacity and identity pad block follow the new row count)."""
        fresh = GP(train_x=x_gp, train_y=y_gp,
                   noise=self.cfg.noise, kernel=self.cfg.kernel,
                   optimizer=self.optimizer_method,
                   lengthscales=self.lengthscales.cpu().numpy(),
                   kernel_variance=self.kernel_variance,
                   lengthscale_bounds=self.cfg.lengthscale_bounds,
                   kernel_variance_bounds=self.cfg.kernel_variance_bounds,
                   kernel_variance_prior=self.cfg.kernel_variance_prior,
                   lengthscale_prior=self.cfg.lengthscale_prior,
                   tausq=self.tausq, tausq_bounds=self.cfg.tausq_bounds,
                   param_names=self.param_names,
                   input_warp=self.cfg.input_warp,
                   warp_bounds=self.cfg.warp_bounds, device=self.device)
        if self.cfg.input_warp:
            # carry the learned warp across the rebuild (a fresh GP starts
            # at the identity) and refactorize in warp space
            fresh.state = refresh(fresh.state._replace(
                log_wa=self.state.log_wa, log_wb=self.state.log_wb),
                fresh.cfg)
        self.state = fresh.state

    # -------------------------------------------------------- random points

    def get_random_point(self, rng=None, nstd=None):
        """A dataset point within a threshold of the incumbent (``nstd``
        sigma, else ``clf_threshold``) while the classifier gates."""
        rng = rng if rng is not None else get_numpy_rng()
        if not self.use_clf:
            return super().get_random_point(rng=rng, nstd=nstd)
        threshold = (get_threshold_for_nsigma(nstd, self.ndim)
                     if nstd is not None else self.clf_threshold)
        valid = np.where(self.train_y_clf > self.train_y_clf.max() - threshold)[0]
        if valid.size == 0:
            return super().get_random_point(rng=rng, nstd=nstd)
        return self.train_x_clf[rng.choice(valid)]

    # --------------------------------------------------------- serialization

    def state_dict(self) -> Dict[str, Any]:
        state = super().state_dict()
        state.update({
            "train_x_clf": np.asarray(self.train_x_clf),
            "train_y_clf": np.asarray(self.train_y_clf).reshape(-1, 1),
            "clf_type": self.clf_type,
            "clf_settings": self.clf_settings,
            "clf_use_size": self.clf_use_size,
            "clf_update_step": self.clf_update_step,
            "probability_threshold": self.probability_threshold,
            "minus_inf": self.minus_inf,
            "clf_threshold": self.clf_threshold,
            "gp_threshold": self.gp_threshold,
            "use_clf": self.use_clf,
            "clf_params": (None if self.clf_params is None
                           else params_to_numpy(self.clf_params)),
            "clf_metrics": self.clf_metrics,
            "gp_class": "GPwithClassifier",
        })
        return state

    @classmethod
    def from_state_dict(cls, state: Dict[str, Any],
                        device=None) -> "GPwithClassifier":
        """From a state dict of either package (``clf_params`` of any kind,
        the MLP's ``layers`` as a list of (W, b))."""
        gp = cls(
            train_x=state["train_x_clf"],
            train_y=state["train_y_clf"],
            clf_type=str(_item(state["clf_type"])),
            clf_settings=_item(state.get("clf_settings")) or {},
            clf_use_size=int(_item(state["clf_use_size"])),
            clf_update_step=int(_item(state["clf_update_step"])),
            probability_threshold=float(_item(state["probability_threshold"])),
            minus_inf=float(_item(state["minus_inf"])),
            clf_threshold=float(_item(state["clf_threshold"])),
            gp_threshold=float(_item(state["gp_threshold"])),
            train_clf_on_init=False,
            noise=float(_item(state["noise"])),
            kernel=str(_item(state["kernel_name"])),
            optimizer=str(_item(state.get("optimizer_method", "lbfgs"))),
            lengthscales=state["lengthscales"],
            kernel_variance=float(_item(state["kernel_variance"])),
            lengthscale_bounds=tuple(np.asarray(state["lengthscale_bounds"]).tolist()),
            kernel_variance_bounds=tuple(np.asarray(state["kernel_variance_bounds"]).tolist()),
            kernel_variance_prior=_item(state.get("kernel_variance_prior_spec")),
            lengthscale_prior=_item(state.get("lengthscale_prior_spec")),
            tausq=float(_item(state.get("tausq", 1.0))),
            tausq_bounds=tuple(np.asarray(
                state.get("tausq_bounds", (1e-4, 1e4))).tolist()),
            param_names=(list(np.asarray(state["param_names"]).tolist())
                         if state.get("param_names") is not None else None),
            optimizer_options=_item(state.get("optimizer_options")) or {},
            input_warp=bool(_item(state.get("input_warp", False))),
            warp_bounds=tuple(np.asarray(
                state.get("warp_bounds", (0.25, 4.0))).tolist()),
            device=device,
        )
        _restore_warp(gp, state)
        gp.use_clf = bool(_item(state.get("use_clf", False)))
        clf_params = _item(state.get("clf_params"))
        gp.clf_metrics = _item(state.get("clf_metrics")) or {}
        if clf_params is not None:
            gp.clf_params = params_to_device(clf_params, gp.device)
        _restore_fit_basins(gp, state)
        return gp
