"""Run-state tracking, persistence, checkpoint/resume and exports.

Copied from bobe_tpu/utils/results.py, without the JAX profiler hooks:
per-phase wall-time ledger (monotonic, its phases the tracer's top-level
spans),
convergence/acquisition/hyperparameter/best-loglike/KL time series, resume
machinery, and the full set of output artifacts — pickle, GetDist-format
chain files (.txt/.paramnames/.ranges — written directly, getdist itself is
optional), JSON summary stats, intermediate crash-recovery JSON + GP npz, and
timing JSON.
"""
from __future__ import annotations

import json
import os
import pickle
import time
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from . import trace
from .core import atomic_write
from .log import get_logger

log = get_logger("results")

PHASES = (
    "GP Training",
    "Acquisition Optimization",
    "True Objective Evaluations",
    "Nested Sampling",
    "MCMC Sampling",
    "Classifier Training",
)


@dataclass
class ConvergenceInfo:
    """One convergence check (reference results.py:57-76)."""

    iteration: int
    logz_mean: float
    logz_upper: float
    logz_lower: float
    delta: float
    threshold: float
    converged: bool
    logz_dict: Dict[str, Any] = field(default_factory=dict)


class _JSONEncoder(json.JSONEncoder):
    def default(self, o):
        if isinstance(o, (np.integer,)):
            return int(o)
        if isinstance(o, (np.floating,)):
            return float(o)
        if isinstance(o, np.ndarray):
            return o.tolist()
        if isinstance(o, (np.bool_,)):
            return bool(o)
        return super().default(o)


class BOBEResults:
    """Tracks and persists everything about a run."""

    def __init__(self, output_file: str, save_dir: str = ".",
                 param_names: Optional[List[str]] = None,
                 param_labels: Optional[List[str]] = None,
                 param_bounds=None,
                 settings: Optional[Dict[str, Any]] = None,
                 likelihood_name: str = "likelihood",
                 resume_from_existing: bool = False):
        self.output_file = output_file
        self.save_dir = save_dir
        self.param_names = list(param_names or [])
        self.param_labels = list(param_labels or self.param_names)
        self.param_bounds = None if param_bounds is None else np.asarray(param_bounds)
        self.settings = dict(settings or {})
        self.likelihood_name = likelihood_name

        # time series
        self.acquisition_iterations: List[int] = []
        self.acquisition_values: List[float] = []
        self.acquisition_names: List[str] = []
        self.gp_hyperparams_history: List[Dict[str, Any]] = []
        self.best_loglike_iterations: List[int] = []
        self.best_loglike_values: List[float] = []
        self.convergence_history: List[ConvergenceInfo] = []
        self.kl_history: List[Dict[str, Any]] = []
        self.logz_evolution: List[Dict[str, Any]] = []

        # final state
        self.converged = False
        self.termination_reason = None
        self.final_samples = None
        self.final_weights = None
        self.final_loglikes = None
        self.final_logz: Dict[str, Any] = {}
        self.gp_info: Dict[str, Any] = {}

        # timing
        self._phase_times = {p: 0.0 for p in PHASES}
        self._phase_starts: Dict[str, Any] = {}  # (perf ns, span)
        self._phase_last: Dict[str, float] = {}  # seconds of the last span
        self._t0 = time.perf_counter()

        self._resumed = False
        if resume_from_existing:
            self._load_existing_results()

    # ------------------------------------------------------------- paths

    def _path(self, name: str) -> str:
        return os.path.join(self.save_dir, name)

    @property
    def base(self) -> str:
        return self._path(self.output_file)

    # ------------------------------------------------------------- timing

    # Each phase is a top-level span of the tracer (utils/trace.py) on the
    # ledger's own clock readings, so the two sum alike; with tracing on, a
    # phase's end waits for its device work.

    def start_timing(self, phase: str):
        t0 = time.perf_counter_ns()
        self._phase_starts[phase] = (t0, trace.span(phase, sync=True,
                                                    start_ns=t0))

    def end_timing(self, phase: str):
        started = self._phase_starts.pop(phase, None)
        if started is not None:
            t0, sp = started
            t1 = sp.close()
            if t1 is None:
                t1 = time.perf_counter_ns()
            dt = (t1 - t0) * 1e-9
            self._phase_times[phase] = self._phase_times.get(phase, 0.0) + dt
            self._phase_last[phase] = dt

    def last_timing(self, phase: str) -> float:
        """Seconds of the phase's most recent span (0 if it never ran)."""
        return self._phase_last.get(phase, 0.0)

    def get_timing_summary(self) -> Dict[str, Any]:
        total = time.perf_counter() - self._t0
        # "(overlapped)" phases ran concurrently with another tracked phase
        # (the async MC refresh overlaps the likelihood batch): they are
        # reported but excluded from the additive main-thread sum, or
        # 'untracked' would go negative
        tracked = sum(t for p, t in self._phase_times.items()
                      if not p.endswith("(overlapped)"))
        pct = {p: (100.0 * t / total if total > 0 else 0.0)
               for p, t in self._phase_times.items()}
        return {"total_runtime": total, "phase_times": dict(self._phase_times),
                "percentages": pct, "untracked": total - tracked}

    def save_timing(self):
        with open(f"{self.base}_timing.json", "w") as f:
            json.dump(self.get_timing_summary(), f, indent=2, cls=_JSONEncoder)

    # -------------------------------------------------------- time series

    def update_acquisition(self, iteration: int, value: float, name: str):
        self.acquisition_iterations.append(int(iteration))
        self.acquisition_values.append(float(value))
        self.acquisition_names.append(name)

    def get_acquisition_data(self) -> Dict[str, List]:
        return {"iterations": self.acquisition_iterations,
                "values": self.acquisition_values,
                "names": self.acquisition_names}

    def update_gp_hyperparams(self, iteration: int, lengthscales, kernel_variance):
        self.gp_hyperparams_history.append({
            "iteration": int(iteration),
            "lengthscales": [float(v) for v in lengthscales],
            "kernel_variance": float(kernel_variance),
        })

    def update_best_loglike(self, iteration: int, value: float):
        self.best_loglike_iterations.append(int(iteration))
        self.best_loglike_values.append(float(value))

    def update_kl_divergences(self, iteration: int, successive_kl: Dict[str, float]):
        self.kl_history.append({"iteration": int(iteration),
                                **{k: float(v) for k, v in successive_kl.items()}})

    def update_convergence(self, iteration: int, logz_dict: Dict[str, Any],
                           converged: bool, threshold: float):
        delta = (logz_dict["upper"] - logz_dict["lower"]) / 2.0
        info = ConvergenceInfo(
            iteration=int(iteration), logz_mean=float(logz_dict["mean"]),
            logz_upper=float(logz_dict["upper"]), logz_lower=float(logz_dict["lower"]),
            delta=float(delta), threshold=float(threshold),
            converged=bool(converged),
            logz_dict={k: float(v) for k, v in logz_dict.items()})
        self.convergence_history.append(info)
        self.logz_evolution.append({"iteration": int(iteration),
                                    **info.logz_dict})
        self.converged = bool(converged)

    # ------------------------------------------------------------- resume

    def is_resuming(self) -> bool:
        return self._resumed

    def get_last_iteration(self) -> int:
        candidates = [0]
        if self.acquisition_iterations:
            candidates.append(max(self.acquisition_iterations))
        if self.convergence_history:
            candidates.append(max(c.iteration for c in self.convergence_history))
        return max(candidates)

    def _state_json(self) -> Dict[str, Any]:
        return {
            "settings": self.settings,
            "param_names": self.param_names,
            "param_labels": self.param_labels,
            "param_bounds": None if self.param_bounds is None else self.param_bounds.tolist(),
            "likelihood_name": self.likelihood_name,
            "acquisition": self.get_acquisition_data(),
            "gp_hyperparams_history": self.gp_hyperparams_history,
            "best_loglike": {"iterations": self.best_loglike_iterations,
                             "values": self.best_loglike_values},
            "convergence_history": [asdict(c) for c in self.convergence_history],
            "kl_history": self.kl_history,
            "logz_evolution": self.logz_evolution,
            "converged": self.converged,
            "termination_reason": self.termination_reason,
            "phase_times": self._phase_times,
            # cumulative wall so a resumed process reports run-total
            # percentages instead of phase_times/new-process-wall > 100%
            "elapsed_walltime": time.perf_counter() - self._t0,
            "final_logz": self.final_logz,
            "gp_info": self.gp_info,
        }

    def _restore_state(self, d: Dict[str, Any]):
        # parse EVERYTHING before assigning ANYTHING: a malformed dict must
        # raise out of the parse block leaving the object untouched, not
        # half-restored (the caller falls back to a fresh start on raise)
        acq = d.get("acquisition", {})
        bl = d.get("best_loglike", {})
        conv = [ConvergenceInfo(**c) for c in d.get("convergence_history", [])]
        phase = {p: float(t) for p, t in d.get("phase_times", {}).items()}
        elapsed = float(d.get("elapsed_walltime", 0.0))
        final_logz = dict(d.get("final_logz", {}))
        gp_info = dict(d.get("gp_info", {}) or {})

        self.acquisition_iterations = list(acq.get("iterations", []))
        self.acquisition_values = list(acq.get("values", []))
        self.acquisition_names = list(acq.get("names", []))
        self.gp_hyperparams_history = list(d.get("gp_hyperparams_history", []))
        self.best_loglike_iterations = list(bl.get("iterations", []))
        self.best_loglike_values = list(bl.get("values", []))
        self.convergence_history = conv
        self.kl_history = list(d.get("kl_history", []))
        self.logz_evolution = list(d.get("logz_evolution", []))
        self.converged = bool(d.get("converged", False))
        self.termination_reason = d.get("termination_reason")
        self.final_logz = final_logz
        self.gp_info = gp_info
        self._phase_times.update(phase)
        # shift _t0 so total_runtime spans ALL process generations — the
        # restored phase_times are cumulative, and mixing them with a fresh
        # process wall made percentages exceed 100% and 'untracked' negative
        self._t0 = time.perf_counter() - elapsed

    def _load_existing_results(self):
        fn = f"{self.base}_intermediate.json"
        if not os.path.exists(fn):
            log.info("No intermediate results to resume from; starting fresh")
            return
        try:
            with open(fn) as f:
                d = json.load(f)
            self._restore_state(d)
        except Exception as e:
            log.warning(f"Failed to resume from {fn}: {e}; starting fresh")
            return
        # restore samples from chain files if present — in its OWN guard: a
        # corrupt chain snapshot must not discard the successfully restored
        # state above (and must not leave a half-restored object, which is
        # why it runs after, not inside, the state try-block)
        chain = f"{self.base}_checkpoint.txt"
        try:
            if os.path.exists(chain):
                # ndmin=2: a single-sample chain loads as 1-D otherwise and
                # would silently skip the restore
                data = np.loadtxt(chain, ndmin=2)
                if data.shape[1] >= 3:
                    self.final_weights = data[:, 0]
                    self.final_loglikes = -data[:, 1]
                    self.final_samples = data[:, 2:]
        except Exception as e:
            log.warning(f"Checkpoint chain {chain} unreadable ({e}); "
                        "resuming without the posterior snapshot")
        self._resumed = True
        log.info(f"Resumed results state from {fn} "
                 f"(last iteration {self.get_last_iteration()})")

    # ------------------------------------------------------------- writers

    def save_intermediate(self, gp=None, filename: Optional[str] = None):
        """Crash-recovery checkpoint: state JSON + GP npz."""
        name = filename or f"{self.output_file}_intermediate"
        path = self._path(name if name.endswith(".json") else f"{name}.json")
        # atomic replace: crash-recovery state must survive a kill mid-write
        atomic_write(path, lambda f: json.dump(self._state_json(), f,
                                               indent=2, cls=_JSONEncoder))
        if gp is not None:
            gp.save(self._path(f"{filename or self.output_file}_gp"))
        log.debug(f"Saved intermediate results to {path}")

    def save_chain_files(self, samples_dict: Dict[str, Any],
                         filename: Optional[str] = None):
        """GetDist-format text chains: <w> <-logL> <params...> plus
        .paramnames and .ranges (written without the getdist package)."""
        if not samples_dict:
            return
        base = self._path(filename or self.output_file)
        x = np.atleast_2d(np.asarray(samples_dict["x"]))
        n = x.shape[0]
        w = np.asarray(samples_dict.get("weights", np.ones(n))).reshape(-1)
        logl = np.asarray(samples_dict.get("logl", np.zeros(n))).reshape(-1)
        data = np.column_stack([w, -logl, x])
        # atomic: the _checkpoint.txt chain is the crash-recovery posterior
        # snapshot resume reads back — a kill mid-savetxt must not leave a
        # truncated file shadowing the previous good one
        atomic_write(f"{base}.txt", lambda f: np.savetxt(f, data))

        def _names(f):
            for name, label in zip(self.param_names, self.param_labels):
                f.write(f"{name}\t{label}\n")

        atomic_write(f"{base}.paramnames", _names)
        if self.param_bounds is not None:
            def _ranges(f):
                for i, name in enumerate(self.param_names):
                    f.write(f"{name}\t{self.param_bounds[0, i]:.8g}\t"
                            f"{self.param_bounds[1, i]:.8g}\n")

            atomic_write(f"{base}.ranges", _ranges)
        log.debug(f"Saved chain files to {base}.txt/.paramnames/.ranges")

    def save_summary_stats(self):
        stats: Dict[str, Any] = {
            "likelihood": self.likelihood_name,
            "converged": self.converged,
            "termination_reason": self.termination_reason,
            "logz": self.final_logz,
            "n_iterations": self.get_last_iteration(),
            "gp_info": self.gp_info,
            "settings": self.settings,
        }
        if self.final_samples is not None and len(self.final_samples):
            w = self.final_weights / np.sum(self.final_weights)
            mean = np.sum(self.final_samples * w[:, None], axis=0)
            var = np.sum((self.final_samples - mean) ** 2 * w[:, None], axis=0)
            stats["posterior_means"] = dict(zip(self.param_names, mean.tolist()))
            stats["posterior_stds"] = dict(
                zip(self.param_names, np.sqrt(var).tolist()))
        path = f"{self.base}_stats.json"
        with open(path, "w") as f:
            json.dump(stats, f, indent=2, cls=_JSONEncoder)
        return stats

    def save_main_results(self):
        payload = {
            "state": self._state_json(),
            "samples": self.final_samples,
            "weights": self.final_weights,
            "loglikes": self.final_loglikes,
        }
        with open(f"{self.base}_results.pkl", "wb") as f:
            pickle.dump(payload, f)

    def finalize(self, samples_dict: Dict[str, Any], logz_dict: Dict[str, Any],
                 converged: bool, termination_reason: Optional[str],
                 gp_info: Dict[str, Any], write: bool = True):
        """Store final results and (unless ``write=False``, for BOBE
        save=False runs) write every artifact (reference
        results.py:516,654-780)."""
        self.converged = bool(converged)
        self.termination_reason = termination_reason
        self.final_logz = {k: float(v) for k, v in (logz_dict or {}).items()}
        self.gp_info = dict(gp_info or {})
        if samples_dict:
            self.final_samples = np.atleast_2d(np.asarray(samples_dict["x"]))
            n = self.final_samples.shape[0]
            self.final_weights = np.asarray(
                samples_dict.get("weights", np.ones(n))).reshape(-1)
            self.final_loglikes = np.asarray(
                samples_dict.get("logl", np.zeros(n))).reshape(-1)
        if not write:
            return
        os.makedirs(self.save_dir, exist_ok=True)
        self.save_main_results()
        if samples_dict:
            self.save_chain_files(samples_dict)
        self.save_summary_stats()
        self.save_timing()
        self.save_intermediate()
        log.info(f"Finalized results under {self.base}_*")

    # ------------------------------------------------------------- getdist

    def get_mcsamples(self):
        """Build a getdist MCSamples (optional dependency)."""
        try:
            from getdist import MCSamples
        except ImportError as e:
            raise ImportError("getdist is not installed; chain .txt files are "
                              "still written and loadable by getdist elsewhere") from e
        ranges = None
        if self.param_bounds is not None:
            ranges = {n: [self.param_bounds[0, i], self.param_bounds[1, i]]
                      for i, n in enumerate(self.param_names)}
        return MCSamples(samples=self.final_samples, weights=self.final_weights,
                         loglikes=-self.final_loglikes, names=self.param_names,
                         labels=self.param_labels, ranges=ranges)

    @classmethod
    def load_results(cls, base_path: str) -> Dict[str, Any]:
        with open(f"{base_path}_results.pkl", "rb") as f:
            return pickle.load(f)
