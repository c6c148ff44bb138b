"""Evaluation pools: the host-side runtime for expensive true likelihoods.

Counterpart of ``bobe_tpu/parallel/pool.py``. GP math runs on the device;
true-likelihood evaluations are host-side and go through an ``EvalPool``:

* ``SerialPool``: in-process evaluation;
* ``MultiprocessPool``: worker processes on one host (``forkserver``), with
  dynamic scheduling, results in the order of the points and fail-fast
  errors. Workers never touch the card: each hides every CUDA device
  (``CUDA_VISIBLE_DEVICES=""``) before anything in it can initialise CUDA,
  so the orchestrator keeps the card to itself.

The distributed pool (``torch.distributed``) is not ported yet.
"""
from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np

from .. import config
from ..utils.log import get_logger

log = get_logger("pool")


class EvalPool:
    """Interface of the likelihood evaluation pools."""

    size: int = 1

    def run_map_objective(self, likelihood, points) -> np.ndarray:
        """Evaluate likelihood at each point (n, d) -> (n,) in order."""
        raise NotImplementedError

    def close(self):
        pass


class SerialPool(EvalPool):
    """In-process evaluation."""

    def run_map_objective(self, likelihood, points) -> np.ndarray:
        points = np.atleast_2d(np.asarray(points))
        return np.asarray([likelihood(p) for p in points], dtype=np.float64)


# --------------------------------------------------------------------------
# single-host multiprocessing
# --------------------------------------------------------------------------

_WORKER_LIKELIHOOD = None


def _dumps(likelihood) -> tuple:
    """(transport, payload bytes): cloudpickle where it is installed (it
    ships closures and lambdas), else pickle. Raises TypeError naming the
    reason when the likelihood does not pickle."""
    try:
        import cloudpickle
    except ImportError:
        cloudpickle = None
    try:
        if cloudpickle is not None:
            return "cloudpickle", cloudpickle.dumps(likelihood)
        return "pickle", pickle.dumps(likelihood)
    except Exception as e:
        how = "cloudpickle" if cloudpickle is not None else (
            "pickle (cloudpickle is not installed, so closures, lambdas and "
            "functions of __main__ defined interactively do not pickle)")
        raise TypeError(
            f"MultiprocessPool: the likelihood cannot be sent to the worker "
            f"processes: it does not pickle with {how}: {e!r}. Use "
            "pool='serial', or a likelihood defined at module level") from e


def _mp_init(transport, payload, base_seed):
    global _WORKER_LIKELIHOOD
    # likelihood workers are host-only: hide the card before anything in
    # this process can initialise CUDA (torch reads the variable at its
    # first CUDA call), so no worker opens a context on the card that the
    # orchestrator holds
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    if transport == "cloudpickle":
        import cloudpickle

        _WORKER_LIKELIHOOD = cloudpickle.loads(payload)
    else:
        _WORKER_LIKELIHOOD = pickle.loads(payload)
    if base_seed is not None:
        from ..utils import seed as seed_mod

        seed_mod.set_global_seed(base_seed + os.getpid() % 10000,
                                 rank_offset=False)


def _mp_eval(args):
    idx, point = args
    return idx, _WORKER_LIKELIHOOD(point)


class MultiprocessPool(EvalPool):
    """Worker-process pool for one host.

    Dynamic scheduling comes from multiprocessing's work queue
    (``imap_unordered``); results are index-tagged to restore the order of
    the points, and the first worker exception propagates to the caller
    (fail-fast). Workers start by ``forkserver``: forking a process that
    holds a CUDA context is unsafe, and the fork server never touches the
    card. The likelihood is pickled once per pool (cloudpickle where
    installed, else pickle); one that does not pickle raises at pool start,
    and is never evaluated in-process in its place.

    As with any non-fork start method, a user script creates the pool under
    ``if __name__ == "__main__":``.
    """

    def __init__(self, n_workers: Optional[int] = None,
                 seed: Optional[int] = None,
                 start_method: str = "forkserver"):
        import multiprocessing as mp

        self._mp = mp.get_context(start_method)
        self.size = n_workers or max(1, os.cpu_count() or 1)
        self._seed = seed
        self._pool = None
        self._likelihood = None

    def _ensure_pool(self, likelihood):
        if self._pool is None or self._likelihood is not likelihood:
            transport, payload = _dumps(likelihood)
            self.close()
            self._likelihood = likelihood
            self._pool = self._mp.Pool(
                self.size, initializer=_mp_init,
                initargs=(transport, payload, self._seed))

    def run_map_objective(self, likelihood, points) -> np.ndarray:
        points = np.atleast_2d(np.asarray(points))
        self._ensure_pool(likelihood)
        out = np.empty(len(points), dtype=np.float64)
        for idx, val in self._pool.imap_unordered(
                _mp_eval, list(enumerate(points))):
            out[idx] = val
        return out

    def close(self):
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None
            self._likelihood = None


def make_pool(kind: str = "auto", **kwargs) -> EvalPool:
    """Pool factory: 'serial' gives the SerialPool, and so does 'auto' in a
    single process ('auto' inside a multi-process torch.distributed job
    would pick the distributed pool, which is not ported);
    'multiprocess' gives the MultiprocessPool (``kwargs``: n_workers, seed,
    start_method)."""
    if kind == "auto":
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized() \
                and dist.get_world_size() > 1:
            raise config.not_ported("The distributed evaluation pool",
                                    "pools")
        return SerialPool()
    if kind == "serial":
        return SerialPool()
    if kind == "multiprocess":
        return MultiprocessPool(**kwargs)
    if kind == "distributed":
        raise config.not_ported(f"The '{kind}' evaluation pool", "pools")
    raise ValueError(f"Unknown pool kind '{kind}'")
