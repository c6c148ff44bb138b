"""Evaluation pools: the host-side runtime for expensive true likelihoods.

Counterpart of ``bobe_tpu/parallel/pool.py``. GP math runs on the device;
true-likelihood evaluations are host-side and go through an ``EvalPool``.
The port has the in-process ``SerialPool``; the multiprocess and distributed
pools are not ported yet.
"""
from __future__ import annotations

import numpy as np

from .. import config


class EvalPool:
    """Interface of the likelihood evaluation pools."""

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


def make_pool(kind: str = "auto", **kwargs) -> EvalPool:
    """Pool factory: 'serial' gives the SerialPool, and so does 'auto' in a
    single process ('auto' inside a multi-process torch.distributed job
    would pick the distributed pool, which is not ported)."""
    if kind == "auto":
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized() \
                and dist.get_world_size() > 1:
            raise config.not_ported("The distributed evaluation pool",
                                    "pools")
        return SerialPool()
    if kind == "serial":
        return SerialPool()
    if kind in ("multiprocess", "distributed"):
        raise config.not_ported(f"The '{kind}' evaluation pool", "pools")
    raise ValueError(f"Unknown pool kind '{kind}'")
