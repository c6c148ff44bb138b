"""Evaluation pools: the host-side runtime for expensive true likelihoods.

Counterpart of ``bobe_tpu/parallel/pool.py``. GP math runs on the device;
true-likelihood evaluations are host-side and go through an ``EvalPool``:

* ``SerialPool``: in-process evaluation;
* ``MultiprocessPool``: worker processes on one host (``forkserver``), with
  dynamic scheduling, results in the order of the points and fail-fast
  errors. Workers never touch the card: each hides every CUDA device
  (``CUDA_VISIBLE_DEVICES=""``) before anything in it can initialise CUDA,
  so the orchestrator keeps the card to itself;
* ``DistributedPool``: every rank of a ``torch.distributed`` job (a gloo
  group that the launcher initialised) evaluates likelihoods; rank 0 drives
  the BO loop, the other ranks wait in :meth:`DistributedPool.worker_loop`.

Every pool also draws the initial points of a Cobaya likelihood from its
reference distribution (``get_cobaya_initial_points``).
"""
from __future__ import annotations

import os
import pickle
import sys
import time
from typing import List, Optional, Tuple

import numpy as np

from ..utils.log import get_logger
from ..utils.seed import get_numpy_rng

log = get_logger("pool")


class EvalPool:
    """Interface of the likelihood evaluation pools."""

    size: int = 1

    @property
    def is_main_process(self) -> bool:
        return True

    @property
    def is_mpi(self) -> bool:  # kept for the original BOBE's API
        return False

    @property
    def is_distributed(self) -> bool:
        return self.size > 1

    def run_map_objective(self, likelihood, points) -> np.ndarray:
        """Evaluate likelihood at each point (n, d) -> (n,) in order."""
        raise NotImplementedError

    def get_cobaya_initial_points(self, likelihood, n_points: int, rng=None
                                  ) -> List[Tuple]:
        """Draw n valid points (point, shifted log-posterior) from the Cobaya
        reference distribution."""
        raise NotImplementedError

    def gp_fit(self, gp, n_restarts=8, maxiters=500, rng=None):
        """Hyperparameter fit. Its restarts run as lanes on the device, so
        the pool takes no part; kept for the original BOBE's API."""
        return gp.fit(n_restarts=n_restarts, maxiter=maxiters, rng=rng)

    def close(self):
        pass


class SerialPool(EvalPool):
    """In-process evaluation."""

    def run_map_objective(self, likelihood, points) -> np.ndarray:
        points = np.atleast_2d(np.asarray(points))
        return np.asarray([likelihood(p) for p in points], dtype=np.float64)

    def get_cobaya_initial_points(self, likelihood, n_points, rng=None):
        rng = rng if rng is not None else get_numpy_rng()
        return [likelihood._get_single_valid_point(rng)
                for _ in range(n_points)]


# --------------------------------------------------------------------------
# single-host multiprocessing
# --------------------------------------------------------------------------

_WORKER_LIKELIHOOD = None
_WORKER_LOAD_ERROR = None


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
    global _WORKER_LIKELIHOOD, _WORKER_LOAD_ERROR
    # likelihood workers are host-only: hide the card before anything in
    # this process can initialise CUDA (torch reads the variable at its
    # first CUDA call), so no worker opens a context on the card that the
    # orchestrator holds
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    # an initializer that raises makes the pool respawn the worker for ever;
    # keep the error and raise it from each task instead, so the caller
    # fails at once (a Cobaya adapter builds its model here, and needs its
    # cobaya module importable in the worker)
    try:
        if transport == "cloudpickle":
            import cloudpickle

            _WORKER_LIKELIHOOD = cloudpickle.loads(payload)
        else:
            _WORKER_LIKELIHOOD = pickle.loads(payload)
    except Exception as e:
        _WORKER_LOAD_ERROR = e
        return
    if base_seed is not None:
        from ..utils import seed as seed_mod

        seed_mod.set_global_seed(base_seed + os.getpid() % 10000,
                                 rank_offset=False)


def _worker_likelihood():
    if _WORKER_LOAD_ERROR is not None:
        raise RuntimeError(
            f"MultiprocessPool: a worker could not load the likelihood: "
            f"{_WORKER_LOAD_ERROR!r}") from _WORKER_LOAD_ERROR
    return _WORKER_LIKELIHOOD


def _mp_eval(args):
    idx, point = args
    return idx, _worker_likelihood()(point)


def _mp_cobaya_point(seed_i):
    rng = np.random.default_rng(seed_i)
    return _worker_likelihood()._get_single_valid_point(rng)


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

    def get_cobaya_initial_points(self, likelihood, n_points, rng=None):
        """One seed per point from ``rng``, each point drawn in a worker
        from ``default_rng(seed)``: the draws do not depend on which worker
        takes which point."""
        rng = rng if rng is not None else get_numpy_rng()
        seeds = rng.integers(0, 2**31 - 1, size=n_points)
        self._ensure_pool(likelihood)
        return list(self._pool.map(_mp_cobaya_point, seeds))

    def close(self):
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None
            self._likelihood = None


# --------------------------------------------------------------------------
# multi-process jobs over torch.distributed
# --------------------------------------------------------------------------

class DistributedPool(EvalPool):
    """Likelihood farm over the ranks of a ``torch.distributed`` job.

    Every process runs the same program. Rank 0 drives the BO loop; at each
    evaluation all ranks enter a round together. Control flow rides the
    group's collectives: rank 0 broadcasts a 3-float header (task, n, d; gloo
    needs the same shape on every rank, so n and d come before the points),
    and an all-gather closes each round. The work itself is dealt out
    dynamically: rank 0 serves a TCP task queue (``multiprocessing.managers``
    from a daemon thread) that every rank, rank 0 included, pulls from, so a
    failing point that returns at once and a success that takes a second
    balance across ranks. If any rank cannot serve or reach the queue, every
    rank falls back to static round-robin shards and an all-gather.

    The group is the launcher's: ``torch.distributed.init_process_group``
    with the gloo backend (the collectives move float64 CPU tensors) runs
    before the pool, and before ``BOBE``, whose seed is offset by the rank.
    The pool never initialises a group itself. Without a group it is a pool
    of size 1 that evaluates in process.

    Worker ranks block in :meth:`worker_loop` between rounds, in a broadcast:
    the group's timeout (``init_process_group(timeout=...)``) bounds how long
    a worker waits while rank 0 fits, acquires and samples, so a launcher
    whose iterations outlast the default sets a longer one.
    """

    TASK_EVAL, TASK_COBAYA, TASK_EXIT, TASK_EVAL_DYN = 0, 1, 2, 3
    _ADDR_BYTES = 64  # fixed-size wire format: ip(40) + port(4) + authkey(16)
    # class-level defaults so transport-stubbed instances (tests build the
    # pool via __new__) get the static path
    _dyn = False
    _queues = None

    def __init__(self):
        import torch.distributed as dist

        self.rank, self.size = 0, 1
        if dist.is_available() and dist.is_initialized():
            if "gloo" not in str(dist.get_backend()).lower():
                raise ValueError(
                    "DistributedPool needs a gloo process group (its "
                    "collectives move CPU tensors); got backend "
                    f"{dist.get_backend()!r}")
            self.rank, self.size = dist.get_rank(), dist.get_world_size()
        self._queues = None
        self._dyn = False
        if self.size > 1:
            self._dyn = self._setup_task_queues()

    # -------------------------------------------------- dynamic task queue

    def _setup_task_queues(self) -> bool:
        """Rank 0 serves task/result queues over TCP; the (ip, port, authkey)
        triple is broadcast over the group. Returns False (static fallback)
        if serving or connecting fails on any rank."""
        import queue as _queue
        import secrets
        import socket
        import threading
        from multiprocessing.managers import BaseManager

        class _QueueManager(BaseManager):
            pass

        ok = np.zeros(1)
        # The broadcast and the consensus all-gather below are collectives:
        # every rank must reach both in the same order whichever local step
        # fails, or the group deadlocks. Rank 0 signals its failure by
        # broadcasting an all-zero wire (port 0) instead of skipping the
        # broadcast.
        if self.rank == 0:
            wire = np.zeros(self._ADDR_BYTES, dtype=np.uint8)
            try:
                task_q, result_q = _queue.Queue(), _queue.Queue()
                _QueueManager.register("task_q", callable=lambda: task_q)
                _QueueManager.register("result_q", callable=lambda: result_q)
                authkey = secrets.token_bytes(16)
                mgr = _QueueManager(address=("0.0.0.0", 0), authkey=authkey)
                # serve from a thread: BaseManager.start() would fork a
                # process that may hold a CUDA context
                server = mgr.get_server()
                threading.Thread(target=server.serve_forever,
                                 daemon=True).start()
                port = server.address[1]
                try:
                    ip = socket.gethostbyname(socket.gethostname())
                except OSError:
                    ip = "127.0.0.1"
                ip_b = ip.encode()[:40]
                wire[:len(ip_b)] = np.frombuffer(ip_b, dtype=np.uint8)
                wire[40:44] = np.frombuffer(
                    int(port).to_bytes(4, "little"), dtype=np.uint8)
                wire[44:60] = np.frombuffer(authkey, dtype=np.uint8)
                self._queues = (task_q, result_q)
                ok[0] = 1.0
            except Exception as e:
                log.warning(f"task-queue server unavailable ({e}); "
                            "falling back to static sharding")
            self._bcast(wire)
        else:
            wire = self._bcast(np.zeros(self._ADDR_BYTES)).astype(np.uint8)
            port = int.from_bytes(bytes(wire[40:44]), "little")
            if port == 0:
                log.warning("rank 0 reported no task-queue server; "
                            "falling back to static sharding")
            else:
                try:
                    ip = bytes(wire[:40]).rstrip(b"\x00").decode()
                    authkey = bytes(wire[44:60])
                    _QueueManager.register("task_q")
                    _QueueManager.register("result_q")
                    # a worker may land here before rank 0's server thread
                    # is up
                    last = None
                    for host in (ip, "127.0.0.1"):
                        for _ in range(50):
                            try:
                                mgr = _QueueManager(address=(host, port),
                                                    authkey=authkey)
                                mgr.connect()
                                self._queues = (mgr.task_q(), mgr.result_q())
                                ok[0] = 1.0
                                break
                            except (ConnectionError, OSError) as e:
                                last = e
                                time.sleep(0.1)
                        if ok[0]:
                            break
                    if not ok[0]:
                        log.warning(f"task-queue connect failed ({last}); "
                                    "falling back to static sharding")
                except Exception as e:
                    log.warning(f"dynamic task queue unavailable ({e}); "
                                "falling back to static sharding")
        # consensus: dynamic only if every rank is wired up
        all_ok = self._allgather_rows(ok)
        return bool(np.all(all_ok == 1.0))

    def _dynamic_round(self, likelihood, points=None):
        """One dynamic evaluation round. Rank 0 passes the batch and gets the
        ordered values back; workers pass None and serve until the sentinel.
        The trailing all-gather is the round barrier (keeps the collectives
        aligned across ranks for the next broadcast)."""
        task_q, result_q = self._queues
        n = 0
        if self.rank == 0:
            n = len(points)
            for i, p in enumerate(points):
                task_q.put((i, np.asarray(p)))
            for _ in range(self.size):
                task_q.put(None)
        while True:
            task = task_q.get()
            if task is None:
                break
            i, p = task
            try:
                result_q.put((i, float(likelihood(p)), None))
            except Exception as e:  # a pool-level failure: fail fast
                result_q.put((i, np.nan, repr(e)))
        out, err = None, None
        if self.rank == 0:
            out = np.full(n, np.nan, dtype=np.float64)
            for _ in range(n):
                i, v, e = result_q.get()
                out[i] = v
                err = err or e
        self._allgather_rows(np.zeros(1))  # round barrier
        if err:
            raise RuntimeError(f"likelihood evaluation failed on a worker: {err}")
        return out

    @property
    def is_main_process(self) -> bool:
        return self.rank == 0

    def _bcast(self, arr) -> np.ndarray:
        """``arr`` on rank 0, as float64, on every rank (the others pass a
        buffer of the same shape)."""
        import torch
        import torch.distributed as dist

        t = torch.tensor(np.asarray(arr, dtype=np.float64))
        dist.broadcast(t, src=0)
        return t.numpy()

    def _allgather_rows(self, local_rows) -> np.ndarray:
        """(size, *local.shape): every rank's ``local_rows``, by rank."""
        import torch
        import torch.distributed as dist

        t = torch.tensor(np.asarray(local_rows, dtype=np.float64))
        out = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(out, t)
        return torch.stack(out).numpy()

    def _eval_shard(self, likelihood, points):
        # per-point exceptions become NaN so the all-gather is always posted
        # (a raise here would desynchronize the collectives and hang every
        # other rank); rank 0 turns the NaN into a RuntimeError after the
        # combine, and close()'s EXIT broadcast then releases the workers.
        # The likelihood adapters already map user-level failures to
        # minus_inf, so a NaN means a pool or adapter fault.
        n = len(points)
        idxs = np.arange(self.rank, n, self.size)
        vals = np.full(n, np.nan, dtype=np.float64)
        for i in idxs:
            try:
                vals[i] = likelihood(points[i])
            except Exception as e:
                log.error(f"likelihood evaluation raised on rank {self.rank} "
                          f"(point {i}): {e!r}")
        return vals

    def run_map_objective(self, likelihood, points) -> np.ndarray:
        # float64 throughout: collectives post identical shape and dtype
        # buffers on every rank
        points = np.atleast_2d(np.asarray(points, dtype=np.float64))
        if self.size == 1:
            return SerialPool().run_map_objective(likelihood, points)
        if not self.is_main_process:
            # a worker rank calling this directly would post a collective
            # sequence mismatched with rank 0's and hang the group
            raise RuntimeError(
                "DistributedPool.run_map_objective is rank-0 only; worker "
                "ranks must block in worker_loop()")
        if self._dyn:
            self._bcast(np.asarray(
                [self.TASK_EVAL_DYN, len(points), points.shape[1]],
                dtype=np.float64))
            return self._dynamic_round(likelihood, points)
        self._bcast(np.asarray([self.TASK_EVAL, len(points), points.shape[1]],
                               dtype=np.float64))
        pts = self._bcast(points)
        local = self._eval_shard(likelihood, pts)
        allv = self._allgather_rows(local)  # (size, n)
        # each column has exactly one non-NaN entry
        cols = ~np.isnan(allv)
        out = allv[np.argmax(cols, axis=0), np.arange(allv.shape[1])]
        if np.isnan(out).any():
            raise RuntimeError(
                "likelihood evaluation failed on a worker rank (see that "
                "rank's log for the exception)")
        return out

    def worker_loop(self, likelihood):
        """Ranks > 0 serve evaluations here until rank 0 broadcasts EXIT."""
        while True:
            header = self._bcast(np.zeros(3))
            task = int(header[0])
            if task == self.TASK_EXIT:
                return
            if task == self.TASK_EVAL_DYN:
                self._dynamic_round(likelihood)
            elif task == self.TASK_EVAL:
                n, d = int(header[1]), int(header[2])
                pts = self._bcast(np.zeros((n, d)))
                local = self._eval_shard(likelihood, pts)
                self._allgather_rows(local)
            elif task == self.TASK_COBAYA:
                self._cobaya_shard(likelihood, int(header[1]))

    # the original BOBE's name (its MPI pool's worker_wait)
    def worker_wait(self, likelihood, seed=None):
        return self.worker_loop(likelihood)

    def _cobaya_shard(self, likelihood, n_points):
        """Each rank draws its round-robin share of the points from its own
        (rank-offset) random stream; the draws are all-gathered."""
        rng = get_numpy_rng()
        idxs = np.arange(self.rank, n_points, self.size)
        pts = np.full((n_points, likelihood.ndim), np.nan)
        lps = np.full(n_points, np.nan)
        for i in idxs:
            # a raise here would skip the all-gathers below and hang every
            # other rank: a failed draw stays a NaN row, and rank 0 fails
            # after the combine
            try:
                pt, lp = likelihood._get_single_valid_point(rng)
                pts[i], lps[i] = pt, lp
            except Exception as e:
                log.error(f"cobaya initial-point draw raised on rank "
                          f"{self.rank} (point {i}): {e!r}")
        allp = self._allgather_rows(pts)
        alll = self._allgather_rows(lps)
        sel = np.argmax(~np.isnan(alll), axis=0)
        return [(allp[sel[i], i], alll[sel[i], i]) for i in range(n_points)]

    def get_cobaya_initial_points(self, likelihood, n_points, rng=None):
        if self.size == 1:
            return SerialPool().get_cobaya_initial_points(likelihood,
                                                          n_points, rng)
        self._bcast(np.asarray([self.TASK_COBAYA, n_points, 0],
                               dtype=np.float64))
        out = self._cobaya_shard(likelihood, n_points)
        bad = [i for i, (_, lp) in enumerate(out) if np.isnan(lp)]
        if bad:
            raise RuntimeError(
                f"Cobaya initial-point generation failed on every rank for "
                f"point(s) {bad} (see rank logs for the underlying errors)")
        return out

    def close(self):
        # idempotent: BOBE closes on its normal exit paths and in a finally
        # block; a second EXIT broadcast would have no worker_loop partner
        # (workers leave the loop at the first one) and hang the group
        if getattr(self, "_closed", False):
            return
        self._closed = True
        if self.size > 1 and self.is_main_process:
            self._bcast(np.asarray([self.TASK_EXIT, 0, 0], dtype=np.float64))


def make_pool(kind: str = "auto", **kwargs) -> EvalPool:
    """Pool factory: 'serial', 'multiprocess' (``kwargs``: n_workers, seed,
    start_method), 'distributed' (a pool of size 1 outside a
    torch.distributed job), or 'auto': the distributed pool inside a job of
    more than one process, else the serial pool."""
    if kind == "auto":
        # a process that never imported torch has no group (a
        # device-server client imports none)
        dist = sys.modules.get("torch.distributed")
        if dist is not None and dist.is_available() \
                and dist.is_initialized() and dist.get_world_size() > 1:
            return DistributedPool()
        return SerialPool()
    if kind == "serial":
        return SerialPool()
    if kind == "multiprocess":
        return MultiprocessPool(**kwargs)
    if kind == "distributed":
        return DistributedPool()
    raise ValueError(f"Unknown pool kind '{kind}'")
