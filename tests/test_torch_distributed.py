"""The port's DistributedPool: the scheduling logic with a stubbed transport
(the cases of tests/test_distributed_logic.py), then real torch.distributed
gloo groups of 2 and 3 CPU processes started from this file itself: the pool
protocol (ordered values, reuse, Cobaya draws, a clean worker exit),
heterogeneous-cost dynamic scheduling, the static fallback when rank 0's
task-queue server fails, and a short BOBE loop whose training set equals a
serial pool's.

Each rank runs ``python tests/test_torch_distributed.py MODE RANK SIZE PORT``
(see ``_rank_main``); the test reads the ranks' exit codes and markers.
"""
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from bobe_tpu_torch.likelihood import Likelihood
from bobe_tpu_torch.parallel.pool import DistributedPool, make_pool

HERE = os.path.dirname(os.path.abspath(__file__))
BOUNDS = np.array([[0.0, 1.0], [0.0, 1.0]]).T
SLOW = 1.5


def quad(x):
    return -float(np.sum((np.asarray(x) - 0.5) ** 2) * 20.0)


def lumpy(x):
    # one expensive point per batch (x[0] > 0.9 marks it), the rest instant:
    # the Cobaya regime, where failures return at once and successes take
    # about a second
    if x[0] > 0.9:
        time.sleep(SLOW)
    return quad(x)


# ----------------------------------------------------- stubbed transport

def make_pool_stub(rank, size, transcripts):
    pool = DistributedPool.__new__(DistributedPool)
    pool.rank = rank
    pool.size = size
    pool._sent = []

    def _bcast(arr):
        pool._sent.append(np.asarray(arr))
        return np.asarray(arr)

    pool._bcast = _bcast

    def _allgather(local):
        # every rank computing its shard of the same batch
        rows = []
        for r in range(size):
            vals = np.full_like(np.asarray(local), np.nan, dtype=np.float64)
            for i in np.arange(r, len(vals), size):
                vals[i] = transcripts[i]
            rows.append(vals)
        return np.stack(rows)

    pool._allgather_rows = _allgather
    return pool


def test_round_robin_shard_and_ordered_combine():
    lk = Likelihood(lambda x: -float(np.sum(x**2)), ["a", "b"],
                    param_bounds=BOUNDS)
    pts = np.random.default_rng(0).uniform(size=(7, 2))
    truth = np.array([lk(p) for p in pts])
    pool = make_pool_stub(rank=0, size=3, transcripts=truth)
    out = pool.run_map_objective(lk, pts)
    np.testing.assert_allclose(out, truth)
    head = pool._sent[0]
    assert int(head[0]) == DistributedPool.TASK_EVAL
    assert int(head[1]) == 7 and int(head[2]) == 2


def test_eval_shard_covers_disjoint_indices():
    lk = Likelihood(lambda x: float(x[0]), ["a"],
                    param_bounds=np.array([[0.0], [1.0]]))
    pts = np.linspace(0, 1, 10).reshape(-1, 1)
    covered = np.zeros(10, dtype=int)
    for r in range(4):
        pool = DistributedPool.__new__(DistributedPool)
        pool.rank, pool.size = r, 4
        covered += ~np.isnan(pool._eval_shard(lk, pts))
    np.testing.assert_array_equal(covered, np.ones(10, dtype=int))


def test_close_broadcasts_exit():
    pool = make_pool_stub(rank=0, size=2, transcripts=np.zeros(1))
    pool.close()
    assert int(pool._sent[-1][0]) == DistributedPool.TASK_EXIT


def test_close_is_idempotent():
    pool = make_pool_stub(rank=0, size=2, transcripts=np.zeros(1))
    pool.close()
    pool.close()
    exits = [s for s in pool._sent if int(s[0]) == DistributedPool.TASK_EXIT]
    assert len(exits) == 1


def test_worker_rank_direct_call_raises():
    lk = Likelihood(lambda x: 0.0, ["a"], param_bounds=np.array([[0.0], [1.0]]))
    pool = make_pool_stub(rank=1, size=2, transcripts=np.zeros(2))
    with pytest.raises(RuntimeError, match="rank-0 only"):
        pool.run_map_objective(lk, np.zeros((2, 1)))


def test_eval_shard_exception_becomes_nan_not_raise():
    class RawBoom:
        minus_inf = -1e10

        def __call__(self, p):
            raise ValueError("pool-level bug")

    pool = DistributedPool.__new__(DistributedPool)
    pool.rank, pool.size = 0, 2
    vals = pool._eval_shard(RawBoom(), np.zeros((4, 1)))
    assert np.isnan(vals[0]) and np.isnan(vals[2])  # rank 0's shard failed
    assert np.isnan(vals[1]) and np.isnan(vals[3])  # the other rank's


def test_remote_worker_failure_fails_fast_on_rank0():
    lk = Likelihood(lambda x: -float(np.sum(x**2)), ["a", "b"],
                    param_bounds=BOUNDS)
    pts = np.random.default_rng(0).uniform(size=(4, 2))
    truth = np.array([lk(p) for p in pts])
    truth[2] = np.nan  # rank 2's point failed remotely
    pool = make_pool_stub(rank=0, size=3, transcripts=truth)
    with pytest.raises(RuntimeError, match="failed on a worker rank"):
        pool.run_map_objective(lk, pts)


class _BoomLike:
    ndim = 2

    def _get_single_valid_point(self, rng):
        raise RuntimeError("theory code exploded")


def test_cobaya_shard_exception_becomes_nan_not_raise():
    pool = DistributedPool.__new__(DistributedPool)
    pool.rank, pool.size = 0, 2
    posted = []
    pool._allgather_rows = lambda local: (posted.append(np.asarray(local)),
                                          np.stack([np.asarray(local)] * 2))[1]
    out = pool._cobaya_shard(_BoomLike(), 4)
    assert len(posted) == 2  # both collectives were still posted
    assert all(np.isnan(lp) for _, lp in out)


def test_get_cobaya_initial_points_fails_fast_on_all_nan():
    pool = DistributedPool.__new__(DistributedPool)
    pool.rank, pool.size = 0, 2
    pool._bcast = lambda arr: np.asarray(arr)
    pool._allgather_rows = lambda local: np.stack([np.asarray(local)] * 2)
    with pytest.raises(RuntimeError, match="initial-point generation failed"):
        pool.get_cobaya_initial_points(_BoomLike(), 3)


def test_without_a_group_the_pool_has_size_one():
    pool = make_pool("distributed")
    assert isinstance(pool, DistributedPool)
    assert pool.size == 1 and pool.is_main_process and not pool.is_distributed
    lk = Likelihood(quad, ["a", "b"], param_bounds=BOUNDS)
    pts = np.random.default_rng(1).uniform(size=(3, 2))
    np.testing.assert_array_equal(pool.run_map_objective(lk, pts),
                                  [quad(p) for p in pts])
    pool.close()


# ----------------------------------------------------- real gloo groups

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch_group(mode: str, size: int, timeout: int):
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(HERE)]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, str(r), str(size),
         str(port)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(size)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _check_group(outs, marker):
    rc0, out0, err0 = outs[0]
    assert rc0 == 0, f"rank 0 failed:\n{err0[-3000:]}"
    assert marker in out0, out0
    for r in range(1, len(outs)):
        rc, out, err = outs[r]
        assert rc == 0, f"rank {r} failed:\n{err[-3000:]}"
        assert f"WORKER_CLEAN_EXIT_{r} cuda_devices=0" in out, out
    return out0


@pytest.mark.parametrize("size", [2, 3])
def test_distributed_pool_protocol_real_group(size):
    _check_group(_launch_group("pool", size, timeout=120), "POOL_PROTOCOL_OK")


def test_dynamic_scheduling_heterogeneous_cost():
    """A batch with one slow point completes in about the slow point's time,
    and ``size`` slow points spread one per rank."""
    _check_group(_launch_group("hetero", 3, timeout=120), "HETERO_OK")


def test_server_failure_falls_back_to_static_sharding():
    _check_group(_launch_group("serverfail", 2, timeout=120),
                 "SERVERFAIL_FALLBACK_OK")


def test_bobe_loop_under_real_group():
    _check_group(_launch_group("bobe", 2, timeout=180), "BOBE_DIST_OK")


# ----------------------------------------------------- one rank's program

class _Model:
    """A stand-in Cobaya model: a Gaussian log-posterior in the unit square
    and reference draws around its peak from the caller's generator."""

    class parameterization:
        @staticmethod
        def sampled_params():
            return {"a": None, "b": None}

        @staticmethod
        def labels():
            return {"a": "a", "b": "b"}

    class prior:
        @staticmethod
        def bounds(confidence_for_unbounded=1.0):
            return np.array([[0.0, 1.0], [0.0, 1.0]])

    def logpost(self, x, make_finite=False):
        return quad(x)

    def get_valid_point(self, max_tries, ignore_fixed_ref,
                        logposterior_as_dict, random_state):
        pt = np.clip(0.5 + 0.1 * random_state.standard_normal(2), 0.0, 1.0)
        return pt, {"logpost": self.logpost(pt)}


def _install_fake_cobaya():
    import types

    cobaya = types.ModuleType("cobaya")
    cobaya_yaml = types.ModuleType("cobaya.yaml")
    cobaya_model = types.ModuleType("cobaya.model")
    cobaya_yaml.yaml_load = lambda s: {"fake": True}
    cobaya_model.get_model = lambda info: _Model()
    sys.modules.update({"cobaya": cobaya, "cobaya.yaml": cobaya_yaml,
                        "cobaya.model": cobaya_model})


def _rank_main(mode, rank, size, port):
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=size,
                            timeout=timedelta(seconds=60))
    lk = Likelihood(quad, ["a", "b"], param_bounds=BOUNDS)
    if mode == "pool":
        # the unit square's log prior volume is 0: the Cobaya adapter's
        # values are quad's
        from bobe_tpu_torch.likelihood import CobayaLikelihood

        _install_fake_cobaya()
        clk = CobayaLikelihood({"fake": True})
        pool = make_pool("auto")
        assert isinstance(pool, DistributedPool)
        assert (pool.size, pool.rank) == (size, rank) and pool._dyn
        if pool.is_main_process:
            rng = np.random.default_rng(0)
            pts1 = rng.uniform(size=(7, 2))  # not a multiple of size
            v1 = pool.run_map_objective(clk, pts1)
            assert np.array_equal(v1, [quad(p) for p in pts1]), v1
            pts2 = rng.uniform(size=(5, 2))  # the protocol is reusable
            v2 = pool.run_map_objective(clk, pts2)
            assert np.array_equal(v2, [quad(p) for p in pts2]), v2
            draws = pool.get_cobaya_initial_points(clk, 5)
            assert len(draws) == 5
            for pt, lp in draws:
                assert lp == clk(pt), (pt, lp, clk(pt))
            # the draws come from every rank's own stream: none repeats
            assert len({tuple(pt) for pt, _ in draws}) == 5
            pool.close()
            pool.close()
            print("POOL_PROTOCOL_OK", flush=True)
        else:
            pool.worker_loop(clk)
    elif mode == "hetero":
        lk_slow = Likelihood(lumpy, ["a", "b"], param_bounds=BOUNDS)
        pool = DistributedPool()
        assert pool._dyn, "dynamic task queue failed to come up"
        if pool.is_main_process:
            # 2*size - 1 instant points and one slow point, submitted first:
            # dynamic pulls keep every rank busy
            rng = np.random.default_rng(1)
            pts = np.vstack([[[0.95, 0.5]],
                             rng.uniform(0.0, 0.8, size=(2 * size - 1, 2))])
            t0 = time.time()
            vals = pool.run_map_objective(lk_slow, pts)
            wall = time.time() - t0
            assert np.array_equal(vals, [quad(p) for p in pts])
            assert wall < SLOW + 1.0, f"hetero round took {wall:.2f}s"
            # ``size`` slow points first: one per rank, not stacked on the
            # shard of one rank
            pts2 = np.vstack([np.full((size, 2), 0.95),
                              rng.uniform(0.0, 0.8, size=(size, 2))])
            t0 = time.time()
            vals2 = pool.run_map_objective(lk_slow, pts2)
            wall2 = time.time() - t0
            assert np.array_equal(vals2, [quad(p) for p in pts2])
            assert wall2 < 2 * SLOW, f"slow points serialized: {wall2:.2f}s"
            pool.close()
            print(f"HETERO_OK wall={wall:.2f} wall2={wall2:.2f}", flush=True)
        else:
            pool.worker_loop(lk_slow)
    elif mode == "serverfail":
        # rank 0's queue server fails: rank 0 still broadcasts an all-zero
        # wire, and every rank falls back to static shards
        if rank == 0:
            from multiprocessing.managers import BaseManager

            def _boom(self):
                raise RuntimeError("injected server failure")

            BaseManager.get_server = _boom
        pool = DistributedPool()
        assert not pool._dyn, "expected the static fallback"
        if pool.is_main_process:
            pts = np.random.default_rng(2).uniform(size=(5, 2))
            vals = pool.run_map_objective(lk, pts)
            assert np.array_equal(vals, [quad(p) for p in pts])
            pool.close()
            print("SERVERFAIL_FALLBACK_OK", flush=True)
        else:
            pool.worker_loop(lk)
    elif mode == "bobe":
        import tempfile

        from bobe_tpu_torch.bo import BOBE

        torch.set_num_threads(1)
        with tempfile.TemporaryDirectory() as tmp:
            kw = dict(loglikelihood=quad, param_list=["a", "b"],
                      param_bounds=BOUNDS, n_sobol_init=8, save_dir=tmp,
                      save=False, seed=7, verbosity="WARNING", device="cpu")
            bobe = BOBE(pool="distributed", **kw)
            if rank == 0:
                run_kw = dict(acq="ei", min_evals=1, max_evals=11,
                              batch_size=3, ei_goal=1e-12)
                res = bobe.run(**run_kw)
                assert bobe.batch_size == size, bobe.batch_size
                assert res["best_val"] > -5.0, res["best_val"]
                # the pool only farms out deterministic evaluations: a
                # serial run from the same seed gives the same training set
                serial = BOBE(pool="serial", **kw).run(**run_kw)
                got = res["gp"].train_y_raw.numpy()
                assert np.array_equal(got,
                                      serial["gp"].train_y_raw.numpy()), got
                print(f"BOBE_DIST_OK best={res['best_val']:.4f} "
                      f"n={len(got)}", flush=True)
            else:
                # a worker rank serves inside the constructor and returns
                # from run() at once
                assert bobe.run() is None
    else:
        raise SystemExit(f"unknown mode {mode}")
    if rank > 0:
        print(f"WORKER_CLEAN_EXIT_{rank} "
              f"cuda_devices={torch.cuda.device_count()}", flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
