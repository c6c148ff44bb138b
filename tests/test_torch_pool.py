"""The port's MultiprocessPool on the CPU: results in the order of the
points, fail-fast errors, a likelihood defined at module level and a closure
(through cloudpickle, and without it through pickle, where the closure
raises at pool start instead of running in-process), workers that see no
CUDA device, make_pool's kinds, and a BOBE run whose batch values equal the
serial pool's."""
import os
import sys

import numpy as np
import pytest

from bobe_tpu_torch.bo import BOBE
from bobe_tpu_torch.models import toys
from bobe_tpu_torch.parallel import pool as tpool


def square_sum(x):
    """A module-level likelihood: pickles by reference."""
    return -float(np.sum(np.asarray(x) ** 2))


def fail_on_negative(x):
    if x[0] < 0:
        raise ValueError(f"negative point {x[0]}")
    return float(x[0])


def cuda_view(x):
    """What a worker sees of CUDA: the variable, and torch's device count."""
    import torch

    return float(len(os.environ.get("CUDA_VISIBLE_DEVICES", "x"))
                 + 10 * torch.cuda.device_count())


@pytest.fixture(scope="module")
def mp_pool():
    p = tpool.MultiprocessPool(n_workers=2, seed=1)
    yield p
    p.close()


def test_results_keep_the_order_of_the_points(mp_pool):
    pts = np.random.default_rng(0).normal(size=(17, 3))
    got = mp_pool.run_map_objective(square_sum, pts)
    np.testing.assert_array_equal(
        got, tpool.SerialPool().run_map_objective(square_sum, pts))
    # a single point goes to a worker too
    assert mp_pool.run_map_objective(square_sum, pts[:1])[0] == \
        square_sum(pts[0])


def test_a_worker_error_fails_fast(mp_pool):
    pts = np.array([[1.0], [2.0], [-1.0], [3.0]])
    with pytest.raises(ValueError, match="negative point"):
        mp_pool.run_map_objective(fail_on_negative, pts)


def test_closure_through_cloudpickle(mp_pool):
    pytest.importorskip("cloudpickle")
    scale = 3.0
    closure = lambda x: scale * float(np.sum(x))  # noqa: E731
    pts = np.arange(12.0).reshape(6, 2)
    np.testing.assert_array_equal(mp_pool.run_map_objective(closure, pts),
                                  [scale * np.sum(p) for p in pts])


def test_without_cloudpickle_a_closure_raises_at_pool_start(monkeypatch):
    """Without cloudpickle the payload goes through pickle: a module-level
    likelihood still runs in the workers; a closure raises TypeError naming
    why, before any evaluation, and is not evaluated in-process."""
    monkeypatch.setitem(sys.modules, "cloudpickle", None)
    mp_pool = tpool.MultiprocessPool(n_workers=2)
    request_close = mp_pool.close
    pts = np.arange(6.0).reshape(3, 2)
    np.testing.assert_array_equal(mp_pool.run_map_objective(square_sum, pts),
                                  [square_sum(p) for p in pts])
    calls = []

    def closure(x):
        calls.append(1)
        return 0.0

    with pytest.raises(TypeError, match="does not pickle"):
        mp_pool.run_map_objective(closure, pts)
    assert calls == []
    request_close()


def test_workers_see_no_cuda_device(mp_pool):
    got = mp_pool.run_map_objective(cuda_view, np.zeros((4, 1)))
    # CUDA_VISIBLE_DEVICES is "" (length 0) and torch counts no device
    np.testing.assert_array_equal(got, np.zeros(4))


def test_make_pool_kinds():
    assert isinstance(tpool.make_pool("serial"), tpool.SerialPool)
    mp = tpool.make_pool("multiprocess", n_workers=3)
    assert isinstance(mp, tpool.MultiprocessPool) and mp.size == 3
    mp.close()
    # outside a torch.distributed job the distributed pool has size 1
    dp = tpool.make_pool("distributed")
    assert isinstance(dp, tpool.DistributedPool) and dp.size == 1
    assert isinstance(tpool.make_pool("auto"), tpool.SerialPool)
    with pytest.raises(ValueError):
        tpool.make_pool("threads")


def test_bobe_with_the_multiprocess_pool_matches_the_serial_pool(tmp_path):
    """The initial design and one WIPStd batch through 2 worker processes
    give the values the serial pool gives at the same points."""
    like, bounds, _ = toys.make_gaussian(2, sigma=0.15)
    kw = dict(loglikelihood=like, param_list=["a", "b"], param_bounds=bounds,
              likelihood_name="pool_port", n_sobol_init=8, seed=3,
              save=False, verbosity="WARNING", device="cpu")
    mp = tpool.MultiprocessPool(n_workers=2)
    bobe = BOBE(pool=mp, **kw)
    serial = BOBE(pool="serial", **kw)
    np.testing.assert_array_equal(bobe.gp.train_y_raw.numpy(),
                                  serial.gp.train_y_raw.numpy())
    pts = np.random.default_rng(4).uniform(size=(4, 2))
    got = bobe.evaluate_likelihood(pts, step=1)
    want = serial.evaluate_likelihood(pts, step=1)
    np.testing.assert_array_equal(got, want)
    mp.close()
