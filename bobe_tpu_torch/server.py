"""Persistent device server: one long-lived process that holds the card, the
imported modules and the built kernels, and runs BOBE for short-lived
client processes.

Counterpart of ``bobe_tpu/server.py``. What a fresh process pays before its
first useful step on the card is the imports (torch and this package), the
start of CUDA, the kernel library's load and the first calls of each
operation; a warm server pays them once at boot, and every later run, from
any number of client processes, reuses them. The client imports neither
torch nor CUDA (bobe_tpu_torch/__init__.py), so it skips both.

Architecture
------------
* The server owns the device and runs the full BO loop
  (``bobe_tpu_torch.bo.BOBE``) per request: a run on the server is the same
  code path as a run in process.
* The user's likelihood never crosses the wire as code. The client keeps its
  callable; the server sends each batch of points back to the client
  (``_CallbackPool``), which maps them over its own pool.
* Transport: length-prefixed pickle frames over a Unix-domain socket, made
  with mode 0600. Same host, same user only: pickle is not safe across trust
  boundaries, and anyone who can write to the socket can already run code
  as this user. Every frame holds only numpy arrays and plain Python (the GP
  goes back as its ``state_dict()``), so a client unpickles it without torch.
* One run at a time; further clients wait in the listen backlog.

Usage::

    # terminal 1 (or spawned by the client, see bobe_tpu_torch.client)
    python -m bobe_tpu_torch.server --socket /tmp/bobe_tpu_torch.sock

    # terminal 2..n: any BOBE script, unchanged, plus one variable
    BOBE_TPU_SERVER=/tmp/bobe_tpu_torch.sock python my_run.py

A server started by hand must not have ``BOBE_TPU_SERVER`` set (or must set
``BOBE_TPU_SERVER_ROLE=server``): with it, importing the package hides the
card from the process as it does for a client, and ``serve()`` refuses to
start rather than serve CPU math.
"""
from __future__ import annotations

import argparse
import os
import pickle
import socket
import struct
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .client import DEFAULT_SOCKET, PACKAGE

_LEN = struct.Struct(">Q")
# a corrupted length prefix must fail at once, not attempt a huge
# allocation; 1 GiB bounds every legitimate frame (the largest are nested
# sampling payloads, tens of MB)
_MAX_FRAME = 1 << 30


def send_frame(sock: socket.socket, obj: Any) -> None:
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_LEN.pack(len(data)) + data)


def recv_frame(sock: socket.socket) -> Any:
    header = _recv_exact(sock, _LEN.size)
    (n,) = _LEN.unpack(header)
    if n > _MAX_FRAME:
        raise ConnectionError(f"frame length {n} exceeds the {_MAX_FRAME} cap")
    return pickle.loads(_recv_exact(sock, n))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        buf.extend(chunk)
    return bytes(buf)


class _CallbackPool:
    """Evaluation pool that evaluates likelihood batches on the CLIENT.

    It has the surface BOBE uses of an ``EvalPool``; each batch crosses the
    socket once each way, so the client's own pool (serial or
    multiprocess) spreads its points as it would in process."""

    size = 1
    is_main_process = True
    is_mpi = False
    is_distributed = False

    def __init__(self, conn: socket.socket):
        self._conn = conn

    def run_map_objective(self, likelihood, points) -> np.ndarray:
        points = np.atleast_2d(np.asarray(points, dtype=np.float64))
        send_frame(self._conn, {"op": "eval", "points": points})
        rep = recv_frame(self._conn)
        if rep.get("op") != "eval_result":
            raise RuntimeError(f"protocol error: expected eval_result, "
                               f"got {rep.get('op')!r}")
        if rep.get("error"):
            raise RuntimeError("client-side likelihood evaluation failed:\n"
                               + rep["error"])
        vals = np.asarray(rep["values"], dtype=np.float64).reshape(-1)
        if vals.shape[0] != points.shape[0]:
            raise RuntimeError(f"client returned {vals.shape[0]} values for "
                               f"{points.shape[0]} points")
        return vals

    def get_cobaya_initial_points(self, likelihood, n_points: int, rng=None
                                  ) -> List[Tuple]:
        """The client's pool draws the points with this generator (its
        state goes over the wire and comes back advanced), so the draws
        are those of the same run in process."""
        if rng is None:
            from .utils.seed import get_numpy_rng

            rng = get_numpy_rng()
        send_frame(self._conn, {"op": "cobaya_points", "n": int(n_points),
                                "rng_state": rng.bit_generator.state})
        rep = recv_frame(self._conn)
        if rep.get("op") != "cobaya_points_result":
            raise RuntimeError(f"protocol error: expected "
                               f"cobaya_points_result, got {rep.get('op')!r}")
        if rep.get("error"):
            raise RuntimeError("client-side initial-point draw failed:\n"
                               + rep["error"])
        rng.bit_generator.state = rep["rng_state"]
        return rep["points"]

    def gp_fit(self, gp, n_restarts=8, maxiters=500, rng=None):
        return gp.fit(n_restarts=n_restarts, maxiter=maxiters, rng=rng)

    def clear_jax_caches(self):
        pass

    def close(self):
        pass


def _plain(obj):
    """``obj`` with every tensor in it as a numpy array, so that the frame
    unpickles without torch."""
    if hasattr(obj, "detach") and hasattr(obj, "cpu"):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and not hasattr(obj, "_fields"):
        return tuple(_plain(v) for v in obj)
    if isinstance(obj, list):
        return [_plain(v) for v in obj]
    return obj


def _sanitize_results(bobe) -> Dict[str, Any]:
    """The wire form of a finished run: plain data and the GP's state dict.

    The in-process results dict holds live objects (GP, Likelihood,
    BOBEResults); the client rebuilds the GP from its state dict and puts
    in its own likelihood (bobe_tpu_torch/client.py)."""
    res = bobe.results_dict or {}
    gp = getattr(bobe, "gp", None)
    return _plain({
        "logz": res.get("logz", {}),
        "samples": res.get("samples", {}),
        "best_val": res.get("best_val"),
        "best_pt": (np.asarray(res["best_pt"])
                    if res.get("best_pt") is not None else None),
        "termination_reason": res.get("termination_reason"),
        "gp_class": type(gp).__name__ if gp is not None else None,
        "gp_state": gp.state_dict() if gp is not None else None,
        "save_path": getattr(bobe, "save_path", None),
    })


# variables that define the server/client topology itself: never forwarded
ENV_TOPOLOGY_KEYS = frozenset({
    "BOBE_TPU_SERVER", "BOBE_TPU_SERVER_ROLE", "BOBE_TPU_CLIENT_PINNED",
    "BOBE_TPU_SERVER_IDLE_S", "BOBE_TPU_SERVER_SOCKET",
    "BOBE_TPU_SERVER_AUTOSPAWN",
})


def _do_run(conn: socket.socket, req: Dict[str, Any]) -> None:
    from .bo import BOBE
    from .likelihood import Likelihood

    # the client's BOBE_TPU_* knobs (NS_BOOST_CAP, NO_MESH, ...) hold for
    # this run, read from os.environ where the code reads them, and are
    # restored after it, so runs cannot leak knobs into each other
    saved_env: Dict[str, Optional[str]] = {}
    for k, v in (req.get("env") or {}).items():
        if not k.startswith("BOBE_TPU_") or k in ENV_TOPOLOGY_KEYS:
            continue
        saved_env[k] = os.environ.get(k)
        os.environ[k] = str(v)

    lik_meta = req["likelihood"]
    pool = _CallbackPool(conn)

    def _proxy_single(x):
        # a direct Likelihood call (BOBE evaluates through the pool): a
        # one-point batch over the same callback
        return float(pool.run_map_objective(None, np.asarray(x)[None, :])[0])

    likelihood = Likelihood(
        _proxy_single,
        param_list=lik_meta["param_list"],
        param_bounds=np.asarray(lik_meta["param_bounds"]),
        param_labels=lik_meta.get("param_labels"),
        name=lik_meta.get("name"),
        minus_inf=lik_meta.get("minus_inf", -1e10),
    )
    # a client's Cobaya likelihood: the run draws its reference points
    # (through the cobaya_points callback) as a run in process does
    likelihood.is_cobaya = bool(lik_meta.get("is_cobaya", False))
    try:
        bobe = BOBE(loglikelihood=likelihood, pool=pool,
                    **dict(req.get("init", {})))
        bobe.run(*req.get("run_args", ()), **dict(req.get("run", {})))
        send_frame(conn, {"op": "done", "results": _sanitize_results(bobe)})
    finally:
        for k, old in saved_env.items():
            if old is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = old


def _launch_counts() -> Dict[str, int]:
    """The Gram kernels' launches in this process so far."""
    from .ops import kernels as kr

    return {"gram_masked": kr.gram_masked.launches,
            "gram_masked_backward": kr.gram_masked_backward.launches,
            "gram_masked_backward_x": kr.gram_masked_backward_x.launches}


def _handle(conn: socket.socket, stats: Dict[str, Any]) -> bool:
    """Serve one connection. Returns False when the server should exit."""
    try:
        req = recv_frame(conn)
    except (ConnectionError, EOFError):
        return True
    op = req.get("op")
    if op == "ping":
        send_frame(conn, {"op": "pong", "package": PACKAGE,
                          "pid": os.getpid(), "device": stats["device"],
                          "runs_served": stats["runs"],
                          "uptime_s": time.time() - stats["t0"],
                          "launches": _launch_counts()})
        return True
    if op == "shutdown":
        send_frame(conn, {"op": "bye", "runs_served": stats["runs"]})
        return False
    if op == "run":
        try:
            _do_run(conn, req)
            stats["runs"] += 1
        except (ConnectionError, BrokenPipeError):
            # the client went away mid-run; the server stays up
            pass
        except Exception:
            tb = traceback.format_exc()
            try:
                send_frame(conn, {"op": "error", "traceback": tb})
            except (ConnectionError, BrokenPipeError, OSError):
                pass
        return True
    try:
        send_frame(conn, {"op": "error",
                          "traceback": f"unknown op {op!r}"})
    except (ConnectionError, BrokenPipeError, OSError):
        pass
    return True


def _touch_device(device) -> None:
    """CUDA's start, the kernel library's load and one small Gram build on
    ``device`` (the plain version on the CPU), so that they happen at boot
    and not in the first run."""
    import torch

    from . import config
    from .ops import kernels as kr

    if device.type == "cuda":
        torch.zeros(1, device=device)
        kr.build_library()
    cap, d = config.PAD_MULTIPLE, 2
    x = torch.rand((cap, d), dtype=config.DTYPE, device=device)
    mask = torch.ones(cap, dtype=config.DTYPE, device=device)
    ls = torch.ones(d, dtype=config.DTYPE, device=device)
    amp = torch.ones((), dtype=config.DTYPE, device=device)
    kr.gram_masked("rbf", x, mask, ls, amp, 1e-6)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prewarm(d: int, n: int, device) -> None:
    """The first calls of a D-dimensional run, on ``device``: a GP of n
    points built and fitted, a prediction and a short nested sampling."""
    from .models.gp import GP
    from .samplers import nested_sampling

    rng = np.random.default_rng(0)
    x = rng.uniform(size=(int(n), int(d)))
    gp = GP(train_x=x, train_y=-np.sum((x - 0.5) ** 2, axis=1) / 0.02,
            device=device)
    gp.fit(n_restarts=2, maxiter=20, rng=rng)
    gp.predict_batched(rng.uniform(size=(64, int(d))))
    nested_sampling(gp, mode="acq", nlive=50, maxcall=5000, rng=rng)


def serve(socket_path: str, prewarm_dims: Optional[List[int]] = None,
          prewarm_max_n: int = 256, idle_timeout_s: float = 0.0,
          device: str = "cuda") -> None:
    """Run the device server until shutdown (or the idle timeout, if set).

    ``device``: where the runs compute; ``cuda`` (the default) raises when
    no card is visible, so a server asked for the card never serves CPU
    math. ``idle_timeout_s`` > 0: exit after that many seconds with no
    connection, so that a forgotten server frees the card."""
    if (os.environ.get("BOBE_TPU_SERVER")
            and os.environ.get("BOBE_TPU_SERVER_ROLE") != "server"):
        raise RuntimeError(
            "BOBE_TPU_SERVER is set in this environment, so importing "
            "bobe_tpu_torch hid the card from this process (client mode). "
            "Start the server with BOBE_TPU_SERVER unset, or with "
            "BOBE_TPU_SERVER_ROLE=server.")

    from . import config
    from .utils.log import get_logger

    log = get_logger("server")
    dev = config.set_device(config.resolve_device(device))
    t0 = time.time()
    _touch_device(dev)
    log.info(f"device server: device {dev}, ready in {time.time() - t0:.1f} s")
    for d in (prewarm_dims or []):
        t0 = time.time()
        try:
            prewarm(int(d), int(prewarm_max_n), dev)
            log.info(f"boot prewarm d={d} (n={prewarm_max_n}) in "
                     f"{time.time() - t0:.1f} s")
        except Exception as e:  # prewarm is best-effort
            log.warning(f"boot prewarm d={d} failed (the server still "
                        f"serves): {e!r}")

    sock_dir = os.path.dirname(os.path.abspath(socket_path))
    os.makedirs(sock_dir, exist_ok=True)
    if os.path.exists(socket_path):
        os.unlink(socket_path)  # stale socket of a dead server
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(socket_path)
    os.chmod(socket_path, 0o600)
    srv.listen(8)
    if idle_timeout_s > 0:
        srv.settimeout(idle_timeout_s)
    log.info(f"device server listening on {socket_path} "
             f"(idle timeout {idle_timeout_s or 'none'})")
    stats = {"runs": 0, "t0": time.time(), "device": str(dev)}
    try:
        while True:
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                log.info(f"idle for {idle_timeout_s:.0f} s; exiting "
                         f"({stats['runs']} runs served)")
                break
            # an accepted connection blocks for as long as a run computes,
            # whatever the listener's idle timeout
            conn.settimeout(None)
            with conn:
                if not _handle(conn, stats):
                    log.info(f"shutdown requested "
                             f"({stats['runs']} runs served)")
                    break
    finally:
        srv.close()
        if os.path.exists(socket_path):
            os.unlink(socket_path)


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--socket", default=os.environ.get(
        "BOBE_TPU_SERVER_SOCKET", DEFAULT_SOCKET))
    p.add_argument("--prewarm-d", type=int, action="append", default=[],
                   metavar="D", help="warm the first calls of D-dimensional "
                   "runs at boot (repeatable)")
    p.add_argument("--prewarm-max-n", type=int, default=256,
                   help="training-set size of the prewarm GP")
    p.add_argument("--idle-timeout", type=float, default=float(
        os.environ.get("BOBE_TPU_SERVER_IDLE_S", "0")),
        help="exit after this many idle seconds (0 = never)")
    p.add_argument("--device", default="cuda",
                   help="where the runs compute: cuda (default), cuda:N or "
                   "cpu")
    args = p.parse_args(argv)
    serve(args.socket, prewarm_dims=args.prewarm_d,
          prewarm_max_n=args.prewarm_max_n,
          idle_timeout_s=args.idle_timeout, device=args.device)


if __name__ == "__main__":
    main()
