"""Client side of the persistent device server (bobe_tpu_torch/server.py).

Counterpart of ``bobe_tpu/client.py``. A process in client mode keeps its
likelihood callable and its own evaluation pool; the server holds the card
and runs the BO loop, sending likelihood batches back over the socket.
Client mode is on when ``BOBE_TPU_SERVER=/path/to.sock`` is set (any BOBE
script then runs through the server unchanged) or for ``BOBE(server=...)``:
``BOBE(...)`` is then a ``ServerBOBE``, defined here. Under
``BOBE_TPU_SERVER`` the package's ``BOBE`` is this class, importing the
package imports no torch and the card is hidden from the process
(``CUDA_VISIBLE_DEVICES=""``), so a client pays neither torch's import nor
CUDA's start.

Auto-spawn: if the socket does not answer a ping, the client starts
``python -m bobe_tpu_torch.server`` itself, detached and with a one-hour
idle timeout so that a forgotten server frees the card, and waits for it.
The first run against a new server pays the cold start once; later runs,
from any number of new client processes, do not.

This module imports no torch, and server.py (the frames) only when it
talks to a server, so that ``python -m bobe_tpu_torch.server`` finds that
module unloaded. The GP of a run's results is rebuilt from its state dict
on the CPU at its first use, so a client that never looks at it never
imports torch.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
import traceback
from typing import Any, Dict, Optional

import numpy as np

from .utils.log import get_logger

log = get_logger("client")

PACKAGE = "bobe_tpu_torch"
DEFAULT_SOCKET = "/tmp/bobe_tpu_torch.sock"

# idle timeout of an auto-spawned server: long enough to span a session of
# runs, short enough that a forgotten server frees the card within the hour
_AUTOSPAWN_IDLE_S = 3600.0


def client_mode() -> bool:
    """True in a process that runs BOBE through a device server:
    ``BOBE_TPU_SERVER`` is set and the process is not the server."""
    return (bool(os.environ.get("BOBE_TPU_SERVER"))
            and os.environ.get("BOBE_TPU_SERVER_ROLE") != "server")


def _connect(socket_path: str, timeout_s: float = 10.0) -> socket.socket:
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(timeout_s)
    s.connect(socket_path)
    s.settimeout(None)  # a run blocks for as long as the server computes
    return s


def ping(socket_path: str, timeout_s: float = 5.0) -> Optional[Dict[str, Any]]:
    """The server's pong payload, or None if it does not answer."""
    from .server import recv_frame, send_frame

    try:
        with _connect(socket_path, timeout_s) as s:
            send_frame(s, {"op": "ping"})
            rep = recv_frame(s)
            return rep if rep.get("op") == "pong" else None
    except (OSError, ConnectionError, EOFError):
        return None


def shutdown(socket_path: str, timeout_s: float = 10.0) -> bool:
    """Ask the server to exit. Returns True if it acknowledged."""
    from .server import recv_frame, send_frame

    try:
        with _connect(socket_path, timeout_s) as s:
            send_frame(s, {"op": "shutdown"})
            return recv_frame(s).get("op") == "bye"
    except (OSError, ConnectionError, EOFError):
        return False


def _checked(pong: Dict[str, Any], socket_path: str) -> Dict[str, Any]:
    """The pong of a server of this package; raises for any other (the
    JAX package's server names no package)."""
    if pong.get("package") != PACKAGE:
        raise RuntimeError(
            f"the server at {socket_path} is not a {PACKAGE} server (its "
            f"pong names package {pong.get('package')!r}); point "
            f"BOBE_TPU_SERVER at a socket of python -m {PACKAGE}.server")
    return pong


def ensure_server(socket_path: str = DEFAULT_SOCKET, spawn: bool = True,
                  boot_timeout_s: float = 900.0,
                  extra_args: Optional[list] = None) -> Dict[str, Any]:
    """Ping the server; spawn one if none answers (and ``spawn``). Returns
    the pong payload. Raises RuntimeError if no server of this package can
    be reached."""
    pong = ping(socket_path)
    if pong is not None:
        return _checked(pong, socket_path)
    if not spawn:
        raise RuntimeError(f"no device server at {socket_path} "
                           f"(auto-spawn disabled)")
    env = dict(os.environ)
    # the child is the server, not a client: it gets the card back only
    # where this package hid it (the marker); a CUDA_VISIBLE_DEVICES the
    # user set stays as it is
    env.pop("BOBE_TPU_SERVER", None)
    if env.pop("BOBE_TPU_CLIENT_PINNED", None) and \
            env.get("CUDA_VISIBLE_DEVICES") == "":
        env.pop("CUDA_VISIBLE_DEVICES")
    env["BOBE_TPU_SERVER_ROLE"] = "server"
    # the server imports this package from where the client found it
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    cmd = [sys.executable, "-m", f"{PACKAGE}.server", "--socket", socket_path,
           "--idle-timeout", str(_AUTOSPAWN_IDLE_S)] + list(extra_args or [])
    log.info(f"spawning device server: {' '.join(cmd)}")
    # detached: the server outlives this client, that is its purpose
    subprocess.Popen(cmd, env=env, start_new_session=True,
                     stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    t0 = time.time()
    while time.time() - t0 < boot_timeout_s:
        pong = ping(socket_path)
        if pong is not None:
            log.info(f"device server up (pid {pong.get('pid')}, "
                     f"{time.time() - t0:.1f} s)")
            return _checked(pong, socket_path)
        time.sleep(0.5)
    raise RuntimeError(f"device server did not come up on {socket_path} "
                       f"within {boot_timeout_s:.0f} s")


class ServerBOBE:
    """``BOBE`` as a client of a device server: what ``BOBE(...)`` is with
    ``server=`` or ``BOBE_TPU_SERVER`` set.

    The constructor builds the likelihood and the evaluation pool as BOBE
    does and captures the other arguments, which go to the server's BOBE as
    they were given (its defaults hold for the rest; those after
    ``confidence_for_unbounded`` are keywords). ``run()`` runs
    ``BOBE(...).run(...)`` on the server, which sends each batch of points
    back to this process's pool, and returns a results dict with the keys
    of an in-process run. On the ranks other than 0 of a distributed pool
    the constructor serves evaluations until rank 0 closes the pool, as
    BOBE's does. Nothing here imports torch or touches a device."""

    def __init__(self, loglikelihood, param_list=None, param_bounds=None,
                 param_labels=None, likelihood_name=None,
                 confidence_for_unbounded: float = 0.9999995, *,
                 pool="auto", server: Optional[str] = None, **init):
        from .likelihood import make_likelihood
        from .parallel.pool import make_pool
        from .utils.log import update_verbosity
        from .utils.seed import set_global_seed

        update_verbosity(init.get("verbosity", "INFO"))
        self.pool = make_pool(pool) if isinstance(pool, str) else pool
        self.is_main = self.pool.is_main_process
        try:
            self.loglikelihood = make_likelihood(
                loglikelihood, param_list, param_bounds, param_labels,
                likelihood_name, confidence_for_unbounded,
                init.get("minus_inf", -1e10))
            self.ndim = len(self.loglikelihood.param_list)
            if not self.is_main:
                set_global_seed(init.get("seed"))
                self.pool.worker_loop(self.loglikelihood)
                return
        except BaseException:
            self.pool.close()
            raise
        self._server_socket = str(server or os.environ["BOBE_TPU_SERVER"])
        self._server_autospawn = os.environ.get(
            "BOBE_TPU_SERVER_AUTOSPAWN", "1") != "0"
        # plain data for the wire; the save directory is this process's
        # (BOBE's default is the working directory)
        for k in ("init_train_x", "init_train_y"):
            if init.get(k) is not None:
                init[k] = np.asarray(init[k])
        init["save_dir"] = os.path.abspath(init.get("save_dir", "."))
        if init.get("device") is not None:
            init["device"] = str(init["device"])
        self._server_init = init
        self.results_dict, self.samples_dict = {}, {}

    @property
    def gp(self):
        """The last run's GP, rebuilt from the server's state on the CPU at
        the first read (ServerResults); None before a run."""
        return self.results_dict.get("gp") if self.results_dict else None

    def run(self, *args, **kwargs):
        if not self.is_main:
            return None
        try:
            return run_on_server(self, args, kwargs)
        finally:
            self.pool.close()


def _cobaya_points(pool, likelihood, n: int, rng_state):
    """``n`` Cobaya reference draws from this process's pool, with the
    server's generator (its state crosses the wire): the draws of an
    in-process run. Returns the draws and the generator's new state."""
    rng = np.random.Generator(getattr(np.random, rng_state["bit_generator"])())
    rng.bit_generator.state = rng_state
    pts = pool.get_cobaya_initial_points(likelihood, n, rng=rng)
    return pts, rng.bit_generator.state


def run_on_server(bobe: ServerBOBE, run_args, run_kwargs: Dict[str, Any]
                  ) -> Dict[str, Any]:
    """Run ``BOBE(...).run(*run_args, **run_kwargs)`` on the device server
    for ``bobe`` (its likelihood, pool and captured constructor arguments).
    Serves the likelihood callbacks until the server reports the run done,
    then returns a results dict with the keys of an in-process run."""
    from .server import recv_frame, send_frame

    sock_path = bobe._server_socket
    ensure_server(sock_path, spawn=bobe._server_autospawn)
    likelihood, pool = bobe.loglikelihood, bobe.pool
    req = {
        "op": "run",
        "init": bobe._server_init,
        "run": dict(run_kwargs),
        "run_args": list(run_args),
        # this process's BOBE_TPU_* knobs, so that a run behaves the same
        # with and without a server (server.ENV_TOPOLOGY_KEYS are not sent
        # on)
        "env": {k: v for k, v in os.environ.items()
                if k.startswith("BOBE_TPU_")},
        "likelihood": {
            "param_list": list(likelihood.param_list),
            "param_bounds": np.asarray(likelihood.param_bounds),
            "param_labels": list(likelihood.param_labels),
            "name": likelihood.name,
            "minus_inf": float(likelihood.minus_inf),
            # the server's run then draws the Cobaya reference points,
            # here (the cobaya_points callback)
            "is_cobaya": bool(likelihood.is_cobaya),
        },
    }
    with _connect(sock_path) as s:
        send_frame(s, req)
        while True:
            msg = recv_frame(s)
            op = msg.get("op")
            if op == "eval":
                try:
                    vals = pool.run_map_objective(likelihood, msg["points"])
                    send_frame(s, {"op": "eval_result",
                                   "values": np.asarray(vals)})
                except Exception:
                    send_frame(s, {"op": "eval_result", "values": None,
                                   "error": traceback.format_exc()})
            elif op == "cobaya_points":
                try:
                    pts, state = _cobaya_points(pool, likelihood, msg["n"],
                                                msg["rng_state"])
                    send_frame(s, {"op": "cobaya_points_result",
                                   "points": pts, "rng_state": state})
                except Exception:
                    send_frame(s, {"op": "cobaya_points_result",
                                   "points": None,
                                   "error": traceback.format_exc()})
            elif op == "done":
                return _rebuild_results(bobe, msg["results"])
            elif op == "error":
                raise RuntimeError("device-server run failed:\n"
                                   + msg.get("traceback", "<no traceback>"))
            else:
                raise RuntimeError(f"protocol error: unexpected op {op!r}")


def _rebuild_gp(gp_class: Optional[str], gp_state):
    """The GP of a server run, on the CPU (the card is the server's), with
    the server's factor and alphas, so that it predicts what the server's
    GP predicts."""
    if gp_state is None:
        return None
    from .models.gp import restore_factor

    if gp_class == "GPwithClassifier":
        from .models.clf_gp import GPwithClassifier as cls
    else:
        from .models.gp import GP as cls
    try:
        gp = cls.from_state_dict(gp_state, device="cpu")
        restore_factor(gp, gp_state)
        return gp
    except Exception as e:
        log.warning(f"could not rebuild the GP from the server's state: "
                    f"{e!r}")
        return None


class ServerResults(dict):
    """The results dict of a server run. Its ``"gp"`` is rebuilt from the
    server's state dict (``gp_state``, numpy) at the first read of that key
    (which imports torch); until then it holds None."""

    def __init__(self, data, gp_class, gp_state):
        super().__init__(data)
        self.gp_state = gp_state
        self._gp_pending = (gp_class, gp_state)

    def _resolve(self, key):
        if key == "gp" and self._gp_pending is not None:
            gp_class, gp_state = self._gp_pending
            self._gp_pending = None
            dict.__setitem__(self, "gp", _rebuild_gp(gp_class, gp_state))

    def __getitem__(self, key):
        self._resolve(key)
        return dict.__getitem__(self, key)

    def get(self, key, default=None):
        self._resolve(key)
        return dict.get(self, key, default)

    def values(self):
        self._resolve("gp")
        return dict.values(self)

    def items(self):
        self._resolve("gp")
        return dict.items(self)

    def copy(self):
        self._resolve("gp")
        return dict(self)


def _rebuild_results(bobe, wire: Dict[str, Any]) -> Dict[str, Any]:
    """The client's results dict, with the keys of an in-process run."""
    results = ServerResults({
        "gp": None,
        "likelihood": bobe.loglikelihood,
        "results_manager": None,  # reloadable from the save_path files
        "best_val": wire.get("best_val"),
        "best_pt": wire.get("best_pt"),
        "logz": wire.get("logz", {}),
        "termination_reason": wire.get("termination_reason"),
        "samples": wire.get("samples", {}),
        "save_path": wire.get("save_path"),
    }, wire.get("gp_class"), wire.get("gp_state"))
    bobe.results_dict = results
    bobe.samples_dict = results["samples"]
    return results
