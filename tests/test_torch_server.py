"""The port's device server and client (bobe_tpu_torch/server.py,
client.py) on the CPU.

A real server subprocess (``python -m bobe_tpu_torch.server --device cpu``)
serves runs of this test process, which keeps the likelihood. A run served
there is the same code on the same device with the same seed as a run in
this process, so the two must agree: an EI run (tests/test_server.py's
checks for the JAX package) and an NS-mode WIPStd banana run, the port's
main path. Both processes use two CPU threads, so their reductions split
the same way. The in-process port runs are held to the JAX package by
tests/test_torch_bo.py and tests/test_torch_ei.py.
"""
import json
import os
import socket
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from bobe_tpu_torch import client as tclient
from bobe_tpu_torch import server as tserver
from bobe_tpu_torch.models import gp as tgp
from bobe_tpu_torch.models import toys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def server_socket(tmp_path_factory):
    base = tmp_path_factory.mktemp("srv")
    sock = str(base / "bobe_torch.sock")
    env = dict(os.environ)
    env.pop("BOBE_TPU_SERVER", None)
    env["BOBE_TPU_SERVER_ROLE"] = "server"
    env["OMP_NUM_THREADS"] = "2"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    # the server's output goes to a file: an undrained pipe would block it
    logf = open(base / "server.log", "w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "bobe_tpu_torch.server", "--socket", sock,
         "--idle-timeout", "600", "--device", "cpu"],
        env=env, cwd=REPO, stdout=logf, stderr=subprocess.STDOUT, text=True)
    t0 = time.time()
    while tclient.ping(sock) is None:
        if proc.poll() is not None:
            logf.seek(0)
            pytest.fail(f"server died at boot:\n{logf.read()[-4000:]}")
        if time.time() - t0 > 120:
            proc.kill()
            pytest.fail("server did not come up in 120 s")
        time.sleep(0.2)
    yield sock
    tclient.shutdown(sock)
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
    logf.close()


def _bobe(tmp_path, loglikelihood=toys.rosenbrock, server=None, **kw):
    from bobe_tpu_torch.bo import BOBE

    names = kw.pop("param_list", toys.rosenbrock_names)
    bounds = kw.pop("param_bounds", toys.rosenbrock_bounds)
    args = dict(loglikelihood=loglikelihood, param_list=names,
                param_bounds=bounds, likelihood_name="srv_port",
                n_sobol_init=8, seed=3, save=False, save_dir=str(tmp_path),
                verbosity="WARNING", pool="serial", device="cpu",
                server=server)
    args.update(kw)
    return BOBE(**args)


def _ei_run(tmp_path, server=None):
    bobe = _bobe(tmp_path, server=server)
    return bobe.run(acq="logei", max_evals=12, max_gp_size=40,
                    ei_goal=1e-8, convergence_n_iters=1, fit_n_points=4)


def _banana_run(tmp_path, server=None):
    bobe = _bobe(tmp_path, loglikelihood=toys.banana,
                 param_list=toys.banana_names,
                 param_bounds=toys.banana_bounds, seed=7, server=server)
    return bobe.run(acq="wipstd", mc_points_method="NS", min_evals=8,
                    max_evals=16, max_gp_size=40, logz_threshold=0.5,
                    batch_size=4, fit_n_points=4, ns_n_points=4,
                    mc_points_size=32)


def test_ping_names_the_package(server_socket):
    pong = tclient.ping(server_socket)
    assert pong is not None and pong["op"] == "pong"
    assert pong["package"] == "bobe_tpu_torch"
    assert pong["device"] == "cpu"
    assert isinstance(pong["pid"], int) and pong["pid"] != os.getpid()
    assert tclient.ensure_server(server_socket, spawn=False)["pid"] == \
        pong["pid"]


def test_ei_run_parity(server_socket, tmp_path):
    res_srv = _ei_run(tmp_path / "srv", server=server_socket)
    res_loc = _ei_run(tmp_path / "loc")
    for key in ("gp", "likelihood", "results_manager", "best_val", "best_pt",
                "logz", "termination_reason", "samples", "save_path"):
        assert key in res_srv
    assert res_srv["samples"] == {} and res_srv["logz"] == {}
    assert res_srv["termination_reason"] == res_loc["termination_reason"]
    np.testing.assert_allclose(res_srv["best_val"], res_loc["best_val"],
                               rtol=1e-10)
    np.testing.assert_allclose(np.asarray(res_srv["best_pt"]),
                               np.asarray(res_loc["best_pt"]), rtol=1e-8)
    # the GP comes back rebuilt from the server's state dict, on the CPU
    gp = res_srv["gp"]
    assert gp is not None and gp.device.type == "cpu"
    assert gp.npoints == res_loc["gp"].npoints
    xs = np.linspace(0.1, 0.9, 5)[:, None] * np.ones((5, 2))
    np.testing.assert_allclose(gp.predict_mean_batched(xs).numpy(),
                               res_loc["gp"].predict_mean_batched(xs).numpy(),
                               rtol=1e-8)
    assert tclient.ping(server_socket)["runs_served"] >= 1


def test_ns_wipstd_banana_run_parity(server_socket, tmp_path):
    """The port's main path (WIPStd, NS-mode MC pool, convergence NS)
    through the server equals the same run in process."""
    res_srv = _banana_run(tmp_path / "srv", server=server_socket)
    res_loc = _banana_run(tmp_path / "loc")
    assert np.isfinite(res_loc["logz"]["mean"])
    assert res_srv["termination_reason"] == res_loc["termination_reason"]
    for k in ("mean", "upper", "lower", "dlogz_sampler"):
        np.testing.assert_allclose(res_srv["logz"][k], res_loc["logz"][k],
                                   rtol=1e-9, err_msg=k)
    np.testing.assert_allclose(res_srv["samples"]["x"],
                               res_loc["samples"]["x"], rtol=1e-9)
    assert res_srv["gp"].npoints == res_loc["gp"].npoints == 16


class _StandInModel:
    """A stand-in Cobaya model: a 2-d Gaussian log-posterior on a box, with
    a reference distribution around its mean; each reference draw is
    recorded with the process that made it."""

    mu, sig = np.array([0.4, -0.3]), np.array([0.3, 0.25])
    draws = []

    def __init__(self):
        self.parameterization = types.SimpleNamespace(
            sampled_params=lambda: {"a": None, "b": None},
            labels=lambda: {"a": "a", "b": "b"})
        self.prior = types.SimpleNamespace(
            bounds=lambda confidence_for_unbounded=1.0:
            np.array([[-1.0, 2.0], [-2.0, 1.0]]))

    def logpost(self, x, make_finite=False):
        return float(-0.5 * np.sum(((np.asarray(x) - self.mu) / self.sig)
                                   ** 2))

    def get_valid_point(self, max_tries, ignore_fixed_ref,
                        logposterior_as_dict, random_state):
        pt = self.mu + 0.5 * self.sig * random_state.standard_normal(2)
        self.draws.append(os.getpid())
        return pt, {"logpost": self.logpost(pt)}


@pytest.fixture()
def stand_in_cobaya(monkeypatch):
    cobaya = types.ModuleType("cobaya")
    cobaya_yaml = types.ModuleType("cobaya.yaml")
    cobaya_model = types.ModuleType("cobaya.model")
    cobaya_yaml.yaml_load = lambda s: {"stand_in": True}
    cobaya_model.get_model = lambda info: _StandInModel()
    monkeypatch.setitem(sys.modules, "cobaya", cobaya)
    monkeypatch.setitem(sys.modules, "cobaya.yaml", cobaya_yaml)
    monkeypatch.setitem(sys.modules, "cobaya.model", cobaya_model)
    _StandInModel.draws.clear()
    yield _StandInModel.draws


def test_cobaya_run_draws_its_reference_points_through_the_server(
        server_socket, tmp_path, stand_in_cobaya):
    """A Cobaya likelihood run through the server draws its n_cobaya_init
    reference points in this process, with the server's generator, so its
    initial design, and the run, equal the same run in process."""
    res = {}
    for where, srv in (("srv", server_socket), ("loc", None)):
        bobe = _bobe(tmp_path / where, loglikelihood={"stand_in": True},
                     param_list=None, param_bounds=None, n_cobaya_init=3,
                     seed=5, server=srv)
        res[where] = bobe.run(acq="logei", max_evals=12, max_gp_size=40,
                              ei_goal=1e-8, convergence_n_iters=1,
                              fit_n_points=4)
    assert stand_in_cobaya == [os.getpid()] * 6
    x_srv = np.asarray(res["srv"].gp_state["train_x"])
    x_loc = res["loc"]["gp"].train_x.numpy()
    assert x_srv.shape == x_loc.shape and x_srv.shape[0] >= 8 + 3
    np.testing.assert_allclose(x_srv[:11], x_loc[:11], rtol=1e-12)
    np.testing.assert_allclose(x_srv, x_loc, rtol=1e-10)
    np.testing.assert_allclose(res["srv"]["best_val"], res["loc"]["best_val"],
                               rtol=1e-10)


def test_rebuilt_gp_keeps_the_servers_factor():
    """The client's GP takes the server's Cholesky factor, alphas and
    standardization from the state dict instead of factorizing again, so
    it predicts what the server's GP predicts."""
    rng = np.random.default_rng(8)
    x = rng.uniform(size=(14, 2))
    gp = tgp.GP(train_x=x, train_y=-np.sum((x - 0.4) ** 2, axis=1) / 0.05,
                noise=1e-6, lengthscales=np.array([0.3, 0.4]),
                kernel_variance=2.0, device="cpu")
    state = gp.state_dict()
    got = tclient._rebuild_gp("GP", state)
    assert torch.equal(got.cholesky, gp.cholesky)
    assert torch.equal(got.alphas, gp.alphas)
    xs = rng.uniform(size=(5, 2))
    assert torch.equal(got.predict_mean_batched(xs),
                       gp.predict_mean_batched(xs))
    # a factor no refactorization makes: it is the one the GP keeps
    state["alphas"] = state["alphas"] * (1.0 + 1e-6)
    got = tclient._rebuild_gp("GP", state)
    np.testing.assert_array_equal(got.alphas.numpy(), state["alphas"])


def test_client_evaluates_likelihood_locally(server_socket, tmp_path):
    """The user's callable runs in THIS process: a closure counter ticks
    once per evaluation."""
    calls = {"n": 0, "pids": set()}

    def quad(x):
        calls["n"] += 1
        calls["pids"].add(os.getpid())
        return -float(np.sum((np.asarray(x) - 0.3) ** 2)) * 20.0

    bobe = _bobe(tmp_path, loglikelihood=quad, param_list=["a", "b"],
                 param_bounds=np.array([[0.0, 0.0], [1.0, 1.0]]), seed=7,
                 server=server_socket)
    res = bobe.run(acq="logei", max_evals=10, max_gp_size=32, ei_goal=1e-8,
                   fit_n_points=4)
    assert calls["n"] >= res["gp"].npoints >= 10
    assert calls["pids"] == {os.getpid()}
    assert bobe.gp is res["gp"]
    assert res["best_val"] > -20.0


def test_a_client_process_runs_without_torch(server_socket, tmp_path):
    """A fresh process with BOBE_TPU_SERVER set runs BOBE through the
    server with no torch module loaded: every frame it unpickles is numpy
    and plain Python. Reading its results' GP then imports torch and
    rebuilds the GP on the CPU, with the card hidden."""
    code = (
        "import json, sys\n"
        "import numpy as np\n"
        "from bobe_tpu_torch import BOBE\n"
        "from bobe_tpu_torch.models import toys\n"
        "calls = [0]\n"
        "def f(x):\n"
        "    calls[0] += 1\n"
        "    return toys.rosenbrock(x)\n"
        "res = BOBE(f, param_list=toys.rosenbrock_names,\n"
        "           param_bounds=toys.rosenbrock_bounds, n_sobol_init=8,\n"
        "           seed=3, save=False, verbosity='WARNING',\n"
        "           device='cpu').run(acq='logei', max_evals=10,\n"
        "                             ei_goal=1e-8, fit_n_points=4)\n"
        "out = {'torch': sorted(m for m in sys.modules\n"
        "                       if m.split('.')[0] == 'torch'),\n"
        "       'calls': calls[0], 'best': float(res['best_val'])}\n"
        "gp = res['gp']\n"
        "import torch, os\n"
        "out.update(n=gp.npoints, dev=str(gp.device),\n"
        "           cvd=os.environ['CUDA_VISIBLE_DEVICES'],\n"
        "           cuda=torch.cuda.is_initialized())\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, BOBE_TPU_SERVER=server_socket)
    for k in ("BOBE_TPU_SERVER_ROLE", "CUDA_VISIBLE_DEVICES"):
        env.pop(k, None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["torch"] == []
    assert res["calls"] >= res["n"] >= 10 and np.isfinite(res["best"])
    assert res["dev"] == "cpu" and res["cvd"] == "" and not res["cuda"]


def test_run_error_propagates_and_server_stays_up(server_socket, tmp_path):
    bobe = _bobe(tmp_path, server=server_socket)
    with pytest.raises(RuntimeError, match="device-server run failed"):
        bobe.run(acq="not_an_acquisition", max_evals=8)
    assert tclient.ping(server_socket) is not None


def test_ensure_server_spawns_a_detached_server(tmp_path, monkeypatch):
    """No server at the socket: the client starts ``python -m
    bobe_tpu_torch.server`` itself (here with ``--device cpu``), detached
    and with the one-hour idle timeout, and the package's card pin is not
    passed on to it."""
    sock = str(tmp_path / "spawned.sock")
    monkeypatch.setenv("BOBE_TPU_SERVER", sock)
    monkeypatch.setenv("BOBE_TPU_CLIENT_PINNED", "1")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    pong = tclient.ensure_server(sock, extra_args=["--device", "cpu"],
                                 boot_timeout_s=120)
    try:
        assert pong["package"] == "bobe_tpu_torch" and pong["device"] == "cpu"
        assert pong["pid"] != os.getpid() and pong["runs_served"] == 0
        with open(f"/proc/{pong['pid']}/environ", "rb") as f:
            child_env = dict(kv.split(b"=", 1) for kv in f.read().split(b"\0")
                             if b"=" in kv)
        assert b"BOBE_TPU_SERVER" not in child_env
        assert b"BOBE_TPU_CLIENT_PINNED" not in child_env
        assert b"CUDA_VISIBLE_DEVICES" not in child_env
        assert child_env[b"BOBE_TPU_SERVER_ROLE"] == b"server"
        with open(f"/proc/{pong['pid']}/cmdline", "rb") as f:
            assert b"3600.0" in f.read().split(b"\0")
    finally:
        assert tclient.shutdown(sock)
    t0 = time.time()
    while os.path.exists(sock) and time.time() - t0 < 30:
        time.sleep(0.1)
    assert not os.path.exists(sock)


def test_ensure_server_rejects_missing_without_spawn(tmp_path):
    with pytest.raises(RuntimeError, match="auto-spawn disabled"):
        tclient.ensure_server(str(tmp_path / "nope.sock"), spawn=False)


class _FakeServer:
    """A one-thread server on a Unix socket that answers ping with
    ``pong`` and a run with an empty result, keeping each run request."""

    def __init__(self, path, pong):
        self.path, self.pong, self.requests = path, pong, []
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.bind(path)
        self.sock.listen(4)
        self.sock.settimeout(0.2)
        self.stop = False
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def _loop(self):
        while not self.stop:
            try:
                conn, _ = self.sock.accept()
            except socket.timeout:
                continue
            with conn:
                req = tserver.recv_frame(conn)
                if req["op"] == "ping":
                    tserver.send_frame(conn, self.pong)
                elif req["op"] == "run":
                    self.requests.append(req)
                    tserver.send_frame(conn, {"op": "done", "results": {
                        "logz": {}, "samples": {}, "best_val": 1.0,
                        "best_pt": np.zeros(2), "termination_reason": "x",
                        "gp_class": None, "gp_state": None,
                        "save_path": None}})

    def close(self):
        self.stop = True
        self.thread.join(5)
        self.sock.close()


def test_client_refuses_a_server_of_another_package(tmp_path):
    """The JAX package's server answers ping without a package; a client of
    the port refuses it, and a server naming another package."""
    for pong in ({"op": "pong", "pid": 1, "runs_served": 0},
                 {"op": "pong", "package": "bobe_tpu", "pid": 1}):
        fake = _FakeServer(str(tmp_path / "fake.sock"), pong)
        try:
            with pytest.raises(RuntimeError, match="not a bobe_tpu_torch"):
                tclient.ensure_server(fake.path, spawn=False)
            bobe = _bobe(tmp_path, server=fake.path)
            with pytest.raises(RuntimeError, match="not a bobe_tpu_torch"):
                bobe.run(acq="logei", max_evals=8)
            assert fake.requests == []
        finally:
            fake.close()
            os.unlink(fake.path)


def test_client_forwards_runtime_knobs_but_not_topology(tmp_path,
                                                        monkeypatch):
    """The client sends its BOBE_TPU_* variables with the run, its captured
    constructor arguments (device included) and its likelihood's
    metadata."""
    fake = _FakeServer(str(tmp_path / "fake.sock"),
                       {"op": "pong", "package": "bobe_tpu_torch", "pid": 1})
    try:
        monkeypatch.setenv("BOBE_TPU_TEST_KNOB", "7")
        bobe = _bobe(tmp_path, server=fake.path, seed=11)
        res = bobe.run(acq="logei", max_evals=8)
        (req,) = fake.requests
        assert req["env"]["BOBE_TPU_TEST_KNOB"] == "7"
        assert req["init"]["seed"] == 11 and req["init"]["device"] == "cpu"
        assert req["run"]["acq"] == "logei" and req["run"]["max_evals"] == 8
        assert req["likelihood"]["param_list"] == toys.rosenbrock_names
        assert res["best_val"] == 1.0 and res["gp"] is None
    finally:
        fake.close()


def test_server_applies_knobs_for_the_run_and_restores_them(monkeypatch):
    """server._do_run sets the client's BOBE_TPU_* variables for the run,
    never a topology variable, and restores the environment after it."""
    import bobe_tpu_torch.bo as tbo

    seen = {}

    class FakeBOBE:
        results_dict = {}
        gp = None

        def __init__(self, loglikelihood, pool, **init):
            seen["init"] = init

        def run(self, **kw):
            seen["knob"] = os.environ.get("BOBE_TPU_TEST_KNOB")
            seen["server"] = os.environ.get("BOBE_TPU_SERVER")
            seen["kept"] = os.environ.get("BOBE_TPU_TEST_KEPT")

    monkeypatch.setattr(tbo, "BOBE", FakeBOBE)
    monkeypatch.delenv("BOBE_TPU_TEST_KNOB", raising=False)
    monkeypatch.delenv("BOBE_TPU_SERVER", raising=False)
    monkeypatch.setenv("BOBE_TPU_TEST_KEPT", "server")
    a, b = socket.socketpair()
    try:
        tserver._do_run(a, {
            "init": {"seed": 1}, "run": {},
            "env": {"BOBE_TPU_TEST_KNOB": "3", "BOBE_TPU_TEST_KEPT": "client",
                    "BOBE_TPU_SERVER": "/elsewhere.sock", "HOME": "/x"},
            "likelihood": {"param_list": ["a"],
                           "param_bounds": np.array([[0.0], [1.0]])}})
        done = tserver.recv_frame(b)
    finally:
        a.close()
        b.close()
    assert done["op"] == "done" and done["results"]["gp_state"] is None
    assert seen == {"init": {"seed": 1}, "knob": "3", "server": None,
                    "kept": "client"}
    assert "BOBE_TPU_TEST_KNOB" not in os.environ
    assert os.environ["BOBE_TPU_TEST_KEPT"] == "server"
    assert os.environ.get("HOME") != "/x"


def test_server_refuses_to_start_in_client_mode(monkeypatch, tmp_path):
    monkeypatch.setenv("BOBE_TPU_SERVER", str(tmp_path / "x.sock"))
    monkeypatch.delenv("BOBE_TPU_SERVER_ROLE", raising=False)
    with pytest.raises(RuntimeError, match="BOBE_TPU_SERVER is set"):
        tserver.serve(str(tmp_path / "y.sock"), device="cpu")


def test_server_asked_for_the_card_without_one_raises(tmp_path):
    """A server asked for cuda where no card is visible never serves CPU
    math: it raises before it listens."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA card is visible"):
        tserver.serve(str(tmp_path / "z.sock"), device="cuda")
    assert not os.path.exists(tmp_path / "z.sock")
