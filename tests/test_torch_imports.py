"""Import hygiene of the PyTorch port: bobe_tpu_torch never imports JAX, its
libraries, scikit-learn or the JAX package, and importing it builds nothing.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "bobe_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "optax", "sklearn", "bobe_tpu")


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_sources_import_no_jax():
    offenders = []
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for mod in _imported_modules(tree):
            top = mod.split(".")[0]
            if top in FORBIDDEN:
                offenders.append(f"{path.relative_to(REPO)}: {mod}")
    assert not offenders, offenders


def test_importing_the_port_adds_no_jax_module_and_builds_nothing():
    """Compare sys.modules before and after the import: the interpreter may
    have imported jax at start-up already."""
    code = (
        "import json, sys\n"
        "before = set(sys.modules)\n"
        "import bobe_tpu_torch\n"
        "import bobe_tpu_torch.bo, bobe_tpu_torch.ops.kernels as kr\n"
        "added = sorted(m for m in set(sys.modules) - before\n"
        "               if m.split('.')[0] in ('jax', 'jaxlib', 'optax',\n"
        "                                      'sklearn', 'bobe_tpu'))\n"
        "print(json.dumps({'added': added, 'lib': bool(kr._LIBS),\n"
        "                  'built': bool(kr.build_info)}))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"added": [], "lib": False, "built": False}


def test_classifier_modules_import_neither_sklearn_nor_optax():
    """The classifier path carries its own SVM solver (SMO) and trains with
    torch.optim.AdamW: its modules name neither scikit-learn nor optax, and
    importing them (and the samplers that gate with them) adds neither."""
    for rel in ("models/classifiers.py", "models/clf_gp.py", "samplers.py",
                "infer/nested.py"):
        tree = ast.parse((PORT / rel).read_text())
        tops = {m.split(".")[0] for m in _imported_modules(tree)}
        assert not tops & set(FORBIDDEN), (rel, tops & set(FORBIDDEN))
    code = (
        "import json, sys\n"
        "before = set(sys.modules)\n"
        "import bobe_tpu_torch.models.clf_gp, bobe_tpu_torch.samplers\n"
        "added = sorted(m for m in set(sys.modules) - before\n"
        "               if m.split('.')[0] in ('sklearn', 'optax', 'jax'))\n"
        "print(json.dumps(added))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_new_modules_import_no_jax_and_plots_import_matplotlib_lazily():
    """The modules of the GP options, EI, resume, plots and the pool name
    no JAX, optax, scikit-learn or JAX-package module; importing them adds
    none, imports no matplotlib (the plots import it when they draw, so the
    port runs where it is not installed) and no cloudpickle (the pool
    imports it when it starts)."""
    rels = ("ops/special.py", "ops/optimize.py", "ops/mll.py",
            "models/gp.py", "acquisition.py", "bo.py", "utils/plot.py",
            "utils/results.py", "parallel/pool.py")
    for rel in rels:
        tree = ast.parse((PORT / rel).read_text())
        tops = {m.split(".")[0] for m in _imported_modules(tree)}
        assert not tops & set(FORBIDDEN), (rel, tops & set(FORBIDDEN))
    code = (
        "import json, sys\n"
        "before = set(sys.modules)\n"
        "import bobe_tpu_torch.ops.special, bobe_tpu_torch.utils.plot\n"
        "import bobe_tpu_torch.parallel.pool, bobe_tpu_torch.acquisition\n"
        "added = sorted(m for m in set(sys.modules) - before\n"
        "               if m.split('.')[0] in ('jax', 'jaxlib', 'optax',\n"
        "                                      'sklearn', 'bobe_tpu',\n"
        "                                      'matplotlib', 'cloudpickle'))\n"
        "print(json.dumps(added))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _run(code, extra_env=None, drop=()):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    for k in drop:
        env.pop(k, None)
    env.update(extra_env or {})
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_server_client_and_mesh_import_no_jax():
    """The device server, its client and the mesh name no JAX, optax,
    scikit-learn or JAX-package module, and importing them adds none."""
    for rel in ("server.py", "client.py", "parallel/mesh.py"):
        tree = ast.parse((PORT / rel).read_text())
        tops = {m.split(".")[0] for m in _imported_modules(tree)}
        assert not tops & set(FORBIDDEN), (rel, tops & set(FORBIDDEN))
    code = (
        "import json, sys\n"
        "before = set(sys.modules)\n"
        "import bobe_tpu_torch.server, bobe_tpu_torch.client\n"
        "import bobe_tpu_torch.parallel.mesh\n"
        "added = sorted(m for m in set(sys.modules) - before\n"
        "               if m.split('.')[0] in ('jax', 'jaxlib', 'optax',\n"
        "                                      'sklearn', 'bobe_tpu'))\n"
        "print(json.dumps(added))\n")
    assert _run(code) == []


@pytest.mark.parametrize("visible", [None, "3"])
def test_client_mode_imports_no_torch_and_hides_the_card(visible):
    """With BOBE_TPU_SERVER set, ``from bobe_tpu_torch import BOBE`` (and
    the client path's modules, and a client's construction) loads no torch
    module; the package hides the card (CUDA_VISIBLE_DEVICES="", with the
    marker the client strips from a server it spawns) only where the user
    did not set the variable."""
    code = (
        "import json, os, sys\n"
        "from bobe_tpu_torch import BOBE, Likelihood\n"
        "import bobe_tpu_torch.client\n"
        "import bobe_tpu_torch.likelihood, bobe_tpu_torch.parallel.pool\n"
        "import bobe_tpu_torch.utils.log, bobe_tpu_torch.utils.seed as s\n"
        "s.set_global_seed(3)\n"
        "p = bobe_tpu_torch.parallel.pool.make_pool('auto')\n"
        "b = BOBE(lambda x: 0.0, param_list=['a'],\n"
        "         param_bounds=[[0.0], [1.0]], seed=3, save=False)\n"
        "print(json.dumps({\n"
        "    'bobe': type(b).__name__,\n"
        "    'torch': sorted(m for m in sys.modules\n"
        "                    if m.split('.')[0] == 'torch'),\n"
        "    'pool': type(p).__name__,\n"
        "    'cvd': os.environ.get('CUDA_VISIBLE_DEVICES'),\n"
        "    'pinned': os.environ.get('BOBE_TPU_CLIENT_PINNED')}))\n")
    env = {"BOBE_TPU_SERVER": "/nonexistent/bobe.sock"}
    if visible is not None:
        env["CUDA_VISIBLE_DEVICES"] = visible
    res = _run(code, env, drop=("CUDA_VISIBLE_DEVICES", "BOBE_TPU_SERVER_ROLE",
                                "BOBE_TPU_CLIENT_PINNED"))
    assert res["torch"] == [] and res["pool"] == "SerialPool"
    assert res["bobe"] == "ServerBOBE"
    if visible is None:
        assert res["cvd"] == "" and res["pinned"] == "1"
    else:
        assert res["cvd"] == visible and res["pinned"] is None


def test_the_server_role_imports_the_package_as_usual():
    """The server itself (BOBE_TPU_SERVER_ROLE=server) is no client: the
    package loads torch and keeps the card visible."""
    code = (
        "import json, os, sys\n"
        "import bobe_tpu_torch\n"
        "print(json.dumps({'torch': 'torch' in sys.modules,\n"
        "                  'cvd': os.environ.get('CUDA_VISIBLE_DEVICES'),\n"
        "                  'gp': bobe_tpu_torch.GP.__name__}))\n")
    res = _run(code, {"BOBE_TPU_SERVER": "/nonexistent/bobe.sock",
                      "BOBE_TPU_SERVER_ROLE": "server"},
               drop=("CUDA_VISIBLE_DEVICES",))
    assert res == {"torch": True, "cvd": None, "gp": "GP"}
