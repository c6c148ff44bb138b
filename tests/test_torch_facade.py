"""The port's public facade: every name of tests/test_facade.py's list on
``bobe_tpu_torch``, no CUDA call at import, and the public helpers held to
the JAX package's on the same inputs (numpy, from a seed)."""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

import bobe_tpu
import bobe_tpu_torch
from bobe_tpu.bo import load_gp_statedict as jax_load_gp_statedict
from bobe_tpu.models.gp import GP as JaxGP
from bobe_tpu.utils import core as jcore
from bobe_tpu.utils import seed as jseed
from bobe_tpu_torch.bo import load_gp_statedict
from bobe_tpu_torch.utils import core as tcore
from bobe_tpu_torch.utils import seed as tseed
from test_facade import REFERENCE_EXPORTS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_reference_exports_present():
    for name in REFERENCE_EXPORTS:
        assert hasattr(bobe_tpu_torch, name), f"missing facade export: {name}"
        if name != "__version__":
            assert name in bobe_tpu_torch.__all__, f"{name} not in __all__"


def test_all_names_resolve_and_match_the_jax_package():
    assert sorted(bobe_tpu_torch.__all__) == sorted(bobe_tpu.__all__)
    for name in bobe_tpu_torch.__all__:
        assert getattr(bobe_tpu_torch, name, None) is not None, name


def test_version_is_pep440ish():
    parts = bobe_tpu_torch.__version__.split(".")
    assert len(parts) >= 2 and all(p.isdigit() for p in parts[:2])


def test_logger_namespace():
    assert bobe_tpu_torch.get_logger("zzz").name == "bobe_tpu_torch.zzz"


def test_scaling_helpers_match():
    bounds = np.array([[-2.0, 0.0], [4.0, 10.0]])
    x = np.random.default_rng(0).uniform(-2.0, 4.0, size=(9, 2))
    u = bobe_tpu_torch.scale_to_unit(x, bounds)
    np.testing.assert_array_equal(u, np.asarray(bobe_tpu.scale_to_unit(x, bounds)))
    np.testing.assert_allclose(bobe_tpu_torch.scale_from_unit(u, bounds), x,
                               rtol=1e-12)


def test_importing_the_facade_makes_no_cuda_call():
    """Every entry into torch.cuda that could initialise it raises in the
    child; importing the facade must still succeed."""
    code = (
        "import torch\n"
        "def boom(*a, **k):\n"
        "    raise RuntimeError('CUDA touched at import')\n"
        "for name in ('_lazy_init', 'init', 'is_available', 'device_count',\n"
        "             'current_device', 'set_device', 'get_device_name'):\n"
        "    setattr(torch.cuda, name, boom)\n"
        "import bobe_tpu_torch\n"
        "from bobe_tpu_torch import BOBE, CobayaLikelihood, GP\n"
        "print('IMPORT_OK', torch.cuda.is_initialized())\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "IMPORT_OK False" in out.stdout


def test_kl_divergence_samples_matches():
    rng = np.random.default_rng(3)
    prev = rng.normal(-5.0, 2.0, size=400)
    curr = prev + rng.normal(0.0, 0.3, size=400)
    got = tcore.kl_divergence_samples(prev, curr)
    want = jcore.kl_divergence_samples(prev, curr)
    assert set(got) == {"forward", "reverse", "symmetric"}
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12)
    assert got["symmetric"] > 0


def test_suppress_stdout_stderr_silences_both(capfd):
    for mod in (tcore, jcore):
        with mod.suppress_stdout_stderr():
            print("this should vanish")
            print("this too", file=sys.stderr)
    out, err = capfd.readouterr()
    assert "vanish" not in out and "too" not in err


@pytest.mark.parametrize("var", [None, "SLURM_JOB_ID", "PMI_RANK"])
def test_is_cluster_environment_matches(monkeypatch, var):
    for v in ("SLURM_JOB_ID", "PBS_JOBID", "LSB_JOBID", "SGE_TASK_ID",
              "COBALT_JOBID", "MOAB_JOBID", "OMPI_COMM_WORLD_SIZE",
              "PMI_RANK"):
        monkeypatch.delenv(v, raising=False)
    if var is not None:
        monkeypatch.setenv(var, "17")
    got = tcore.is_cluster_environment()
    assert got == jcore.is_cluster_environment()
    if var is not None:
        assert got is True


def test_ensure_reproducibility_matches():
    assert tseed.ensure_reproducibility(11) == jseed.ensure_reproducibility(11)
    np.testing.assert_array_equal(tseed.get_numpy_rng().random(5),
                                  jseed.get_numpy_rng().random(5))


def test_load_gp_statedict_predicts_like_the_jax_gp():
    rng = np.random.default_rng(2)
    x = rng.uniform(size=(40, 3))
    y = -np.sum((x - 0.4) ** 2, 1) * 8.0 + 0.01 * rng.standard_normal(40)
    jg = JaxGP(train_x=jnp.asarray(x), train_y=jnp.asarray(y),
               lengthscales=jnp.asarray([0.3, 0.5, 0.7]),
               kernel_variance=2.0)
    sd = jg.state_dict()
    tg = load_gp_statedict(sd, clf=False, device="cpu")
    assert tg.npoints == 40 and tg.state.x.device.type == "cpu"
    q = rng.uniform(size=(64, 3))
    mean, var = tg.predict_batched(q)
    jmean, jvar = jg.predict_batched(jnp.asarray(q))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-9)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), rtol=1e-9)
    # the JAX package's own loader of the same dict, for the record
    assert jax_load_gp_statedict(sd, clf=False).npoints == 40
