"""bobe_tpu_torch: the PyTorch/CUDA port of bobe_tpu.

Bayesian Optimisation for Bayesian Evidence on an NVIDIA GPU: a Gaussian-
process surrogate of an expensive log-likelihood, evidence-weighted
acquisition, and nested sampling / HMC over the surrogate for the evidence
(logZ) and posterior samples. The public names are those of ``bobe_tpu``.

Importing the package touches no device: CUDA is initialised, and the
kernels are built, at the first operation on a CUDA tensor.

Device-server client mode (server.py, client.py): with ``BOBE_TPU_SERVER``
set (and ``BOBE_TPU_SERVER_ROLE`` not ``server``) the server holds the card
and this process only evaluates likelihoods. Importing the package then
hides the card from the process (``CUDA_VISIBLE_DEVICES=""``, unless the
user set it) and imports no torch: ``BOBE`` (then ``client.ServerBOBE``),
the likelihoods and the logging helpers load at once, every other name at
its first use.
"""
import importlib as _importlib
import os as _os

from .client import client_mode as _client_mode

if _client_mode():
    if "CUDA_VISIBLE_DEVICES" not in _os.environ:
        _os.environ["CUDA_VISIBLE_DEVICES"] = ""
        # the marker tells client.ensure_server that the package set it, so
        # that a server it spawns gets the card back
        _os.environ["BOBE_TPU_CLIENT_PINNED"] = "1"

from .likelihood import CobayaLikelihood, Likelihood  # noqa: E402
from .utils.log import get_logger, setup_logging  # noqa: E402

__version__ = "0.1.0"


def _device_names() -> dict:
    """The public names that import torch."""
    from . import config
    from .acquisition import (EI, WIPV, AcquisitionFunction, LogEI, WIPStd,
                              get_mc_points, get_mc_samples)
    from .bo import BOBE, load_gp_file
    from .models.classifiers import CLASSIFIER_REGISTRY
    from .models.clf_gp import GPwithClassifier
    from .models.gp import GP, GPState, GPTrainConfig
    from .samplers import nested_sampling, sample_gp_ensemble, sample_gp_nuts
    from .utils.core import scale_from_unit, scale_to_unit
    from .utils.plot import BOBESummaryPlotter
    from .utils.results import BOBEResults

    return dict(locals())


if _client_mode():
    # the client's BOBE; the other names load at their first use
    from .client import ServerBOBE as BOBE

    def __getattr__(name):
        if name not in __all__:
            raise AttributeError(
                f"module {__name__!r} has no attribute {name!r}")
        if name == "config":
            # the one public submodule: the package's own modules import it
            # (``from .. import config``) on the way to the other names
            return _importlib.import_module(".config", __name__)
        names = _device_names()
        names.pop("BOBE")
        globals().update(names)
        return names[name]
else:
    globals().update(_device_names())

__all__ = [
    "BOBE",
    "GP",
    "GPState",
    "GPTrainConfig",
    "GPwithClassifier",
    "Likelihood",
    "CobayaLikelihood",
    "EI",
    "LogEI",
    "WIPV",
    "WIPStd",
    "AcquisitionFunction",
    "BOBEResults",
    "CLASSIFIER_REGISTRY",
    "nested_sampling",
    "sample_gp_nuts",
    "sample_gp_ensemble",
    "get_mc_samples",
    "get_mc_points",
    "load_gp_file",
    "config",
    "BOBESummaryPlotter",
    "get_logger",
    "setup_logging",
    "scale_to_unit",
    "scale_from_unit",
]
