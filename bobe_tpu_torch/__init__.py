"""bobe_tpu_torch: the PyTorch/CUDA port of bobe_tpu.

Bayesian Optimisation for Bayesian Evidence on an NVIDIA GPU: a Gaussian-
process surrogate of an expensive log-likelihood, evidence-weighted
acquisition, and nested sampling / HMC over the surrogate for the evidence
(logZ) and posterior samples. The public names are those of ``bobe_tpu``.

Importing the package touches no device: CUDA is initialised, and the
kernels are built, at the first operation on a CUDA tensor.
"""
from . import config  # noqa: F401  (float64, TF32 off, the default device)
from .acquisition import (EI, WIPV, AcquisitionFunction, LogEI, WIPStd,
                          get_mc_points, get_mc_samples)
from .bo import BOBE, load_gp_file
from .likelihood import CobayaLikelihood, Likelihood
from .models.classifiers import CLASSIFIER_REGISTRY
from .models.clf_gp import GPwithClassifier
from .models.gp import GP, GPState, GPTrainConfig
from .samplers import nested_sampling, sample_gp_ensemble, sample_gp_nuts
from .utils.core import scale_from_unit, scale_to_unit
from .utils.log import get_logger, setup_logging
from .utils.plot import BOBESummaryPlotter
from .utils.results import BOBEResults

__version__ = "0.1.0"

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
