"""bobe_tpu_torch: the PyTorch/CUDA port of bobe_tpu."""
from . import config  # noqa: F401
