"""Global configuration for bobe_tpu_torch.

The port computes in float64 throughout. The JAX package splits float32 fits
and sweeps from float64 state, and routes float64 fits to the host, only
because its TPU has no native float64; an H100 has float64 in hardware, so
none of that split is ported.

Matrix products in float32 must not silently drop to TF32 on the card: this
module sets ``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False`` when it is imported. The Gram
kernel's float32 variant (kept for comparison with the TPU kernel's own type)
is compared against float64 with the float32 tolerance.

Device: every GP state lives on one device, chosen by :func:`set_device` (or
the ``device=`` keyword of ``BOBE``/``GP``). The default is ``cuda``; without
a visible card :func:`resolve_device` raises rather than run on the CPU
unasked, so a run on the CPU says ``device="cpu"``.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DTYPE = torch.float64

# Row-count padding granularity for GP buffers. Padded capacities keep the
# identity pad block of the JAX package (ops/kernels.py), so states and npz
# files carry over between the two packages unchanged.
PAD_MULTIPLE = 128

# Floor used when clipping predicted variances.
SAFE_NOISE_FLOOR = 1e-12

_DEVICE: torch.device | None = None


def set_device(device) -> torch.device:
    """Set the default device for new GP states ('cuda', 'cuda:1', 'cpu')."""
    global _DEVICE
    _DEVICE = torch.device(device)
    return _DEVICE


def get_device() -> torch.device:
    """The default device: the one set last, else cuda."""
    if _DEVICE is not None:
        return _DEVICE
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``device``, else the default; raises when that is a CUDA device and no
    card is visible."""
    dev = torch.device(device) if device is not None else get_device()
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"bobe_tpu_torch: device {dev} requested (the default is cuda) "
            'but no CUDA card is visible; pass device="cpu" (or call '
            'config.set_device("cpu")) to run on the CPU')
    return dev


# Largest batch one batched-predict call may carry: the NS evidence bounds
# predict at every dead point, and a single call at that size builds a
# (cap, m) cross kernel plus its solve. Larger batches are split.
PREDICT_CHUNK = 16384

