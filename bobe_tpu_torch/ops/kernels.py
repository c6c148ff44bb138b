"""GP covariance kernels on padded, masked buffers.

Counterpart of ``bobe_tpu/ops/kernels.py`` and of its Pallas kernel
``bobe_tpu/ops/pallas_gram.py``. Buffers are padded to a capacity that is a
multiple of ``config.PAD_MULTIPLE``; pad rows and columns of a Gram matrix
are the identity (``K[i,i]=1, K[i,j]=0``), so the padded Cholesky factor is
``[[L, 0], [0, I]]`` and downstream solves need no masking (ops/chol.py).

:func:`gram_masked` is the masked Gram build of every GP refresh. On a CUDA
tensor it launches the hand-written kernel ``csrc/gram_masked.cu`` (built
with ``nvcc`` at first use, bound with ``ctypes``) or raises; on a CPU tensor
it computes the plain PyTorch version :func:`gram_masked_plain`.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from .. import config

SQRT5 = math.sqrt(5.0)

_KINDS = {"rbf": 0, "matern": 1}


def sq_dist(xa, xb):
    """Pairwise squared Euclidean distances, (n1, d) x (n2, d) -> (n1, n2),
    by the matmul expansion; tiny negatives from cancellation are clamped."""
    a2 = torch.sum(xa * xa, dim=-1)[..., :, None]
    b2 = torch.sum(xb * xb, dim=-1)[..., None, :]
    ab = xa @ xb.transpose(-1, -2)
    return torch.clamp(a2 + b2 - 2.0 * ab, min=0.0)


def _corr(name: str, dsq):
    """Correlation (unit-variance kernel) from squared scaled distances."""
    if name == "rbf":
        return torch.exp(-0.5 * dsq)
    elif name == "matern":
        d = torch.sqrt(torch.clamp(dsq, min=1e-30))
        return (1.0 + SQRT5 * d + (5.0 / 3.0) * dsq) * torch.exp(-SQRT5 * d)
    raise ValueError(f"Unknown kernel '{name}' (expected 'rbf' or 'matern')")


def cross_kernel(name, xa, xb, lengthscales, kernel_variance):
    """Dense cross-covariance K(xa, xb), no noise, no masking."""
    dsq = sq_dist(xa / lengthscales, xb / lengthscales)
    return kernel_variance * _corr(name, dsq)


def kernel_diag(n, kernel_variance, noise, include_noise=True, dtype=None,
                device=None):
    """Diagonal of K(x, x): constant amplitude (+ noise)."""
    diag = kernel_variance * torch.ones((n,), dtype=dtype or config.DTYPE,
                                        device=device)
    if include_noise:
        diag = diag + noise
    return diag


def sq_dist_perdim(x):
    """Per-dimension pairwise squared differences: (cap, d) -> (d, cap, cap).

    Hyperparameter-independent, so the fit computes it once and every MLL
    evaluation reduces to a weighted sum over d slabs plus the nonlinearity.
    Exact differences (no matmul-expansion cancellation)."""
    xt = x.T
    diff = xt[:, :, None] - xt[:, None, :]
    return diff * diff


def gram_masked_perdim(name, dsq_perdim, mask, lengthscales, kernel_variance,
                       noise):
    """gram_masked built from precomputed per-dimension squared distances.

    Batched over leading dimensions of ``lengthscales`` (..., d) and
    ``kernel_variance`` (...): returns (..., cap, cap). Differentiable."""
    w = 1.0 / (lengthscales * lengthscales)
    dsq = torch.tensordot(w, dsq_perdim, dims=1)
    amp = torch.as_tensor(kernel_variance, dtype=dsq.dtype, device=dsq.device)
    k = amp[..., None, None] * _corr(name, dsq)
    mm = mask[:, None] * mask[None, :]
    eye = torch.eye(dsq.shape[-1], dtype=k.dtype, device=k.device)
    return k * mm + (noise * mask + (1.0 - mask)) * eye


def gram_masked_plain(name, x, mask, lengthscales, kernel_variance, noise):
    """Plain PyTorch padded Gram matrix with identity pad block (the
    reference the CUDA kernel is held to; mirrors bobe_tpu's XLA build).

    x: (cap, d) padded inputs; mask: (cap,) 1.0 for active rows.
    Returns K with K[active,active] = k(x,x) + noise*I, K[pad,pad] = I,
    and zero cross blocks."""
    k = cross_kernel(name, x, x, lengthscales, kernel_variance)
    mm = mask[:, None] * mask[None, :]
    eye = torch.eye(x.shape[0], dtype=k.dtype, device=k.device)
    return k * mm + (noise * mask + (1.0 - mask)) * eye


def gram_masked(name, x, mask, lengthscales, kernel_variance, noise):
    """Padded training Gram matrix with identity pad block.

    On a CPU tensor: :func:`gram_masked_plain`. On a CUDA tensor: the
    hand-written kernel (csrc/gram_masked.cu), float32 or float64, or an
    exception — never a silent fallback. The kernel is forward-only: with
    gradients enabled and an input that requires grad it raises.
    ``gram_masked.launches`` counts kernel launches.
    """
    if x.device.type == "cpu":
        return gram_masked_plain(name, x, mask, lengthscales, kernel_variance,
                                 noise)
    if x.device.type != "cuda":
        raise ValueError(f"gram_masked: unsupported device {x.device}")
    return _gram_masked_cuda(name, x, mask, lengthscales, kernel_variance,
                             noise)


gram_masked.launches = 0


def cross_kernel_masked(name, x_train, mask, xq, lengthscales, kernel_variance):
    """K(x_train, xq) with pad training rows zeroed: (cap, m)."""
    k = cross_kernel(name, x_train, xq, lengthscales, kernel_variance)
    return k * mask[:, None]


# ---------------------------------------------------------------- CUDA kernel

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "gram_masked.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "bobe_tpu_torch"
_LIB = None
_LIB_LOCK = threading.Lock()
# filled by the build: library path, seconds, and the compiler's output
build_info: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("gram_masked: nvcc not found (set CUDA_HOME)")
    return found


def build_library() -> ctypes.CDLL:
    """Compile csrc/gram_masked.cu for sm_90a (once per source hash) and
    load it. Raises on a failed build."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        src = _SRC.read_bytes()
        tag = hashlib.sha256(src).hexdigest()[:16]
        so = _BUILD_DIR / f"libgram_masked_{tag}.so"
        t0 = time.time()
        log_text = ""
        if not so.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                   "-Xptxas", "-v", "-o", str(tmp), str(_SRC)]
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=900)
            log_text = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"gram_masked: nvcc failed ({proc.returncode}):\n"
                    f"{log_text}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        ptr = ctypes.c_void_p
        for fn in (lib.bobe_gram_masked_f64, lib.bobe_gram_masked_f32):
            fn.argtypes = [ptr, ptr, ptr, ptr, ctypes.c_double, ptr,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int, ptr]
            fn.restype = ctypes.c_int
        build_info.update(path=str(so), seconds=time.time() - t0,
                          log=log_text)
        _LIB = lib
        return lib


def _gram_masked_cuda(name, x, mask, lengthscales, kernel_variance, noise):
    if name not in _KINDS:
        raise ValueError(f"Unknown kernel '{name}' (expected 'rbf' or "
                         "'matern')")
    if isinstance(noise, torch.Tensor):
        raise TypeError("gram_masked: noise must be a host float on CUDA")
    dt = x.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"gram_masked: dtype {dt} not supported")
    amp = torch.as_tensor(kernel_variance, dtype=dt, device=x.device)
    tensors = (x, mask, lengthscales, amp)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise config.not_ported("Differentiating through the CUDA Gram kernel",
                                "gram_backward")
    if x.dim() != 2:
        raise ValueError(f"gram_masked: x must be (cap, d), got {tuple(x.shape)}")
    cap, d = x.shape
    if mask.shape != (cap,) or lengthscales.shape != (d,) or amp.numel() != 1:
        raise ValueError(
            f"gram_masked: shapes x {tuple(x.shape)}, mask "
            f"{tuple(mask.shape)}, lengthscales {tuple(lengthscales.shape)}, "
            f"amp {tuple(amp.shape)} do not match")
    for t in tensors:
        if t.dtype != dt or t.device != x.device:
            raise ValueError("gram_masked: inputs must share dtype and device")
        if not t.is_contiguous():
            raise ValueError("gram_masked: inputs must be contiguous")
    lib = build_library()
    fn = lib.bobe_gram_masked_f64 if dt == torch.float64 \
        else lib.bobe_gram_masked_f32
    out = torch.empty((cap, cap), dtype=dt, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), mask.data_ptr(), lengthscales.data_ptr(),
                 amp.data_ptr(), float(noise), out.data_ptr(), cap, d,
                 _KINDS[name], stream)
    if err != 0:
        raise RuntimeError(f"gram_masked: kernel launch failed "
                           f"(cudaError_t {err})")
    gram_masked.launches += 1
    return out
