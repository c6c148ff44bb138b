"""GP covariance kernels on padded, masked buffers.

Counterpart of ``bobe_tpu/ops/kernels.py`` and of its Pallas kernel
``bobe_tpu/ops/pallas_gram.py``. Buffers are padded to a capacity that is a
multiple of ``config.PAD_MULTIPLE``; pad rows and columns of a Gram matrix
are the identity (``K[i,i]=1, K[i,j]=0``), so the padded Cholesky factor is
``[[L, 0], [0, I]]`` and downstream solves need no masking (ops/chol.py).

:func:`gram_masked` is the masked Gram build of every GP refresh and, above
the per-dimension memory budget of the fit (and in every fit of an input-
warped GP), of every MLL objective over the restart lanes. Its coordinates
are shared by the lanes, (cap, d), or one set per lane, (R, cap, d) (the
warp). It is differentiable in the hyperparameters and in the coordinates
(:class:`GramMasked`). On a CUDA tensor its forward and backward launch the
hand-written kernels of ``csrc/gram_masked.cu`` (built with ``nvcc`` at first
use, bound with ``ctypes``) or raise; on a CPU tensor they compute the plain
PyTorch versions :func:`gram_masked_plain` and
:func:`gram_masked_backward_plain`.
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

    x: (cap, d) padded inputs, or (R, cap, d) one set per lane; mask: (cap,)
    1.0 for active rows. Batched over leading dimensions of
    ``lengthscales`` (..., d) and ``kernel_variance`` (...): returns
    (..., cap, cap), every lane with K[active,active] = k(x,x) + noise*I,
    K[pad,pad] = I and zero cross blocks."""
    amp = torch.as_tensor(kernel_variance, dtype=x.dtype, device=x.device)
    xs = x / lengthscales[..., None, :]
    k = amp[..., None, None] * _corr(name, sq_dist(xs, xs))
    mm = mask[:, None] * mask[None, :]
    eye = torch.eye(x.shape[-2], dtype=k.dtype, device=k.device)
    return k * mm + (noise * mask + (1.0 - mask)) * eye


def gram_masked_backward_plain(name, x, mask, lengthscales, kernel_variance,
                               grad, need_x=False):
    """Plain PyTorch gradient of sum(grad * gram_masked) in the lengthscales
    (R, d) and amplitudes (R,) and, with ``need_x``, in the coordinates, by
    the explicit formulas (not autograd): with D_ijk = x_ik - x_jk exact
    per-dimension differences, c' = corr (RBF) or
    (5/3)(1 + sqrt5 r) e^{-sqrt5 r} (Matern-5/2) and
    W_ij = (G_ij + G_ji) amp_r m_i m_j c'_ij,

        d/damp_r = sum_ij G_ij m_i m_j corr_ij
        d/dl_rk  = l_rk^-3 sum_ij G_ij amp_r m_i m_j c'_ij D_ijk^2
        d/dx_rik = -l_rk^-2 (x_ik sum_j W_ij - sum_j W_ij x_jk)

    x is (cap, d) or (R, cap, d); ``grad`` is (R, cap, cap) and need not be
    symmetric; mask and noise are not differentiated. Returns (grad_ls
    (R, d), grad_amp (R,)), and grad_x (R, cap, d) per lane with
    ``need_x``."""
    ls, amp = lengthscales, kernel_variance
    d = x.shape[-1]
    xk = [x[..., k] for k in range(d)]
    diffsq = lambda k: (xk[k][..., :, None] - xk[k][..., None, :]) ** 2
    dsq = sum(diffsq(k) / (ls[:, k, None, None] ** 2) for k in range(d))
    if name == "rbf":
        corr = torch.exp(-0.5 * dsq)
        dcorr = corr
    elif name == "matern":
        r = torch.sqrt(torch.clamp(dsq, min=1e-30))
        e = torch.exp(-SQRT5 * r)
        corr = (1.0 + SQRT5 * r + (5.0 / 3.0) * dsq) * e
        dcorr = (5.0 / 3.0) * (1.0 + SQRT5 * r) * e
    else:
        raise ValueError(f"Unknown kernel '{name}' (expected 'rbf' or "
                         "'matern')")
    gm = grad * (mask[:, None] * mask[None, :])
    grad_amp = torch.sum(gm * corr, dim=(-2, -1))
    w = gm * amp[:, None, None] * dcorr
    grad_ls = torch.stack([torch.sum(w * diffsq(k), dim=(-2, -1))
                           for k in range(d)], dim=-1) / ls ** 3
    if not need_x:
        return grad_ls, grad_amp
    W = w + w.transpose(-1, -2)
    xb = x.expand(W.shape[0], *x.shape[-2:])
    grad_x = -(xb * torch.sum(W, dim=-1)[..., None] - W @ xb) \
        / (ls * ls)[:, None, :]
    return grad_ls, grad_amp, grad_x


class GramMasked(torch.autograd.Function):
    """gram_masked over restart lanes, differentiable in the coordinates
    (cap, d) or (R, cap, d), the lengthscales (R, d) and the amplitudes
    (R,). On a CUDA tensor both directions are the hand-written kernels (the
    coordinate gradient only when autograd asks for it); on a CPU tensor
    their plain versions."""

    @staticmethod
    def forward(ctx, name, x, mask, lengthscales, kernel_variance, noise):
        ctx.name = name
        ctx.save_for_backward(x, mask, lengthscales, kernel_variance)
        if x.device.type == "cpu":
            return gram_masked_plain(name, x, mask, lengthscales,
                                     kernel_variance, noise)
        return _gram_masked_cuda(name, x, mask, lengthscales,
                                 kernel_variance, noise)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        x, mask, ls, amp = ctx.saved_tensors
        grad = grad.contiguous()
        if not ctx.needs_input_grad[1]:
            grad_ls, grad_amp = gram_masked_backward(ctx.name, x, mask, ls,
                                                     amp, grad)
            return None, None, None, grad_ls, grad_amp, None
        grad_ls, grad_amp, grad_x = gram_masked_backward_x(
            ctx.name, x, mask, ls, amp, grad)
        if x.dim() == 2:  # shared by the lanes
            grad_x = torch.sum(grad_x, dim=0)
        return None, grad_x, None, grad_ls, grad_amp, None


def gram_masked(name, x, mask, lengthscales, kernel_variance, noise):
    """Padded training Gram matrix with identity pad block.

    One set of hyperparameters (lengthscales (d,), scalar kernel_variance)
    gives (cap, cap); restart lanes (lengthscales (R, d), kernel_variance
    (R,) or scalar) give (R, cap, cap) from one launch. x is (cap, d),
    shared by the lanes, or (R, cap, d), one set of coordinates per lane.
    Differentiable in x, lengthscales and kernel_variance
    (:class:`GramMasked`); a gradient with respect to mask raises.
    ``noise`` is a host float.

    On a CPU tensor: the plain PyTorch versions. On a CUDA tensor: the
    hand-written kernels (csrc/gram_masked.cu), forward in float32 or
    float64, backward in float64, or an exception — never a silent
    fallback. ``gram_masked.launches`` counts forward launches,
    ``gram_masked.launches_lane_x`` those among them with per-lane x.
    """
    if name not in _KINDS:
        raise ValueError(f"Unknown kernel '{name}' (expected 'rbf' or "
                         "'matern')")
    if isinstance(noise, torch.Tensor):
        raise TypeError("gram_masked: noise must be a host float")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gram_masked: unsupported device {x.device}")
    if torch.is_grad_enabled() and mask.requires_grad:
        raise ValueError("gram_masked: the mask is not differentiable")
    single = lengthscales.dim() == 1
    if single and x.dim() != 2:
        raise ValueError("gram_masked: per-lane x needs lengthscales "
                         "(lanes, d)")
    ls = lengthscales.reshape(1, -1) if single else lengthscales
    amp = torch.as_tensor(kernel_variance, dtype=x.dtype, device=x.device)
    amp = amp.reshape(-1).expand(ls.shape[0])
    K = GramMasked.apply(name, x, mask, ls.contiguous(), amp.contiguous(),
                         float(noise))
    return K[0] if single else K


gram_masked.launches = 0
gram_masked.launches_lane_x = 0


def gram_masked_backward(name, x, mask, lengthscales, kernel_variance, grad):
    """Gradient of sum(grad * gram_masked(...)) in the lengthscales (R, d)
    and amplitudes (R,), for grad (R, cap, cap). On a CPU tensor:
    :func:`gram_masked_backward_plain`. On a CUDA tensor: the hand-written
    kernel (float64 only), or an exception. ``gram_masked_backward.launches``
    counts its launches."""
    if x.device.type == "cpu":
        return gram_masked_backward_plain(name, x, mask, lengthscales,
                                          kernel_variance, grad)
    if x.device.type != "cuda":
        raise ValueError(f"gram_masked_backward: unsupported device "
                         f"{x.device}")
    return _gram_masked_backward_cuda(name, x, mask, lengthscales,
                                      kernel_variance, grad, need_x=False)


gram_masked_backward.launches = 0


def gram_masked_backward_x(name, x, mask, lengthscales, kernel_variance,
                           grad):
    """:func:`gram_masked_backward` and the gradient in the coordinates:
    returns (grad_ls (R, d), grad_amp (R,), grad_x (R, cap, d) per lane).
    On a CUDA tensor: the kernel's coordinate variant (float64 only), or an
    exception. ``gram_masked_backward_x.launches`` counts its launches."""
    if x.device.type == "cpu":
        return gram_masked_backward_plain(name, x, mask, lengthscales,
                                          kernel_variance, grad, need_x=True)
    if x.device.type != "cuda":
        raise ValueError(f"gram_masked_backward_x: unsupported device "
                         f"{x.device}")
    return _gram_masked_backward_cuda(name, x, mask, lengthscales,
                                      kernel_variance, grad, need_x=True)


gram_masked_backward_x.launches = 0


def cross_kernel_masked(name, x_train, mask, xq, lengthscales, kernel_variance):
    """K(x_train, xq) with pad training rows zeroed: (cap, m)."""
    k = cross_kernel(name, x_train, xq, lengthscales, kernel_variance)
    return k * mask[:, None]


# --------------------------------------------------------------- CUDA kernels

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "bobe_tpu_torch"
# the kernels' output tile edge (BOBE_GRAM_TILE in csrc/gram_masked.cu)
TILE = 64
_LIBS: dict = {}  # tile edge -> loaded library
_LIB_LOCK = threading.Lock()
# filled by the last build: library path, seconds, and the compiler's output
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


def build_library(tile: int = TILE) -> ctypes.CDLL:
    """Compile every csrc/*.cu for sm_90a into one shared library (once per
    hash of all the sources and the tile edge) and load it. ``tile`` sets
    the output tile edge; anything but the default is for tile-size
    measurements (tools/torch_port_tile_sweep.py). Raises on a failed
    build."""
    with _LIB_LOCK:
        if tile in _LIBS:
            return _LIBS[tile]
        sources = sorted(_CSRC.glob("*.cu"))
        digest = hashlib.sha256(f"tile={tile}".encode())
        for path in sources:
            digest.update(path.name.encode() + b"\0" + path.read_bytes())
        so = _BUILD_DIR / f"libbobe_kernels_{digest.hexdigest()[:16]}.so"
        t0 = time.time()
        log_text = ""
        if not so.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                   "-Xptxas", "-v", f"-DBOBE_GRAM_TILE={int(tile)}", "-o",
                   str(tmp)]
            cmd += [str(p) for p in sources]
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=900)
            log_text = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"gram_masked: nvcc failed ({proc.returncode}):\n"
                    f"{log_text}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.bobe_gram_masked_f64, lib.bobe_gram_masked_f32):
            fn.argtypes = [ptr, ptr, ptr, ptr, ctypes.c_double, ptr,
                           i32, i32, i32, i32, i32, ptr]
            fn.restype = i32
        lib.bobe_gram_masked_backward_f64.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32,
            i32, i32, i32, i32, ptr]
        lib.bobe_gram_masked_backward_f64.restype = i32
        lib.bobe_gram_fold_runs.argtypes = [i32]
        lib.bobe_gram_fold_runs.restype = i32
        build_info.update(path=str(so), seconds=time.time() - t0,
                          log=log_text)
        _LIBS[tile] = lib
        return lib


def _check_inputs(what, x, mask, ls, amp):
    """Shapes, dtype, device and contiguity of the kernels' inputs; returns
    (cap, d, lanes, x_per_lane)."""
    if x.dim() not in (2, 3):
        raise ValueError(f"{what}: x must be (cap, d) or (lanes, cap, d), "
                         f"got {tuple(x.shape)}")
    cap, d = x.shape[-2:]
    if ls.dim() != 2:
        raise ValueError(f"{what}: lengthscales must be (lanes, d)")
    lanes = ls.shape[0]
    per_lane = x.dim() == 3
    if mask.shape != (cap,) or ls.shape != (lanes, d) or \
            amp.shape != (lanes,) or (per_lane and x.shape[0] != lanes):
        raise ValueError(
            f"{what}: shapes x {tuple(x.shape)}, mask {tuple(mask.shape)}, "
            f"lengthscales {tuple(ls.shape)}, amp {tuple(amp.shape)} do not "
            "match")
    for t in (x, mask, ls, amp):
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{what}: inputs must share dtype and device")
        if not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous")
    return cap, d, lanes, int(per_lane)


def _check_launch(what, err):
    if err != 0:
        raise RuntimeError(f"{what}: kernel launch failed (cudaError_t {err})")


def launch_forward(name, x, mask, ls, amp, noise, out, tile=TILE):
    """Launch the forward kernel into ``out`` (lanes, cap, cap) on the
    current stream: no checks, no count, no allocation (the wrapper's
    body, and what a device-time measurement loops over). x is (cap, d)
    or (lanes, cap, d)."""
    lib = build_library(tile)
    fn = lib.bobe_gram_masked_f64 if x.dtype == torch.float64 \
        else lib.bobe_gram_masked_f32
    cap, d = x.shape[-2:]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), mask.data_ptr(), ls.data_ptr(), amp.data_ptr(),
                 float(noise), out.data_ptr(), cap, d, ls.shape[0],
                 int(x.dim() == 3), _KINDS[name], stream)
    _check_launch("gram_masked", err)


def launch_backward(name, x, mask, ls, amp, grad, part, grad_ls, grad_amp,
                    dxpart=None, grad_x=None, tile=None):
    """Launch the backward, one kernel, into ``grad_ls`` and ``grad_amp``
    and, when ``grad_x`` (lanes, cap, d) is given, dL/dx (the coordinate
    variant, with ``dxpart``) on the current stream, with scratch of
    :func:`backward_scratch_sizes` and the stream's ticket buffer: no
    checks, no count, no allocation past the ticket buffer's first (the
    wrappers' body, and what a device-time measurement loops over).
    ``tile`` (32 or 64) defaults to :func:`backward_tile`'s choice for the
    shape; another edge is for measurements."""
    lib = build_library()
    cap, d = x.shape[-2:]
    lanes = ls.shape[0]
    tile = backward_tile(cap, d, lanes) if tile is None else tile
    need_x = grad_x is not None
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device)
        tickets = ticket_buffer(
            stream, backward_scratch_sizes(cap, d, lanes, tile, need_x)[2])
        err = lib.bobe_gram_masked_backward_f64(
            x.data_ptr(), mask.data_ptr(), ls.data_ptr(), amp.data_ptr(),
            grad.data_ptr(), part.data_ptr(), ptr(dxpart), tickets.data_ptr(),
            grad_ls.data_ptr(), grad_amp.data_ptr(), ptr(grad_x), cap, d,
            lanes, int(x.dim() == 3), _KINDS[name], int(tile),
            stream.cuda_stream)
    _check_launch("gram_masked_backward_x" if need_x
                  else "gram_masked_backward", err)


# H100 SXM: streaming multiprocessors the backwards' grids fill
_SMS = 132


def backward_tile(cap, d, lanes) -> int:
    """Tile edge of both backwards at this shape: 64 where their grid of
    lanes x tile pairs has a block for every SM of the card, else 32, which
    gives the grid about four times the blocks (cap 256 with 8 lanes:
    36 x 8 = 288 blocks where 64-row tiles give 80). Depends on the shape
    alone (``d`` does not change the choice)."""
    t = -(-cap // 64)
    return 64 if lanes * t * (t + 1) // 2 >= _SMS else 32


def fold_runs(t):
    """Runs in which the coordinate backward folds each row tile's t
    contributions (csrc/gram_masked.cu fold_runs): one up to t = 8, else
    runs of ceil(sqrt(t))."""
    if t <= 8:
        return 1
    run = math.isqrt(t - 1) + 1
    return -(-t // run)


def backward_scratch_sizes(cap, d, lanes, tile, need_x=False):
    """(float64 entries of the backward's tile-pair hyperparameter
    partials, float64 entries of the coordinate variant's row contributions
    and their run sums, its tickets) at tile edge ``tile``: T = ceil(cap /
    tile) row tiles, T (T + 1) / 2 tile pairs of d + 1 partials a lane and
    R = fold_runs(T) runs; without ``need_x`` no row contributions and one
    ticket a lane."""
    t = -(-cap // tile)
    pairs = t * (t + 1) // 2
    n_part = lanes * pairs * (d + 1)
    if not need_x:
        return n_part, 0, lanes
    runs = fold_runs(t)
    return (n_part, lanes * (2 * pairs + t * runs) * tile * d,
            lanes * (t * runs + t + 1))


# One ticket buffer per device and stream, zeroed once when it is
# allocated, shared by both backwards and sized for the larger need; each
# launch leaves its tickets at 0 again. Launches on one stream run one after
# another, so no two launches that share a buffer overlap, whichever
# streams a caller uses.
_TICKETS: dict = {}


def ticket_buffer(stream, n):
    """The ticket buffer of ``stream`` (a torch.cuda.Stream), with at least
    ``n`` int32 entries, all 0 between launches."""
    key = (stream.device, stream.cuda_stream)
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < n:
        size = n if buf is None else max(n, 2 * buf.numel())
        with torch.cuda.stream(stream):
            buf = _TICKETS[key] = torch.zeros(size, dtype=torch.int32,
                                              device=stream.device)
    return buf


def _gram_masked_cuda(name, x, mask, ls, amp, noise):
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"gram_masked: dtype {x.dtype} not supported")
    cap, _, lanes, per_lane = _check_inputs("gram_masked", x, mask, ls, amp)
    out = torch.empty((lanes, cap, cap), dtype=x.dtype, device=x.device)
    launch_forward(name, x, mask, ls, amp, noise, out)
    gram_masked.launches += 1
    gram_masked.launches_lane_x += per_lane
    return out


def _gram_masked_backward_cuda(name, x, mask, ls, amp, grad, need_x):
    what = "gram_masked_backward_x" if need_x else "gram_masked_backward"
    if name not in _KINDS:
        raise ValueError(f"Unknown kernel '{name}' (expected 'rbf' or "
                         "'matern')")
    if x.dtype != torch.float64:
        raise TypeError(f"{what}: the kernel takes float64 only, got "
                        f"{x.dtype}")
    cap, d, lanes, _ = _check_inputs(what, x, mask, ls, amp)
    if grad.shape != (lanes, cap, cap) or grad.dtype != x.dtype or \
            grad.device != x.device or not grad.is_contiguous():
        raise ValueError(
            f"{what}: grad must be a contiguous ({lanes}, {cap}, {cap}) "
            f"tensor like x, got {tuple(grad.shape)} {grad.dtype}")
    new = lambda *shape: torch.empty(shape, dtype=x.dtype, device=x.device)
    grad_ls, grad_amp = new(lanes, d), new(lanes)
    n_part, n_dx, _ = backward_scratch_sizes(
        cap, d, lanes, backward_tile(cap, d, lanes), need_x)
    if not need_x:
        launch_backward(name, x, mask, ls, amp, grad, new(n_part), grad_ls,
                        grad_amp)
        gram_masked_backward.launches += 1
        return grad_ls, grad_amp
    grad_x = new(lanes, cap, d)
    launch_backward(name, x, mask, ls, amp, grad, new(n_part), grad_ls,
                    grad_amp, dxpart=new(n_dx), grad_x=grad_x)
    gram_masked_backward_x.launches += 1
    return grad_ls, grad_amp, grad_x
