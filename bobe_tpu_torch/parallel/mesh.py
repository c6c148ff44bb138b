"""Device meshes: GP prediction, acquisition sweeps and sampler chains split
over several devices.

Counterpart of ``bobe_tpu/parallel/mesh.py``. A ``Mesh`` is an ordered tuple
of ``torch.device``s. A sharded function pads its batch axis to a multiple of
the mesh size, gives each mesh entry one equal chunk, runs every chunk on its
device against a replica of the GP state (made once per state and device and
cached) and gathers the results, in order, on the GP's device. Each distinct
device has one host thread of its own, which drives it on its default
stream, so the cards of a mesh overlap; the chunks of a device that the mesh
names more than once run one after the other in its thread.

A mesh may name one device more than once: the tests and ``chip_smoke.py``
run the split, the padding and the gather that way where only one device
exists. The production mesh (:func:`production_mesh`), which the BO loop's
call sites consult, is None unless ``BOBE_TPU_MESH=1`` asks for it: the
split runs on host threads and copies between devices, and no run on two
cards has yet shown that it pays at the loop's batch sizes. Asked for, it is
every visible card when there are two or more.
"""
from __future__ import annotations

import contextlib
import os
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Tuple

import torch

from ..utils.log import get_logger

log = get_logger("mesh")

Mesh = Tuple[torch.device, ...]


def get_mesh(devices=None) -> Mesh:
    """A mesh over the given devices (names or ``torch.device``s, repeats
    allowed), else over every visible card."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    mesh = tuple(torch.device(d) for d in devices)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


_PRODUCTION_MESH: Optional[Mesh] = None


def production_mesh(device=None) -> Optional[Mesh]:
    """The mesh the BO loop shards over, or None.

    None unless ``BOBE_TPU_MESH=1`` is set (and ``BOBE_TPU_NO_MESH``, the
    JAX package's switch, is not). Asked for, it is every visible CUDA card
    when there are two or more, and None with one card or when ``device``
    (the GP's; the default device when None) is not a CUDA device. The
    acquisition sweep and batch, the nested sampler's proposal batches and
    the EHMC and NUTS chains consult it; the sharded functions also take a
    mesh of their own.

    Under a ``DistributedPool`` the mesh is rank 0's own cards: the cards
    its process sees. The other ranks only evaluate likelihoods and never
    touch a device, so no card of the mesh is driven by another process.
    """
    global _PRODUCTION_MESH
    if os.environ.get("BOBE_TPU_MESH") != "1" or \
            os.environ.get("BOBE_TPU_NO_MESH"):
        return None
    if device is None:
        from ..config import get_device

        device = get_device()
    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        return None
    if _PRODUCTION_MESH is None:
        if torch.cuda.device_count() < 2:
            return None
        _PRODUCTION_MESH = get_mesh()
        log.info(f"production mesh over {len(_PRODUCTION_MESH)} cards")
    return _PRODUCTION_MESH


def pad_to_multiple(x: torch.Tensor, m: int):
    """Pad the leading axis to a multiple of m by repeating the last row.
    Returns (padded, n_orig)."""
    n = x.shape[0]
    rem = (-n) % m
    if rem:
        x = torch.cat([x, x[-1:].expand(rem, *x.shape[1:])], dim=0)
    return x, n


# ------------------------------------------------------------- replication

_REPLICA_CACHE_SIZE = 8
_replicas: "OrderedDict[tuple, tuple]" = OrderedDict()
_replicas_lock = threading.Lock()


def _copy_to(obj, device):
    """``obj`` (tensors, possibly in (named) tuples, lists or dicts) with
    every tensor on ``device``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_copy_to(v, device) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_copy_to(v, device) for v in obj)
    if isinstance(obj, dict):
        return {k: _copy_to(v, device) for k, v in obj.items()}
    return obj


def replicate(ctx, device, cache: bool = True):
    """``ctx`` on ``device``: copied once per ``ctx`` object and device, and
    kept for later calls (the last few states), when ``cache``. States are
    never written in place, so a new state is a new object."""
    if not cache:
        return _copy_to(ctx, device)
    key = (id(ctx), str(device))
    with _replicas_lock:
        hit = _replicas.get(key)
        if hit is not None and hit[0] is ctx:
            _replicas.move_to_end(key)
            return hit[1]
    rep = _copy_to(ctx, device)
    with _replicas_lock:
        _replicas[key] = (ctx, rep)
        while len(_replicas) > _REPLICA_CACHE_SIZE:
            _replicas.popitem(last=False)
    return rep


# ------------------------------------------------------------ the split run

_executors: dict = {}
_executors_lock = threading.Lock()


def _executor(device) -> ThreadPoolExecutor:
    key = str(device)
    with _executors_lock:
        ex = _executors.get(key)
        if ex is None:
            ex = _executors[key] = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix=f"bobe-mesh-{key}")
        return ex


def _device_guard(device):
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _run_chunks(device, fn, ctx, chunks, out_device, cache):
    """The work of one device's thread: its chunks in order, each
    ``fn(replica, chunk, start)`` (start: the chunk's first row), the
    outputs moved to ``out_device``. The copies run on this thread's
    default streams of both devices, which order them after the work that
    made their inputs."""
    with _device_guard(device):
        rep = replicate(ctx, device, cache)
        outs = []
        for start, chunk in chunks:
            out = fn(rep, chunk.to(device), start)
            outs.append(_copy_to(out, out_device))
        return outs


def split_map(fn: Callable, ctx, x: torch.Tensor, mesh: Mesh, dims=0,
              cache: bool = True, pad: bool = True):
    """``fn`` over x with x's leading axis split over the mesh.

    x is padded to a multiple of the mesh size (``pad``; else split into
    near-equal chunks, an empty one skipped), chunk i runs on ``mesh[i]`` as
    ``fn(replica, chunk, start)``, with ``ctx``'s replica there and the
    chunk's first row in x, and the outputs (a tensor or a tuple of
    tensors) are concatenated on x's device along ``dims`` (one int, or one
    per output) and cut back to x's length. Returns (outputs, n_padded)."""
    out_device = x.device
    if pad:
        xp, n = pad_to_multiple(x, len(mesh))
        chunks = list(torch.chunk(xp, len(mesh), dim=0))
    else:
        xp, n = x, x.shape[0]
        chunks = list(torch.tensor_split(x, len(mesh), dim=0))
    starts = [0]
    for c in chunks[:-1]:
        starts.append(starts[-1] + c.shape[0])
    chunks = list(zip(starts, chunks))
    by_device: "OrderedDict[torch.device, list]" = OrderedDict()
    for i, dev in enumerate(mesh):
        if chunks[i][1].shape[0]:
            by_device.setdefault(dev, []).append(i)
    caller_stream = None
    if out_device.type == "cuda":
        # the threads use the default streams: order them after the
        # caller's stream, and the caller's stream after them
        caller_stream = torch.cuda.current_stream(out_device)
        default = torch.cuda.default_stream(out_device)
        if caller_stream != default:
            default.wait_stream(caller_stream)
        else:
            caller_stream = None
    futures = {dev: _executor(dev).submit(
        _run_chunks, dev, fn, ctx, [chunks[i] for i in idx], out_device,
        cache) for dev, idx in by_device.items()}
    parts = [None] * len(mesh)
    for dev, idx in by_device.items():
        for i, out in zip(idx, futures[dev].result()):
            parts[i] = out
    parts = [p for p in parts if p is not None]
    if caller_stream is not None:
        caller_stream.wait_stream(torch.cuda.default_stream(out_device))
    single = isinstance(parts[0], torch.Tensor)
    outs = [parts] if single else [list(p) for p in zip(*parts)]
    dims = dims if isinstance(dims, (tuple, list)) else [dims] * len(outs)
    gathered = []
    for pieces, dim in zip(outs, dims):
        cat = torch.cat(pieces, dim=dim)
        gathered.append(cat.narrow(dim, 0, n) if pad else cat)
    return (gathered[0] if single else tuple(gathered)), xp.shape[0]


# ---------------------------------------------------------- the GP functions

def sharded_predict(gp, xq, mesh: Optional[Mesh] = None):
    """Physical-scale (mean, var) at xq (m, d) with the query batch split
    over the mesh."""
    from ..models import gp as gpm

    mesh = mesh if mesh is not None else get_mesh()
    xq = gp._as_points(xq)
    cfg = gp.cfg
    out, _ = split_map(lambda st, x, _: gpm.predict(st, cfg, x), gp.state, xq,
                       mesh)
    return out


def sharded_posterior(gp, mc_points, mesh: Mesh):
    """The WIP payload of the pool, its columns split over the mesh: the
    pool padded to the mesh and in warp space, V (cap, m_pad) and var
    (m_pad,), gathered on the GP's device."""
    from ..models import gp as gpm
    from ..ops.fantasy import posterior_batch

    cfg = gp.cfg
    mc_p, n = pad_to_multiple(mc_points, len(mesh))

    def solve(st, x, _):
        ls, amp = torch.exp(st.log_ls), torch.exp(st.log_amp)
        x_w = gpm.query_coords(st, cfg, x)
        V, var = posterior_batch(cfg.kernel, gpm.train_coords(st, cfg),
                                 st.mask(), st.chol, x_w, ls, amp, cfg.noise)
        return x_w, V, var

    (mc_w, V, var), _ = split_map(solve, gp.state, mc_p, mesh, dims=(0, 1, 0),
                                  pad=False)
    return mc_w, V, var, n


def _pool_rows(gp, mc_w, V, var, mesh: Mesh, reduce: Callable):
    """``reduce(C_rows, var_all, rows)`` over the rows of the pool's
    posterior covariance C (m, m), split over the mesh: each device computes
    its rows of C and reduces them there, and only the reductions are
    gathered. V (cap, m), the pool and var go to each device once per call
    (they are new with every pool)."""
    from ..ops.fantasy import posterior_cov

    st, cfg = gp.state, gp.cfg
    ls, amp = torch.exp(st.log_ls), torch.exp(st.log_amp)
    idx = torch.arange(mc_w.shape[0], device=mc_w.device)

    def on_rows(ctx, chunk, start):
        x_all, V_all, var_all, ls_, amp_ = ctx
        rows = slice(start, start + chunk.shape[0])
        C_rows = posterior_cov(cfg.kernel, x_all[rows], x_all, V_all[:, rows],
                               V_all, ls_, amp_)
        return reduce(C_rows, var_all, rows)

    out, _ = split_map(on_rows, (mc_w, V, var, ls, amp), idx, mesh,
                       cache=False, pad=False)
    return out


def sharded_posterior_cov(gp, mc_w, V, var, mesh: Mesh):
    """The pool's posterior covariance C (m, m), its rows computed over the
    mesh and gathered on the GP's device (the greedy batch selection needs
    all of it)."""
    return _pool_rows(gp, mc_w, V, var, mesh, lambda C_rows, _, __: C_rows)


def sharded_wip_core(gp, mc_points, use_std: bool, mesh: Mesh):
    """WIPV/WIPStd over the pool with the pool split over the mesh. Returns
    (acq (m,), V (cap, m), var (m,)), as the unsharded sweep does. Each
    device computes its candidates' rows of the pool covariance and their
    values; only the (m,) values are gathered.

    The pool is padded with copies of its last point so that every device
    gets an equal chunk; the integration mean runs over the first m
    columns only (``n_valid``), so the copies never enter it."""
    from ..ops.fantasy import wip_values

    mc_w, V, var, n = sharded_posterior(gp, mc_points, mesh)
    y_std = gp.state.y_std
    n_valid = n if mc_w.shape[0] != n else None
    acq = _pool_rows(gp, mc_w, V, var, mesh, lambda C_rows, var_all, rows:
                     wip_values(C_rows, var_all[rows], var_all, y_std,
                                use_std, n_valid=n_valid))
    return acq[:n], V[:, :n], var[:n]


def sharded_wip_sweep(gp, mc_points, use_std: bool,
                      mesh: Optional[Mesh] = None):
    """WIP acquisition over the MC pool with the pool split over the mesh."""
    mesh = mesh if mesh is not None else get_mesh()
    mc_points = gp._as_points(mc_points)
    return sharded_wip_core(gp, mc_points, use_std, mesh)[0]


def sharded_target(make_vg: Callable, ctx, mesh: Mesh):
    """``vg(z)`` of the target ``make_vg(ctx)`` with the chain batch split
    over the mesh: each device builds the target once, on its replica of
    ``ctx``, and evaluates its chunk of the chains."""
    built: dict = {}

    def on_device(rep, z, _):
        vg = built.get(id(rep))
        if vg is None:
            vg = built[id(rep)] = make_vg(rep)
        return vg(z)

    def vg(z):
        return split_map(on_device, ctx, z, mesh, pad=False)[0]

    return vg


def _generators_on(gens, device):
    """The chain generators, on ``device``: the same objects where they are
    there already, else copies with the same state (a chain then draws the
    same numbers on any device of its type)."""
    out = []
    for g in gens:
        if g.device == device:
            out.append(g)
        else:
            c = torch.Generator(device=device)
            c.set_state(g.get_state())
            out.append(c)
    return out


# run_chain's per-chain diagnostics
_NUTS_DIAG = ("mean_accept", "n_divergent", "step_size", "mass_inv",
              "mass_chol", "last_z")


def sharded_nuts(make_vg: Callable, ctx, init_z, gens, mesh: Optional[Mesh] = None,
                 **chain_kwargs):
    """NUTS chains (infer/nuts.run_chain) split over the mesh: each device
    runs its chunk of the chains, with their own generators, against its
    replica of ``ctx`` (``make_vg(ctx)`` is the target). Chains are
    independent and each draws from its own generator, so a chain's result
    does not depend on the layout.

    Returns run_chain's (samples, logps, diagnostics) for all chains, in
    order, on init_z's device; ``n_leapfrog`` is the largest count of a
    device (the devices run side by side)."""
    from ..infer.nuts import run_chain

    mesh = mesh if mesh is not None else get_mesh()
    # a warm start's per-chain kernel is split with the chains
    warm = chain_kwargs.pop("warm", None)
    gens = list(gens)

    def run(rep, z, start):
        rows = slice(start, start + z.shape[0])
        chunk_gens = _generators_on(gens[rows], z.device)
        chunk_warm = (None if warm is None
                      else tuple(t[rows].to(z.device) for t in warm))
        zs, logps, diag = run_chain(make_vg(rep), z, chunk_gens,
                                    warm=chunk_warm, **chain_kwargs)
        return (zs, logps, *(diag[k] for k in _NUTS_DIAG),
                torch.tensor([diag["n_leapfrog"]], device=z.device))

    outs, _ = split_map(run, ctx, init_z, mesh, pad=False)
    diag = dict(zip(_NUTS_DIAG, outs[2:-1]))
    diag["n_leapfrog"] = int(outs[-1].max())
    return outs[0], outs[1], diag


__all__ = ["Mesh", "get_mesh", "production_mesh", "pad_to_multiple",
           "replicate", "split_map", "sharded_predict", "sharded_wip_sweep",
           "sharded_wip_core", "sharded_target", "sharded_nuts"]
