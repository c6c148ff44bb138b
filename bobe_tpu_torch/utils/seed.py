"""Global seed / random-number registry.

One global seed feeds Python's ``random``, a NumPy ``Generator`` and a chain
of ``torch.Generator`` seeds (torch is imported by the functions that make
generators, so a client of the device server seeds without it). Where the JAX package splits a PRNG key, the
port spawns a child of a ``numpy.random.SeedSequence`` and seeds a fresh
``torch.Generator`` on the device that will draw from it, so every sampler
call gets its own independent, reproducible stream. A generator is never
shared between threads: a caller hands each thread the generator it drew for
it on the calling thread. Distributed processes offset the seed by their
process index so workers draw decorrelated streams.
"""
from __future__ import annotations

import os
import random as _pyrandom

import numpy as np

from .log import get_logger, process_index

log = get_logger("seed")

_global_seed: int | None = None
_np_rng: np.random.Generator | None = None
_seed_seq: np.random.SeedSequence | None = None


def set_global_seed(seed: int | None = None, rank_offset: bool = True) -> int:
    """Seed python/numpy/torch random streams. Returns the seed used."""
    global _global_seed, _np_rng, _seed_seq
    if seed is None:
        seed = _pyrandom.randint(0, 2**31 - 1)
        log.info(f"No seed provided; generated random seed {seed}")
    if not isinstance(seed, (int, np.integer)) or seed < 0:
        raise ValueError("Seed must be a non-negative integer or None")
    seed = int(seed)
    if rank_offset:
        seed = seed + process_index()
    _global_seed = seed
    _pyrandom.seed(seed)
    _np_rng = np.random.default_rng(seed)
    _seed_seq = np.random.SeedSequence(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    return seed


def ensure_reproducibility(seed: int | None = None) -> int:
    """Seed every random stream (:func:`set_global_seed`); returns the seed."""
    return set_global_seed(seed)


def _ensure() -> None:
    if _global_seed is None:
        set_global_seed()


def get_global_seed() -> int:
    _ensure()
    return _global_seed


def get_numpy_rng() -> np.random.Generator:
    _ensure()
    return _np_rng


def new_torch_generator(device=None) -> "torch.Generator":
    """A fresh generator on ``device``, seeded from the next child of the
    global seed sequence (the counterpart of ``get_new_jax_key``)."""
    import torch

    _ensure()
    child = _seed_seq.spawn(1)[0]
    seed = int(child.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))
    gen = torch.Generator(device=torch.device(device or "cpu"))
    gen.manual_seed(seed)
    return gen


def split_generator(gen: torch.Generator, n: int) -> list:
    """``n`` independent generators on ``gen``'s device, seeded from draws
    of ``gen`` (the counterpart of ``jax.random.split``)."""
    import torch

    seeds = torch.randint(0, 2**62, (n,), generator=gen,
                          device=gen.device).tolist()
    out = []
    for s in seeds:
        g = torch.Generator(device=gen.device)
        g.manual_seed(int(s))
        out.append(g)
    return out
