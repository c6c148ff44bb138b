"""The seed spread of the planck-like warp run, the JAX package against the
port: how often each run's err_total covers its |logZ - truth|, and whether
the two packages' logZ and evaluation counts differ.

Each input file is the output of one run, whose last JSON line holds
``logz``, ``abs_dlogz``, ``err_total`` and ``n_evals``:

    JAX_PLATFORMS=cpu python tools/torch_port_reference.py --planck-warp-run --seed S > jax_S.log
    python tools/torch_port_planck_like.py --warp --seed S [--device cpu] > port_S.log
    python tools/torch_port_seed_spread.py jax_*.log port_*.log

A line carrying the key ``jax`` is the JAX package's run, any other the
port's. Prints one row per run, then per package: the runs covered by
err_total, those within 0.1, mean and standard deviation of logZ, its bias
against the truth with the standard error, the mean evaluation count; and
Welch's t between the packages for logZ and for the evaluation count.
"""
from __future__ import annotations

import json
import sys

import numpy as np

LOGZ_TRUE = 9.339256234197025
TARGET = 0.1


def _last_json(path):
    with open(path, errors="ignore") as fh:
        rows = [ln for ln in fh if ln.startswith("{") and '"err_total"' in ln]
    if not rows:
        raise ValueError(f"{path}: no result line")
    return json.loads(rows[-1])


def _welch(a, b):
    va, vb = a.var(ddof=1) / a.size, b.var(ddof=1) / b.size
    return float((b.mean() - a.mean()) / np.sqrt(va + vb))


def main(paths):
    runs = {"jax": [], "port": []}
    for p in paths:
        r = _last_json(p)
        pkg = "jax" if "jax" in r else "port"
        runs[pkg].append((r.get("seed"), r["logz"], r["abs_dlogz"],
                          r["err_total"], r["n_evals"]))
        print(f"{pkg:4s} {p}: logZ {r['logz']:.4f} |d| {r['abs_dlogz']:.4f} "
              f"err_total {r['err_total']:.4f} evals {r['n_evals']} "
              f"covered {r['abs_dlogz'] <= r['err_total']}")
    cols = {}
    for pkg, rs in runs.items():
        if not rs:
            continue
        _, lz, d, e, n = (np.asarray(c, dtype=float) for c in zip(*rs))
        cols[pkg] = (lz, n)
        print(f"{pkg}: {lz.size} runs, err_total covers {int(np.sum(d <= e))}"
              f", |d| <= {TARGET} in {int(np.sum(d <= TARGET))}; logZ mean "
              f"{lz.mean():.4f} sd {lz.std(ddof=1):.4f}, bias "
              f"{lz.mean() - LOGZ_TRUE:+.4f} +- "
              f"{lz.std(ddof=1) / np.sqrt(lz.size):.4f}; mean |d| "
              f"{d.mean():.4f}, mean err_total {e.mean():.4f}; evaluations "
              f"mean {n.mean():.1f} sd {n.std(ddof=1):.1f}")
    if len(cols) == 2:
        (lj, nj), (lp, np_) = cols["jax"], cols["port"]
        print(f"port - jax: logZ {lp.mean() - lj.mean():+.4f} (Welch t "
              f"{_welch(lj, lp):+.2f}), sd ratio "
              f"{lp.std(ddof=1) / lj.std(ddof=1):.2f}; evaluations "
              f"{np_.mean() - nj.mean():+.1f} (Welch t {_welch(nj, np_):+.2f})")


if __name__ == "__main__":
    main(sys.argv[1:])
