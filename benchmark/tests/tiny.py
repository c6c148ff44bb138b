"""The cells at sizes a CPU test run holds: the same files, with the state,
the episodes and the sampler cut down. The planck6 cells keep their 200
evaluations: below them the gated GP is far better conditioned than the
cell's, so the float32 control stays inside the cell's limits, and its
evidence lies tens of nats from the truth."""
from __future__ import annotations

from benchmark import run as R

SEED = 3000000019


def tiny(name, root=R.HERE):
    """(cell, cfg) of ``name`` cut to a CPU test's size."""
    cell, cfg = R.load_cell(name, root)
    if cfg["name"] == "gauss30":
        # d stays 30: rows as sparse as the cell's keep the state as well
        # conditioned as the cell's, so its limits hold
        cfg["bobe"]["n_sobol_init"] = 64
        cell["n_state"] = 96
    if cell["kind"] == "loop":
        cell["episode_iterations"] = 2
    else:
        cell["ns"]["nlive"] = 100
        cell["reference_ns"]["nlive"] = 100
        cell["warmup_maxcall"] = cell["profile_maxcall"] = 2000
    return cell, cfg


def run_tiny(name, trace=0, seed=SEED, root=R.HERE, bench=None):
    cell, cfg = tiny(name, root)
    return R.run_cell(name, seed, 0.0, trace, "cpu", bench=bench, cell=cell,
                      cfg=cfg, root=root)
