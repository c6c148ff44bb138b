"""Evidence cells: back-to-back convergence evidences on one GP state.

Set-up builds the state from the seed (drivers/common.build_state: the GP
fitted and its gate trained by the BOBE constructor) and runs one short
evidence (``warmup_maxcall`` surrogate calls) so that every shape has run.
The window then calls ``samplers.nested_sampling(gp, mode, dlogz)``, the call
the loop makes at each convergence check, once after another, each with its
own seeds from the run's seed, until ``--seconds`` have passed; the evidence
in flight is completed and counted. Every evidence's points, values and
logZ are kept for a sample drawn from the seed and judged once the window
has closed.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from . import common


def judge(run, cell, cfg, device, stand_in=None):
    """The evidence cell's numbers (reference/judge.py)."""
    from ..reference.judge import judge_evidence

    return judge_evidence(run, cfg["reference"], device, cell["reference_ns"],
                          stand_in)


def run(cfg, cell, seed, seconds, trace, device):
    from bobe_tpu_torch import samplers
    from bobe_tpu_torch.bo import BOBE

    seeded = []
    seed_live = samplers._seed_live_points

    def recording_seed_live(*a, **k):
        out = seed_live(*a, **k)
        seeded.append(float(out[2]))
        return out

    samplers._seed_live_points = recording_seed_live
    try:
        t_state = time.perf_counter()
        bobe, info = common.build_state(cfg, cell, seed, device, BOBE)
        common.sync(device)
        t_built = time.perf_counter()
        gp = bobe.gp
        ns_kw = dict(cell["ns"])

        def evidence(tag, **extra):
            del seeded[:]
            gen = torch.Generator(device=torch.device(device))
            gen.manual_seed(common.sub_seed(seed, 10, tag))
            t0 = time.perf_counter()
            smp, logz, ok = samplers.nested_sampling(
                gp, rng=np.random.default_rng(common.sub_seed(seed, 11, tag)),
                generator=gen, **ns_kw, **extra)
            common.sync(device)
            return {"seconds": time.perf_counter() - t0, "x": smp["x"],
                    "logl": smp["logl"], "logz": float(logz["mean"]),
                    "err_total": float(logz["err_total"]),
                    "logvol0": seeded[0] if seeded else 0.0,
                    "n_inner": int(smp["n_inner"]), "success": bool(ok)}

        evidence(0, maxcall=int(cell["warmup_maxcall"]),
                 warn_truncation=False)
        common.sync(device)
        rng = np.random.default_rng(common.sub_seed(seed, 5))
        kept, results = [], []
        t0 = time.perf_counter()
        setup_end = t0
        while True:
            r = evidence(len(results) + 1)
            results.append({k: r[k] for k in ("seconds", "n_inner",
                                                "success", "logz",
                                                "err_total")})
            n = len(results)
            if len(kept) < 2:
                kept.append(r)
            else:
                j = int(rng.integers(n))
                if j < 2:
                    kept[j] = r
            if time.perf_counter() - t0 >= seconds:
                break
        window = time.perf_counter() - t0
        out = {"kind": "evidence", "setup_end": setup_end,
               "setup_marks": (t_state, t_built), "window_s": window,
               "units": len(results), "evidences": results,
               "unit_s": [r["seconds"] for r in results],
               "attempted": len(results),
               "failed": sum(not r["success"] for r in results),
               "bobe": bobe, "info": info, "records": kept,
               "setup_rec": {"fit": [{"rows_upto": 0, "basins": [
                   (np.asarray(p), float(f)) for p, f in gp._fit_basins]}]},
               "log_params": common.log_params_of(gp),
               "gp_size": int(gp.gp_size)}
        if trace:
            spans = []
            tag = len(results) + 1

            def sliced():
                t = time.perf_counter()
                r = evidence(tag, maxcall=int(cell["profile_maxcall"]),
                             warn_truncation=False)
                spans.append(("nested_sampling", t, time.perf_counter()))
                return r

            out["slice"] = common.profile_slice(sliced, device, spans)
            out["slice"]["n_inner"] = out["slice"]["result"]["n_inner"]
        return out
    finally:
        samplers._seed_live_points = seed_live
