"""Faults planted underneath the timed path, each of which a cell's check
has to find. The CPU tests plant them at the tests' sizes; on the card they
are planted at a cell's own size to read what each number gives under them:

    python3 -m benchmark.tests.faults --workload <cell> --fault <name> \
        --seed <n>[,<n>...] --seconds 0

prints, for each seed, one JSON line with the run's numbers under the fault
(its ``program`` entry).
"""
from __future__ import annotations

import argparse

import numpy as np
import pytest
import torch


def unchanged_gp_update(mp):
    """The GP update returns its state unchanged."""
    from bobe_tpu_torch.models.clf_gp import GPwithClassifier
    from bobe_tpu_torch.models.gp import GP

    mp.setattr(GP, "update", lambda self, x, y: None)
    mp.setattr(GPwithClassifier, "update", lambda self, x, y: None)


def zero_fit_gradient(mp):
    """The fit's objective passes no gradient: its optimizer does no work."""
    from bobe_tpu_torch.models import gp as gpm

    base = gpm.neg_mll

    def flat(state, cfg, log_params, dsq_perdim=None):
        v = base(state, cfg, log_params, dsq_perdim=dsq_perdim)
        return v.detach() + 0.0 * log_params.sum(-1)

    mp.setattr(gpm, "neg_mll", flat)


def zero_gram_backward(mp):
    """The Gram kernel's backward in the lengthscales and amplitude returns
    zeros, and every fit objective takes the Gram kernels (above the
    per-dimension slabs' budget, as the cell's cap is)."""
    from bobe_tpu_torch.models import gp as gpm
    from bobe_tpu_torch.ops import kernels as kr

    base = kr.gram_masked_backward

    def zeros(name, x, mask, ls, amp, grad):
        g_ls, g_amp = base(name, x, mask, ls, amp, grad)
        return torch.zeros_like(g_ls), torch.zeros_like(g_amp)

    # the launch counter the kernel's wrapper keeps on the function
    zeros.launches = base.launches
    mp.setattr(kr, "gram_masked_backward", zeros)
    mp.setattr(gpm, "PERDIM_MAX_BYTES", 0)


def half_pool_acquisition(mp):
    """The WIPStd mean taken over half of the pool, the rest left out."""
    from bobe_tpu_torch import acquisition as acq

    sweep, single = acq.wip_sweep, acq.fantasy_var_single

    def half_sweep(kernel, xq, *a, **k):
        k["n_valid"] = xq.shape[0] // 2
        return sweep(kernel, xq, *a, **k)

    def half_single(*a, **k):
        fv = single(*a, **k)
        return fv[: fv.shape[0] // 2]

    mp.setattr(acq, "wip_sweep", half_sweep)
    mp.setattr(acq, "fantasy_var_single", half_single)


def first_candidates_acquisition(mp):
    """The selection does no work: each pick is the pool's first candidate
    not yet taken, with its own WIPStd value (the fused selection's
    downdates, and the sweep's value without the polish)."""
    from bobe_tpu_torch import acquisition as acq
    from bobe_tpu_torch import config
    from bobe_tpu_torch.ops.fantasy import _floor, posterior_cov

    def first(kernel_name, xq, V, var, ls, amp, noise, y_std, use_std,
              n_batch, C=None):
        if C is None:
            C = posterior_cov(kernel_name, xq, xq, V, V, ls, amp)
        scale = y_std if use_std else y_std**2
        floor = config.SAFE_NOISE_FLOOR
        vals = []
        for i in range(n_batch):
            fantasy = _floor(var - C[i] * C[i] / var[i])
            red = torch.sqrt(fantasy) if use_std else fantasy
            vals.append(torch.mean(red) * scale)
            w = C[i, :] / torch.sqrt(torch.clamp(var[i], min=floor))
            var = torch.clamp(var - w * w, min=floor)
            C = C - torch.outer(w, w)
        return torch.arange(n_batch, device=xq.device), torch.stack(vals)

    def first_point(self, gp, acq_kwargs=None, maxiter=100, n_restarts=1,
                    verbose=True, early_stop_patience=25, rng=None):
        acq_kwargs = dict(acq_kwargs or {})
        mc_np = np.asarray(acq.get_mc_points(
            acq_kwargs.get("mc_samples"),
            mc_points_size=int(acq_kwargs.get("mc_points_size", 128)),
            rng=rng, gp=gp))
        mc = torch.as_tensor(mc_np, dtype=config.DTYPE, device=gp.device)
        vals, _, _ = acq._wip_sweep_core(gp, mc, self._use_std)
        return mc_np[0], float(vals[0])

    mp.setattr(acq, "wip_greedy_batch", first)
    mp.setattr(acq.WeightedIntegratedPosteriorBase, "get_next_point",
               first_point)


def altered_acquisition_value(mp):
    """The batch's acquisition values altered where they are produced."""
    from bobe_tpu_torch import acquisition as acq

    base = acq.WeightedIntegratedPosteriorBase.get_next_batch

    def altered(self, *a, **k):
        pts, vals = base(self, *a, **k)
        return pts, np.asarray(vals) * 2.0

    mp.setattr(acq.WeightedIntegratedPosteriorBase, "get_next_batch", altered)


def unchanged_live_set(mp):
    """A nested-sampling step that returns its live set unchanged: the
    killed points come back as their own replacements."""
    from bobe_tpu_torch.infer import nested

    def same(loglike_fn, gen, live_x, live_logl, survivor_idx, *a, **k):
        killed = torch.ones(live_x.shape[0], dtype=torch.bool)
        killed[survivor_idx.cpu()] = False
        idx = torch.nonzero(killed).reshape(-1).to(live_x.device)
        idx = idx[torch.argsort(live_logl[idx], stable=True)]
        return live_x[idx], live_logl[idx], torch.zeros((), dtype=torch.int64), 1

    mp.setattr(nested, "_replace_batch", same)


def half_rows_mean(mp):
    """The surrogate's mean taken over half of the GP's rows."""
    from bobe_tpu_torch.models import gp as gpm

    mean = gpm.predict_mean

    def half(state, cfg, xq):
        keep = (torch.arange(state.cap) < state.n // 2).to(state.alpha.dtype)
        return mean(state._replace(alpha=state.alpha * keep), cfg, xq)

    mp.setattr(gpm, "predict_mean", half)


def wrong_start_volume(mp):
    """The gated start volume estimated a factor e too large."""
    from bobe_tpu_torch import samplers

    base = samplers._seed_live_points

    def wrong(*a, **k):
        x, logl, logvol0, var = base(*a, **k)
        return x, logl, logvol0 + 1.0, var

    mp.setattr(samplers, "_seed_live_points", wrong)


def altered_logz(mp):
    """The evidence altered where it is produced."""
    from bobe_tpu_torch.infer import integrals

    bounds = integrals.logz_bounds_from_gp_sigma

    def altered(*a, **k):
        out = bounds(*a, **k)
        out["mean"] += 1.0
        return out

    mp.setattr(integrals, "logz_bounds_from_gp_sigma", altered)


# the faults each cell can have, by cell
FAULTS = {
    "planck6.loop": [unchanged_gp_update, zero_fit_gradient,
                     half_pool_acquisition, first_candidates_acquisition,
                     altered_acquisition_value],
    "gauss30.loop": [unchanged_gp_update, zero_gram_backward,
                     first_candidates_acquisition],
    "planck6.evidence": [unchanged_live_set, half_rows_mean,
                         wrong_start_volume, altered_logz],
}


def main(argv=None):
    from benchmark import run as R

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--fault", required=True)
    p.add_argument("--seed", required=True)
    p.add_argument("--seconds", type=float, default=0.0)
    args = p.parse_args(argv)
    R._caches()
    fault = globals()[args.fault]
    device = "cuda" if torch.cuda.is_available() else "cpu"
    with pytest.MonkeyPatch.context() as mp:
        fault(mp)
        R.calibrate(args.workload, [int(s) for s in args.seed.split(",")],
                    args.seconds, device, stand_ins=())


if __name__ == "__main__":
    main()
