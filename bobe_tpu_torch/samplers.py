"""Surrogate samplers: nested sampling over the GP mean.

Counterpart of ``bobe_tpu/samplers.py`` in its static mode:
``nested_sampling(gp, mode=...)`` runs the batched sampler of
infer/nested.py with the GP mean as the likelihood and returns the evidence
with its GP-sigma bounds, the sampler error, and the hyperparameter-basin
spread. NUTS and the ensemble HMC refresh are not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import config
from .infer import integrals
from .infer.nested import merge_runs, run_nested
from .models import gp as gpm
from .utils.core import renormalise_log_weights, resample_equal
from .utils.log import get_logger
from .utils.seed import get_numpy_rng, new_torch_generator, split_generator

log = get_logger("sampler")


def _gp_loglike(gp) -> Tuple:
    """(apply_fn, ctx) for the GP mean: apply(ctx, x (m, d)) -> (m,)."""
    if getattr(gp, "_clf_ctx", None) is not None:
        raise config.not_ported("The classifier-gated surrogate", "clf")
    cfg = gp.cfg
    return (lambda state, x: gpm.predict_mean(state, cfg, x)), gp.state


# ------------------------------------------------------------ nested sampling

def ns_settings(mode: str, ndim: int) -> Tuple[int, float, int]:
    """(nlive, dlogz, maxcall) per mode."""
    if mode == "acq":
        return max(100, min(500, 20 * ndim)), 0.1, int(2e6)
    return max(500, 40 * ndim), 0.01, int(5e6)


def _seed_live_points(gp, loglike, nlive, ndim, rng):
    """Live seeding with exact plateau volume accounting: live points are
    rejection-seeded strictly above the surrogate's floor (``gp.minus_inf``,
    -inf for a plain GP) and the shrinkage ledger starts at log(f_feasible).

    Returns (live_x, live_logl, logvol0, var_logvol0); with too few feasible
    points it falls back to a mixed live set with logvol0 = 0."""
    maxtries = 20
    nlogl = 5000 * ndim
    floor = float(getattr(gp, "minus_inf", -np.inf))

    def _loglike_chunked(x):
        chunk = config.PREDICT_CHUNK
        return np.concatenate([
            loglike(torch.as_tensor(x[i:i + chunk], dtype=config.DTYPE,
                                    device=gp.device)).cpu().numpy()
            for i in range(0, x.shape[0], chunk)])

    feas_x, feas_l = [], []
    n_drawn = n_feas = 0
    for _ in range(maxtries):
        x = rng.uniform(size=(nlogl, ndim))
        logl = _loglike_chunked(x)
        ok = logl > floor
        n_drawn += nlogl
        n_feas += int(ok.sum())
        feas_x.append(x[ok]), feas_l.append(logl[ok])
        if n_feas >= nlive:
            break
    fx, fl = np.concatenate(feas_x), np.concatenate(feas_l)
    if n_feas >= nlive:
        idx = rng.choice(n_feas, size=nlive, replace=False)
        if not np.all(fl[idx] == fl[idx][0]):
            f_hat = n_feas / n_drawn
            var_logvol0 = (1.0 - f_hat) / (n_drawn * f_hat)
            return fx[idx], fl[idx], float(np.log(f_hat)), float(var_logvol0)
    if n_feas < nlive:
        log.warning(
            f"live seeding found only {n_feas}/{n_drawn} feasible points; "
            "falling back to a mixed live set (logZ may carry plateau bias)")
    else:
        log.warning(
            "live seeding found enough feasible points but their logl is "
            "constant; mixed live set, logZ may carry plateau bias")
    n_keep = min(n_feas, nlive)
    lx = np.empty((nlive, ndim))
    ll = np.empty(nlive)
    lx[:n_keep], ll[:n_keep] = fx[:n_keep], fl[:n_keep]
    if n_keep < nlive:
        x = rng.uniform(size=(nlive - n_keep, ndim))
        lx[n_keep:] = x
        ll[n_keep:] = _loglike_chunked(x)
    if np.all(ll == ll[0]):
        pt = gp.get_random_point(rng=rng, nstd=1.0)
        lx[0] = pt
        ll[0] = float(_loglike_chunked(pt[None, :])[0])
    return lx, ll, 0.0, 0.0


def nested_sampling(gp, mode: str = "acq", ndim: Optional[int] = None,
                    dlogz: Optional[float] = None, dynamic: bool = False,
                    maxcall: Optional[int] = None, equal_weights: bool = False,
                    rng=None, generator: Optional[torch.Generator] = None,
                    nlive: Optional[int] = None,
                    merge_with: Optional[list] = None, n_runs: int = 1,
                    **ns_kwargs) -> Tuple[Dict, Dict, bool]:
    """Nested sampling over the GP surrogate (static mode).

    Returns (samples_dict, logz_dict, success): logz_dict carries
    mean/upper/lower/var/std/dlogz_sampler/h/dlogz_hyp/err_total; samples
    carry x/weights/logl/best/method and ``raw`` (the run's dead points for
    later merging). ``merge_with``: raw tuples of earlier runs on the same
    GP state, merged at the dead-point level. ``n_runs``: independent runs
    at the same settings, merged. ``generator``: the torch generator of the
    run (one is drawn from the global seed chain when None).
    """
    if dynamic:
        raise config.not_ported("Dynamic nested sampling", "dynamic_ns")
    ndim = ndim if ndim is not None else gp.ndim
    nlive_default, dlogz_default, maxcall_default = ns_settings(mode, ndim)
    nlive = nlive if nlive is not None else nlive_default
    dlogz = dlogz if dlogz is not None else dlogz_default
    if mode == "acq":
        equal_weights = True
    elif "n_repeats" not in ns_kwargs and ndim >= 10:
        # high-d decorrelation: 3d slice repeats in convergence runs
        ns_kwargs["n_repeats"] = int(np.ceil(3.0 * ndim))
    if maxcall is None:
        # the call budget scales with the work a converged run needs
        reps = int(ns_kwargs.get("n_repeats") or max(3, np.ceil(1.5 * ndim)))
        maxcall = max(maxcall_default, (100 + 5 * ndim) * int(nlive) * reps)

    rng = rng if rng is not None else get_numpy_rng()
    gen = generator if generator is not None else new_torch_generator(gp.device)

    apply_fn, ctx = _gp_loglike(gp)
    loglike = lambda x: apply_fn(ctx, x)

    live_x = live_logl = None
    logvol0, var_logvol0 = 0.0, 0.0
    if getattr(gp, "use_clf", False):
        raise config.not_ported("Classifier-gated live seeding", "clf")

    n_runs = max(1, int(n_runs))
    gens = split_generator(gen, n_runs) if n_runs > 1 else [gen]
    results = []
    for i, g in enumerate(gens):
        res = run_nested(apply_fn, ctx, ndim, g, nlive=nlive, dlogz=dlogz,
                         maxcall=maxcall, live_x=live_x, live_logl=live_logl,
                         rng=rng, logvol0=logvol0, **ns_kwargs)
        msg = (f"NS ({mode}): {res.n_iter} outer / {res.n_inner} inner "
               f"iterations, {res.n_calls} surrogate calls, "
               f"{len(res.dead_logl)} points, quick logz={res.logz:.3f}")
        (log.debug if mode == "acq" else log.info)(msg)
        if n_runs > 1 and not res.success:
            log.warning(f"NS repeat {i + 1}/{n_runs} failed; dropping it "
                        "from the merge")
            continue
        results.append(res)
    if not results:  # every repeat failed: preserve single-run failure path
        results = [res]
    res = results[-1]

    raws = [(np.asarray(r.dead_x), np.asarray(r.dead_logl),
             np.asarray(r.nlive_schedule, dtype=float), -np.inf)
            for r in results]
    merge_list = (list(merge_with) if merge_with else []) + raws
    if len(merge_list) > 1:
        dead_x, dead_logl, logvol_arr, n_at_death = merge_runs(
            merge_list, logvol0=logvol0)
        raw = (dead_x, dead_logl, n_at_death, -np.inf)
        err_nlive = n_at_death
    else:
        raw = raws[0]
        dead_x, dead_logl, logvol_arr = res.dead_x, res.dead_logl, res.logvol
        err_nlive = res.nlive

    # ---- evidence + GP-uncertainty bounds
    var = gp.predict_var_batched(dead_x).cpu().numpy()
    sigma = np.sqrt(np.clip(var, 0.0, None))
    # LOO calibration: scale sigma by the RMS leave-one-out z-score when it
    # exceeds 1 (never shrink)
    kappa = float(gp.loo_z_rms())
    if np.isfinite(kappa) and kappa > 1.0:
        sigma = sigma * min(kappa, 5.0)
        log.debug(f"LOO calibration: sigma scaled by {min(kappa, 5.0):.2f}")
    logz_dict = integrals.logz_bounds_from_gp_sigma(dead_logl, logvol_arr,
                                                    sigma, lv_start=logvol0)
    h, logzerr = integrals.information_and_err(dead_logl, logvol_arr,
                                               logz_dict["mean"], err_nlive,
                                               lv_start=logvol0)
    sig0 = float(np.sqrt(var_logvol0))
    gp_half_width = float(0.5 * (logz_dict["upper"] - logz_dict["lower"]))
    logz_dict["var"] += var_logvol0
    logz_dict["upper"] += sig0
    logz_dict["lower"] -= sig0
    logz_dict["std"] = float(2.0 * np.sqrt(logz_dict["var"]))
    logz_dict["dlogz_sampler"] = float(np.sqrt(logzerr**2 + var_logvol0))
    logz_dict["h"] = h
    # hyperparameter-fit uncertainty: re-integrate the evidence under each
    # distinct fit basin's GP mean over the same dead-point volumes; the
    # MLL-weighted spread is an independent error term (0 for one basin).
    # Acq-mode runs feed the MC pool only and skip it.
    dlogz_hyp = 0.0
    basins = gp.hyp_basins() if mode != "acq" else []
    if len(basins) >= 2:
        from scipy.special import logsumexp as _lse

        nmll0 = basins[0][1]
        lzs, lw = [], []
        for params, nmll in basins:
            mu = gp.predict_mean_with_params(params, dead_x).cpu().numpy()
            lwt = integrals.logwt_from(mu, logvol_arr, lv_start=logvol0)
            lzs.append(float(_lse(lwt)))
            lw.append(-(nmll - nmll0))
        w = np.exp(np.asarray(lw) - np.max(lw))
        w /= w.sum()
        lz = np.asarray(lzs)
        mean_w = float(np.sum(w * lz))
        dlogz_hyp = float(np.sqrt(np.sum(w * (lz - mean_w) ** 2)))
        if dlogz_hyp > 0.01:
            log.debug(f"hyperparameter-basin logZ spread: "
                      f"{dlogz_hyp:.4f} over {len(basins)} basins")
    logz_dict["dlogz_hyp"] = dlogz_hyp
    logz_dict["err_total"] = float(np.sqrt(
        gp_half_width ** 2 + logz_dict["dlogz_sampler"] ** 2
        + dlogz_hyp ** 2))

    logwt = integrals.logwt_from(dead_logl, logvol_arr, lv_start=logvol0)
    weights = renormalise_log_weights(logwt)
    samples_x, logl = dead_x, dead_logl
    success = res.success and not np.all(logl == logl[0])
    best_pt = samples_x[np.argmax(logl)]
    if equal_weights:
        samples_x, logl = resample_equal(samples_x, logl, weights=weights,
                                         rng=rng)
        weights = np.ones(samples_x.shape[0])
    samples_dict = {"x": samples_x, "weights": weights, "logl": logl,
                    "best": best_pt, "method": "nested", "raw": raw,
                    "n_iter": int(sum(r.n_iter for r in results)),
                    "n_inner": int(sum(r.n_inner for r in results))}
    return samples_dict, logz_dict, success


def sample_gp_nuts(*args, **kwargs):
    raise config.not_ported("NUTS sampling of the GP surrogate", "nuts")


def sample_gp_ensemble(*args, **kwargs):
    raise config.not_ported("The ensemble HMC (EHMC) MC-pool refresh", "ehmc")
