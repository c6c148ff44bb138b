"""Surrogate samplers: nested sampling, NUTS and ensemble HMC over the GP
mean.

Counterpart of ``bobe_tpu/samplers.py``:

* ``nested_sampling(gp, mode=...)`` runs the batched sampler of
  infer/nested.py (static, or ``dynamic=True``: a base run plus a
  posterior-bulk batch) with the GP mean as the likelihood and returns the
  evidence with its GP-sigma bounds, the sampler error, and the
  hyperparameter-basin spread;
* ``sample_gp_ensemble`` (infer/ehmc.py, the BO loop's default MC-pool
  refresh) and ``sample_gp_nuts`` (infer/nuts.py, the final-sample
  fallback) sample the GP-mean posterior on the logit-transformed unit cube
  and return the JAX package's samples dict, whose ``warm_state`` (numpy
  arrays) seeds the next call of either package.

Over a classifier-gated GP (models/clf_gp.py) every target is gated: the GP
mean where the classifier says feasible, ``minus_inf`` elsewhere. Nested
sampling then seeds its live set strictly inside the feasible region and
starts its volume ledger at the log feasible fraction; the HMC targets are
tempered as a whole, and a warm chain start that the retrained classifier
now puts on the plateau rejects the warm path.

With a production mesh (parallel/mesh.py: two or more cards and
``BOBE_TPU_MESH=1``) the samplers
spread their work over its devices: nested sampling splits each proposal
batch, NUTS runs its chains in groups, one per device, and the ensemble
(whose chains share one adapted kernel) splits the evaluation of its target
at every leapfrog step; the chain counts are rounded up to a multiple of
the mesh (``_mesh_aligned_chains``). Every chain draws the same numbers on
any layout: the layout changes where the chains run, and with the width of
each batched GP evaluation its roundoff, which the dynamics amplify.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import config
from .infer import integrals
from .infer.ehmc import run_ensemble
from .infer.nested import merge_runs, run_nested, run_nested_dynamic
from .infer.nuts import run_chain
from .models import gp as gpm
from .models.classifiers import predict_proba_apply
from .parallel.mesh import production_mesh, sharded_nuts, sharded_target
from .utils import trace
from .utils.core import renormalise_log_weights, resample_equal
from .utils.log import get_logger
from .utils.seed import get_numpy_rng, new_torch_generator, split_generator

log = get_logger("sampler")


def _gp_loglike(gp) -> Tuple:
    """(apply_fn, ctx) for the GP mean, classifier-gated when the surrogate
    carries an active classifier: apply(ctx, x (m, d)) -> (m,)."""
    cfg = gp.cfg
    clf = getattr(gp, "_clf_ctx", None)
    if clf is None:
        return (lambda state, x: gpm.predict_mean(state, cfg, x)), gp.state
    proba = predict_proba_apply(gp.clf_type)

    def apply(ctx, x):
        state, params = ctx
        return gp.gated(proba(params, x), gpm.predict_mean(state, cfg, x),
                        gp.minus_inf)

    return apply, (gp.state, clf)


# ------------------------------------------------------------ nested sampling

def ns_settings(mode: str, ndim: int) -> Tuple[int, float, int]:
    """(nlive, dlogz, maxcall) per mode."""
    if mode == "acq":
        return max(100, min(500, 20 * ndim)), 0.1, int(2e6)
    return max(500, 40 * ndim), 0.01, int(5e6)


@trace.traced("ns.seed")
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
    trace.count("live", nlive)
    for _ in range(maxtries):
        x = rng.uniform(size=(nlogl, ndim))
        logl = _loglike_chunked(x)
        ok = logl > floor
        n_ok = int(ok.sum())
        n_drawn += nlogl
        n_feas += n_ok
        trace.count("draws", nlogl)
        trace.count("feasible", n_ok)
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


@trace.traced("ns.evidence", fresh="evidence")
def nested_sampling(gp, mode: str = "acq", ndim: Optional[int] = None,
                    dlogz: Optional[float] = None, dynamic: bool = False,
                    maxcall: Optional[int] = None, equal_weights: bool = False,
                    rng=None, generator: Optional[torch.Generator] = None,
                    nlive: Optional[int] = None,
                    merge_with: Optional[list] = None, n_runs: int = 1,
                    **ns_kwargs) -> Tuple[Dict, Dict, bool]:
    """Nested sampling over the GP surrogate; ``dynamic=True`` adds a
    posterior-bulk refinement batch to each run (infer/nested.py
    ``run_nested_dynamic``).

    Returns (samples_dict, logz_dict, success): logz_dict carries
    mean/upper/lower/var/std/dlogz_sampler/h/dlogz_hyp/err_total; samples
    carry x/weights/logl/best/method and ``raw`` (the run's dead points for
    later merging). ``merge_with``: raw tuples of earlier runs on the same
    GP state, merged at the dead-point level. ``n_runs``: independent runs
    at the same settings, merged; over a classifier-gated GP each run seeds
    its own live set, and the merged ledger starts at the runs' pooled
    feasible fraction. ``generator``: the torch generator of the run (one is
    drawn from the global seed chain when None).
    """
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
    # the proposal batches' GP evaluations split over the production mesh
    ns_kwargs.setdefault("mesh", production_mesh(gp.device))

    live_x = live_logl = None
    logvol0, var_logvol0 = 0.0, 0.0
    gated = getattr(gp, "use_clf", False)
    if gated:
        live_x, live_logl, logvol0, var_logvol0 = _seed_live_points(
            gp, loglike, nlive, ndim, rng)

    runner = run_nested_dynamic if dynamic else run_nested
    n_runs = max(1, int(n_runs))
    gens = split_generator(gen, n_runs) if n_runs > 1 else [gen]
    results, lv0s, vlv0s = [], [], []
    for i, g in enumerate(gens):
        if i > 0 and gated:
            # each repeat an independent realisation, its own live seeding
            live_x, live_logl, logvol0, var_logvol0 = _seed_live_points(
                gp, loglike, nlive, ndim, rng)
        with trace.span("ns.run"):
            res = runner(apply_fn, ctx, ndim, g, nlive=nlive, dlogz=dlogz,
                         maxcall=maxcall, live_x=live_x,
                         live_logl=live_logl, rng=rng, logvol0=logvol0,
                         **ns_kwargs)
        msg = (f"NS ({mode}): {res.n_iter} outer / {res.n_inner} inner "
               f"iterations, {res.n_calls} surrogate calls, "
               f"{len(res.dead_logl)} points, quick logz={res.logz:.3f}")
        (log.debug if mode == "acq" else log.info)(msg)
        if n_runs > 1 and not res.success:
            log.warning(f"NS repeat {i + 1}/{n_runs} failed; dropping it "
                        "from the merge")
            continue
        results.append(res)
        lv0s.append(logvol0)
        vlv0s.append(var_logvol0)
    if not results:  # every repeat failed: preserve single-run failure path
        results, lv0s, vlv0s = [res], [logvol0], [var_logvol0]
    res = results[-1]
    # pooled seed volume of the repeats: independent binomial estimates of
    # one feasible fraction, the mean of the logs with variance / n
    logvol0 = float(np.mean(lv0s))
    var_logvol0 = float(np.mean(vlv0s)) / len(vlv0s)

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
        # a dynamic run's live count depends on the region: its per-death
        # schedule is the error denominator
        err_nlive = res.nlive_schedule if dynamic else res.nlive

    # ---- evidence + GP-uncertainty bounds
    bounds_span = trace.span("ns.bounds", sync=True)
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
                    "n_inner": int(sum(r.n_inner for r in results)),
                    "n_calls": int(sum(r.n_calls for r in results))}
    bounds_span.close()
    return samples_dict, logz_dict, success




# ----------------------------------------------------------------------- MCMC

def get_hmc_settings(ndim, warmup_steps=None, num_samples=None, thinning=None):
    """(warmup_steps, num_samples, thinning) for NUTS, by dimension."""
    warmup_steps = warmup_steps if warmup_steps is not None else (256 if ndim <= 9 else 512)
    num_samples = num_samples if num_samples is not None else (1024 if ndim <= 9 else 2048)
    thinning = thinning if thinning is not None else 4
    return warmup_steps, num_samples, thinning


def _logprob_target(gp, temp: float):
    """(make_vg, ctx) of the target density on R^d: ``make_vg(ctx)`` is
    ``vg(z) -> (logp (C,), grad (C, d))``, the logit-transformed
    Uniform(0, 1)^d prior plus the tempered GP mean, with its gradient in
    closed form (models/gp.mean_value_and_grad_fn). ``ctx`` holds the
    device state (the GP's, and the classifier's parameters), so a replica
    of it on another device builds the same target there.

    Over a classifier-gated GP the mean is ``minus_inf`` where the
    classifier says infeasible and its gradient there 0 (the gradient of
    the hard gate), leaving the Jacobian term."""
    cfg = gp.cfg
    temp = float(temp)
    softplus = torch.nn.functional.softplus
    clf = getattr(gp, "_clf_ctx", None)
    if clf is not None:
        proba = predict_proba_apply(gp.clf_type)
        thr, minus_inf = float(gp.probability_threshold), float(gp.minus_inf)

    def make_vg(ctx):
        state, clf_params = ctx
        mean_vg = gpm.mean_value_and_grad_fn(state, cfg)

        def vg(z):
            nz = -z
            x, x_neg = torch.sigmoid(z), torch.sigmoid(nz)
            mean, g = mean_vg(x)
            if clf_params is not None:
                ok = proba(clf_params, x) >= thr
                mean = torch.where(ok, mean, torch.full_like(mean, minus_inf))
                g = g * ok[:, None].to(g.dtype)
            # log|dx/dz| = -(softplus(z) + softplus(-z)): finite where the
            # sigmoid saturates (log(x) + log1p(-x) is not); its gradient
            # is sigmoid(-z) - sigmoid(z), and dx/dz = x sigmoid(-z)
            log_jac = torch.sum(softplus(z) + softplus(nz), dim=-1)
            return (mean / temp - log_jac,
                    torch.addcmul(x_neg - x, g, x * x_neg, value=1.0 / temp))

        return vg

    return make_vg, (gp.state, clf)


def _logprob_vg(gp, temp: float):
    """The target's ``vg`` on the GP's own device (:func:`_logprob_target`)."""
    make_vg, ctx = _logprob_target(gp, temp)
    return make_vg(ctx)


def _mesh_aligned_chains(num_chains: int, device) -> int:
    """The chain count rounded up to a multiple of the production mesh's
    size, so that every device of the mesh runs an equal share; extra
    chains only enlarge the pool."""
    mesh = production_mesh(device)
    if mesh is None or num_chains % len(mesh) == 0:
        return int(num_chains)
    return int(-(-num_chains // len(mesh)) * len(mesh))


def _maybe_shard_chains(sampler, make_vg, ctx, init_z, gen, **kw):
    """``sampler`` (infer/nuts.run_chain or infer/ehmc.run_ensemble) on the
    target ``make_vg(ctx)`` from ``init_z``, with its chains over the
    production mesh when one is active and divides them. NUTS chains are
    independent: they run in groups, one per device, each chain on its own
    generator (``gen``: the list of them). The ensemble adapts one kernel
    over all its chains (``gen``: its one generator): every leapfrog step's
    evaluation of the target is split over the devices."""
    mesh = production_mesh(init_z.device)
    if mesh is None or init_z.shape[0] % len(mesh) != 0:
        return sampler(make_vg(ctx), init_z, gen, **kw)
    if sampler is run_chain:
        return sharded_nuts(make_vg, ctx, init_z, gen, mesh, **kw)
    return sampler(sharded_target(make_vg, ctx, mesh), init_z, gen, **kw)


def _plateau_frac_ok(vg, warm_state, gp, temp) -> float:
    """Fraction of the cached chain ends still feasible. The classifier
    retrains between refreshes and can strand ends on the ``minus_inf``
    plateau, where the acceptance guard is blind; ``vg`` is tempered, so
    the plateau sits near minus_inf / temp and so does the threshold."""
    z = torch.as_tensor(np.array(warm_state["last_z"]), dtype=config.DTYPE,
                        device=gp.device)
    start_lp = vg(z)[0]
    return float(torch.mean(
        (start_lp > 0.5 * float(gp.minus_inf) / float(temp)).to(z.dtype)))


def _cold_logit_inits(gp, num_chains, np_rng):
    """Chain starts: random points plus the incumbent, in logit space."""
    inits = [gp.get_random_point(rng=np_rng)
             for _ in range(max(0, num_chains - 1))]
    best_x = gp.train_x[int(torch.argmax(gp.train_y))].cpu().numpy()
    inits.append(best_x)
    inits = np.clip(np.asarray(inits[:num_chains]), 1e-6, 1 - 1e-6)
    return torch.as_tensor(np.log(inits) - np.log1p(-inits),
                           dtype=config.DTYPE, device=gp.device)


def _warm_state_matches(warm_state, kind, num_chains, ndim, dense_mass, temp,
                        default_kind=None) -> bool:
    """Kernel reuse needs the same sampler, shapes and temperature: a kernel
    adapted to a differently tempered target would pass the acceptance
    guard while carrying burn-in bias."""
    return (warm_state is not None
            and warm_state.get("kind", default_kind) == kind
            and warm_state.get("num_chains") == num_chains
            and warm_state.get("ndim") == ndim
            and warm_state.get("dense_mass") == bool(dense_mass)
            and warm_state.get("temp") == float(temp))


def _warm_kernel_tuple(warm_state, device):
    return tuple(torch.as_tensor(np.array(warm_state[k]), dtype=config.DTYPE,
                                 device=device)
                 for k in ("step_size", "mass_inv", "mass_chol"))


def _warm_outcome(low_accept: bool, divergent: bool) -> str:
    """The ``outcome`` of an ``mc.warm`` span whose warm run ran."""
    if low_accept:
        return "rejected_accept"
    return "rejected_divergence" if divergent else "kept"


def _bundle_samples(gp, zs, diag, kind, num_chains, dense_mass, temp) -> Dict:
    """The samples dict of the JAX package (x / logp / best / method,
    diagnostics, warm_state), in numpy. 'logp' is the untempered (and, over
    a classifier-gated GP, gated) GP mean at the samples."""
    xs_t = torch.sigmoid(zs.reshape(-1, gp.ndim))
    xs = xs_t.cpu().numpy()
    logp = gp.predict_mean_batched(xs_t).cpu().numpy()
    np_ = lambda v: v.cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)
    return {"x": xs, "logp": logp, "best": xs[np.argmax(logp)],
            "method": "MCMC",
            "diagnostics": {k: np_(diag[k]) for k in
                            ("mean_accept", "n_divergent", "step_size")},
            "warm_state": {**{k: np_(diag[k]) for k in
                              ("step_size", "mass_inv", "mass_chol", "last_z")},
                           "kind": kind, "num_chains": num_chains,
                           "ndim": gp.ndim, "dense_mass": bool(dense_mass),
                           "temp": float(temp)}}


def sample_gp_nuts(gp, np_rng=None, generator: Optional[torch.Generator] = None,
                   num_chains: int = 4, temp: float = 1.0,
                   dense_mass: bool = True, max_tree_depth: int = 6,
                   warm_state: Optional[Dict] = None, **kwargs) -> Dict:
    """NUTS samples of the GP-mean posterior (infer/nuts.py); returns the
    samples dict (x / logp / best / method / diagnostics / warm_state).

    ``warm_state`` (an earlier call's entry, from either package): reuse the
    adapted per-chain step size and mass and continue from the chain ends,
    with a short fixed-mass step-size re-adaptation instead of the full
    windowed warmup. If the warm run's acceptance collapses or divergences
    appear it is discarded for a cold run. ``generator``: the torch
    generator of the call; each chain draws from a child of it."""
    warmup_steps, num_samples, thinning = get_hmc_settings(
        ndim=gp.ndim, **{k: v for k, v in kwargs.items()
                         if k in ("warmup_steps", "num_samples", "thinning")})
    num_chains = _mesh_aligned_chains(int(num_chains), gp.device)
    np_rng = np_rng if np_rng is not None else get_numpy_rng()
    gen = generator if generator is not None else new_torch_generator(gp.device)
    make_vg, ctx = _logprob_target(gp, temp)
    gens = split_generator(gen, num_chains)
    # default_kind="nuts": warm states without a 'kind' field are NUTS's
    warm_ok = _warm_state_matches(warm_state, "nuts", num_chains, gp.ndim,
                                  dense_mass, temp, default_kind="nuts")
    warm = trace.span("mc.warm") if warm_ok else trace.NULL
    if warm_ok and getattr(gp, "_clf_ctx", None) is not None and \
            _plateau_frac_ok(_logprob_vg(gp, temp), warm_state, gp, temp) < 1.0:
        log.debug("warm NUTS rejected: a cached chain end now falls in "
                  "the classifier's infeasible region")
        warm_ok = False
        warm.set("outcome", "rejected_plateau")
    common = dict(num_samples=int(num_samples), thinning=int(thinning),
                  dense_mass=bool(dense_mass), max_depth=int(max_tree_depth))
    if warm_ok:
        z0 = torch.as_tensor(np.array(warm_state["last_z"]),
                             dtype=config.DTYPE, device=gp.device)
        zs, _, diag = _maybe_shard_chains(
            run_chain, make_vg, ctx, z0, gens,
            num_warmup=max(32, int(warmup_steps) // 4),
            warm=_warm_kernel_tuple(warm_state, gp.device), adapt_mass=False,
            **common)
        warm.count("leapfrog", diag["n_leapfrog"])
        accept = float(torch.mean(diag["mean_accept"]))
        div_rate = float(torch.sum(diag["n_divergent"])) / max(
            1, num_chains * int(num_samples))
        outcome = _warm_outcome(accept < 0.6, div_rate > 0.05)
        warm.set("outcome", outcome)
        if outcome != "kept":
            log.debug(f"warm NUTS rejected (accept={accept:.2f}, "
                      f"div={div_rate:.3f}); falling back to cold warmup")
            warm_ok = False
    warm.close()
    if not warm_ok:
        with trace.span("mc.cold", sync=True) as cold:
            zs, _, diag = _maybe_shard_chains(
                run_chain, make_vg, ctx,
                _cold_logit_inits(gp, num_chains, np_rng), gens,
                num_warmup=int(warmup_steps), **common)
            cold.count("leapfrog", diag["n_leapfrog"])
    out = _bundle_samples(gp, zs, diag, "nuts", num_chains, dense_mass, temp)
    out["diagnostics"].update(n_leapfrog=diag["n_leapfrog"], warm=warm_ok)
    log.debug(f"NUTS: mean accept="
              f"{np.mean(out['diagnostics']['mean_accept']):.3f}, divergences="
              f"{int(np.sum(out['diagnostics']['n_divergent']))}")
    return out


def get_ehmc_settings(ndim, num_chains=None, num_samples=None, warmup_steps=None):
    """(num_chains, kept_per_chain, cold_warmup) for the ensemble refresh;
    ``num_samples`` is the total pool size."""
    num_chains = int(num_chains) if num_chains else 64
    total = int(num_samples) if num_samples else (1024 if ndim <= 9 else 2048)
    kept = max(4, -(-total // num_chains))
    cold_warmup = int(warmup_steps) if warmup_steps else (128 if ndim <= 9 else 256)
    return num_chains, kept, cold_warmup


def sample_gp_ensemble(gp, np_rng=None,
                       generator: Optional[torch.Generator] = None,
                       num_chains: int = 64, temp: float = 1.0,
                       dense_mass: bool = True, num_leapfrog: int = 16,
                       warm_state: Optional[Dict] = None, **kwargs) -> Dict:
    """MC-pool refresh by the lockstep chain ensemble (infer/ehmc.py), the
    BO loop's default; the samples dict of :func:`sample_gp_nuts`.

    With a matching ``warm_state`` the previous refresh's chain ends, step
    size and mass seed a 24-transition fixed-mass re-adaptation; an
    acceptance below 0.5 or a divergence rate above 0.05 rejects it for a
    cold start (random points and the incumbent, the full warmup)."""
    nc, kept, cold_warmup = get_ehmc_settings(
        gp.ndim, num_chains=_mesh_aligned_chains(int(num_chains), gp.device),
        num_samples=kwargs.get("num_samples"),
        warmup_steps=kwargs.get("warmup_steps"))
    thinning = int(kwargs.get("thinning") or 2)
    np_rng = np_rng if np_rng is not None else get_numpy_rng()
    gen = generator if generator is not None else new_torch_generator(gp.device)
    make_vg, ctx = _logprob_target(gp, temp)
    common = dict(num_samples=kept, thinning=thinning,
                  dense_mass=bool(dense_mass), num_leapfrog=int(num_leapfrog))
    warm_ok = _warm_state_matches(warm_state, "ehmc", nc, gp.ndim,
                                  dense_mass, temp)
    warm = trace.span("mc.warm") if warm_ok else trace.NULL
    if warm_ok and getattr(gp, "_clf_ctx", None) is not None:
        # the lockstep ensemble tolerates a few stranded chains (they
        # re-enter during the re-adaptation): 0.9 where NUTS needs all
        frac_ok = _plateau_frac_ok(_logprob_vg(gp, temp), warm_state, gp, temp)
        if frac_ok < 0.9:
            log.debug(f"warm ensemble rejected: {1 - frac_ok:.0%} of chain "
                      "ends now infeasible under the retrained classifier")
            warm_ok = False
            warm.set("outcome", "rejected_plateau")
    if warm_ok:
        z0 = torch.as_tensor(np.array(warm_state["last_z"]),
                             dtype=config.DTYPE, device=gp.device)
        zs, _, diag = _maybe_shard_chains(
            run_ensemble, make_vg, ctx, z0, gen, num_warmup=24,
            warm=_warm_kernel_tuple(warm_state, gp.device), adapt_mass=False,
            **common)
        warm.count("leapfrog", diag["n_leapfrog"])
        accept = float(diag["mean_accept"])
        div_rate = float(diag["n_divergent"]) / max(1, nc * kept * thinning)
        outcome = _warm_outcome(accept < 0.5, div_rate > 0.05)
        warm.set("outcome", outcome)
        if outcome != "kept":
            log.debug(f"warm ensemble rejected (accept={accept:.2f}, "
                      f"div={div_rate:.3f}); cold restart")
            warm_ok = False
    warm.close()
    if not warm_ok:
        with trace.span("mc.cold", sync=True) as cold:
            zs, _, diag = _maybe_shard_chains(
                run_ensemble, make_vg, ctx,
                _cold_logit_inits(gp, nc, np_rng), gen,
                num_warmup=cold_warmup, **common)
            cold.count("leapfrog", diag["n_leapfrog"])
            cold.count("leapfrog_warmup", diag["n_leapfrog_warmup"])
    out = _bundle_samples(gp, zs, diag, "ehmc", nc, dense_mass, temp)
    out["diagnostics"].update(n_leapfrog=diag["n_leapfrog"], warm=warm_ok)
    log.debug(f"EHMC: accept={float(out['diagnostics']['mean_accept']):.3f}, "
              f"divergences={int(out['diagnostics']['n_divergent'])}")
    return out
