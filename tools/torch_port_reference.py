"""Reference numbers of the JAX package for chip_smoke.py, phases 5, 6, 8,
10 and 12.

Runs the JAX package (bobe_tpu) on the CPU:

1. on the N=1024, d=8 cell of bench.py (the same seed-0 Gaussian data),
   ``GP(noise=1e-8).fit(x0, maxiter=30)`` from bench.py's restart seeds (the
   current hyperparameters plus three seeded draws), then one
   convergence-mode ``nested_sampling`` on a GP built from the fitted
   log-hyperparameters;
2. on that same GP, the MC pools of phase 8: a cold ensemble-HMC pool
   (``sample_gp_ensemble``, 512 samples) and a NUTS pool (4 chains, warmup
   256, 512 samples, thinning 2), reduced to their per-dimension means and
   standard deviations;
3. on examples/gaussian_30d.py's target (d=30, sigma 0.12) at N=1200 seeded
   uniform points with 1 % target noise (capacity 1280, above the fit's
   per-dimension budget, so every objective rebuilds the Gram matrix),
   ``GP(noise=1e-8).fit(x0, maxiter=20)`` from four seeded restarts;
4. on the planck-like target (models/toys.make_planck_like, d=6) at 300
   seeded points (200 reference draws, 100 uniform, the failures at
   -1e10), the classifier-gated GP of ``BOBE(use_clf=True)`` (SVM,
   thresholds of clf_nsigma_threshold=20 at d=6, DSLP prior) fitted once
   (4 restarts, maxiter 200); on it the gated live seeding's feasible
   fraction f_hat (500 live points, numpy seed 1), one convergence-mode
   dynamic ``nested_sampling`` (numpy seed 2) and a cold gated
   ``sample_gp_ensemble`` pool (512 samples) reduced to its moments;
5. on the same 300 points, the gated GP with the input warp
   (``gp_kwargs={"input_warp": True}``) fitted with 8 restarts (maxiter
   200, numpy seed 0): its log-hyperparameters, neg_mll and its gradient
   there, one convergence-mode static ``nested_sampling`` (numpy seed 2)
   and a cold ``sample_gp_ensemble`` pool (512 samples) reduced to its
   moments; and on the data of 1, ``GP(noise=1e-8,
   lengthscale_prior="SAAS")`` fitted with 4 restarts (maxiter 30, numpy
   seed 0), with neg_mll at the fitted parameters;
6. at both fitted states of 5, the JAX package's own roundoff sensitivity:
   how far neg_mll and its gradient move when the training coordinates move
   by 1e-15 relative (4 seeded draws); and two well-conditioned states
   (GP noise 1e-6, a 1 %-noise target): the input warp at d=6 on 200
   points with 8 lanes of hyperparameters, and the SAAS prior at d=8 on
   1024 points with 4 lanes, each with neg_mll and its gradient over the
   lanes and one fit (8 restarts, maxiter 200; 4 restarts, maxiter 30).

It prints one JSON line: the fitted log-hyperparameters, each fit's final
negative MLL, the NS logZ with its ``dlogz_sampler``, the pools' moments and
the planck-like numbers; chip_smoke.py carries them as constants and holds
the PyTorch port to them on the card.

    JAX_PLATFORMS=cpu python tools/torch_port_reference.py [--only-warp-saas | --only-conditioning]
    JAX_PLATFORMS=cpu python tools/torch_port_reference.py --planck-warp-run [--seed 3] [--save-gp final_gp.npz]

``--only-warp-saas`` prints only the numbers of 5 and 6 (phase 12);
``--only-conditioning`` only those of 6, at the fitted parameters that
chip_smoke.py carries.
``--planck-warp-run`` runs examples/planck_like_synthetic.py with the input
warp (BOBE_TPU_EX_WARP=1) to its end (the example's seed 3 unless ``--seed``
says otherwise) and prints its termination, logZ,
|logZ - truth|, err_total, dlogz_sampler, true evaluations and wall: the JAX
package's counterpart of ``tools/torch_port_planck_like.py --warp`` (about an
hour on the CPU).
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

N_TRAIN, NDIM, N_RESTARTS, MAXITER, SEED = 1024, 8, 4, 30, 0
# the d=30 fit above the per-dimension budget (chip_smoke.py phase 6)
N30, D30, SIGMA30, MAXITER30, SEED30 = 1200, 30, 0.12, 20, 30
# the planck-like classifier-gated state (chip_smoke.py phase 10)
N_REF10, N_UNIF10, SEED10, MINUS_INF10 = 200, 100, 10, -1e10


def make_data():
    """bench.py's data: seed-0 Gaussian log-likelihood at N_TRAIN points,
    and the extra restart rows of the fit."""
    rng = np.random.default_rng(SEED)
    x = rng.uniform(size=(N_TRAIN, NDIM))
    y = -0.5 * np.sum(((x - 0.5) / 0.2) ** 2, axis=1)
    y += 0.01 * rng.normal(size=N_TRAIN)
    rng.uniform(size=(64, NDIM))  # bench.py's MC points (unused here)
    x0_extra = rng.uniform(np.log(0.05), np.log(3.0),
                           size=(N_RESTARTS - 1, NDIM + 1))
    return x, y, x0_extra


def make_data_d30(make_gaussian):
    """examples/gaussian_30d.py's target at N30 seeded uniform points, with
    0.01 N(0, 1) target noise as bench.py adds, and the three extra restart
    rows of the fit."""
    loglike, _, _ = make_gaussian(D30, sigma=SIGMA30)
    rng = np.random.default_rng(SEED30)
    x = rng.uniform(size=(N30, D30))
    y = np.array([loglike(p) for p in x]) + 0.01 * rng.normal(size=N30)
    x0_extra = rng.uniform(np.log(0.05), np.log(3.0), size=(3, D30 + 1))
    return x, y, x0_extra


def make_data_planck(toys, scale_to_unit):
    """chip_smoke.py phase 10's data: N_REF10 reference draws and N_UNIF10
    uniform points of the planck-like target in the unit cube, the
    likelihood's failures at MINUS_INF10."""
    loglike, bounds, _, _ = toys.make_planck_like()
    rng = np.random.default_rng(SEED10)
    ref_x, ref_y = toys.planck_like_ref_draws(loglike, bounds, N_REF10, rng)
    u = rng.uniform(size=(N_UNIF10, bounds.shape[1]))
    y = []
    for p in bounds[0] + u * (bounds[1] - bounds[0]):
        try:
            y.append(loglike(p))
        except RuntimeError:
            y.append(MINUS_INF10)
    return (np.vstack([scale_to_unit(ref_x, bounds), u]),
            np.concatenate([ref_y, y]))


def planck_reference():
    """The phase 10 numbers of the JAX package on its gated planck-like
    state."""
    from bobe_tpu.models import toys
    from bobe_tpu.models.clf_gp import GPwithClassifier
    from bobe_tpu.samplers import (_gp_loglike, _seed_live_points,
                                   nested_sampling, sample_gp_ensemble)
    from bobe_tpu.utils.core import get_threshold_for_nsigma, scale_to_unit

    x, y = make_data_planck(toys, scale_to_unit)
    clf_threshold = max(75.0, get_threshold_for_nsigma(20, x.shape[1]))
    gp = GPwithClassifier(train_x=x, train_y=y, clf_type="svm",
                          minus_inf=MINUS_INF10, clf_threshold=clf_threshold,
                          gp_threshold=2 * clf_threshold,
                          probability_threshold=0.5)
    t0 = time.time()
    gp.fit(n_restarts=4, maxiter=200, rng=np.random.default_rng(0))
    t_fit = time.time() - t0
    log_params = np.log(np.r_[np.asarray(gp.lengthscales),
                              gp.kernel_variance])
    apply, ctx = _gp_loglike(gp)
    _, _, logvol0, var0 = _seed_live_points(
        gp, lambda q: apply(ctx, q), 500, x.shape[1],
        np.random.default_rng(1))
    t0 = time.time()
    _, logz, ok = nested_sampling(gp, mode="convergence", dynamic=True,
                                  rng=np.random.default_rng(2))
    t_ns = time.time() - t0
    pool = sample_gp_ensemble(gp, np_rng=np.random.default_rng(3),
                              rng_key=jax.random.PRNGKey(3), num_samples=512)
    return {"planck_log_params": log_params.tolist(),
            "planck_gp_size": int(gp.state.n),
            "planck_n_sv": int(gp.clf_metrics["n_support_vectors"]),
            "planck_f_hat": float(np.exp(logvol0)),
            "planck_var_logvol0": float(var0),
            "planck_dyn_ns_success": bool(ok),
            "planck_dyn_logz": float(logz["mean"]),
            "planck_dyn_dlogz_sampler": float(logz["dlogz_sampler"]),
            "planck_ehmc_mean": np.mean(pool["x"], axis=0).tolist(),
            "planck_ehmc_std": np.std(pool["x"], axis=0).tolist(),
            "cpu_seconds_planck_fit": t_fit,
            "cpu_seconds_planck_dyn_ns": t_ns}


def warp_saas_reference():
    """The phase 12 numbers: the input-warped gated planck-like state and
    the SAAS fit at N=1024, d=8."""
    import jax.numpy as jnp

    from bobe_tpu.models import gp as gpm
    from bobe_tpu.models import toys
    from bobe_tpu.models.clf_gp import GPwithClassifier
    from bobe_tpu.models.gp import GP
    from bobe_tpu.samplers import nested_sampling, sample_gp_ensemble
    from bobe_tpu.utils.core import get_threshold_for_nsigma, scale_to_unit

    x, y = make_data_planck(toys, scale_to_unit)
    clf_threshold = max(75.0, get_threshold_for_nsigma(20, x.shape[1]))
    gp = GPwithClassifier(train_x=x, train_y=y, clf_type="svm",
                          minus_inf=MINUS_INF10, clf_threshold=clf_threshold,
                          gp_threshold=2 * clf_threshold,
                          probability_threshold=0.5, input_warp=True)
    t0 = time.time()
    info = gp.fit(n_restarts=8, maxiter=200, rng=np.random.default_rng(0))
    t_fit = time.time() - t0
    lp = np.asarray(info["params"], dtype=np.float64)
    val, grad = jax.value_and_grad(
        lambda p: gpm.neg_mll(gp.state, gp.cfg, p))(jnp.asarray(lp))
    t0 = time.time()
    _, logz, ok = nested_sampling(gp, mode="convergence",
                                  rng=np.random.default_rng(2))
    t_ns = time.time() - t0
    pool = sample_gp_ensemble(gp, np_rng=np.random.default_rng(3),
                              rng_key=jax.random.PRNGKey(3), num_samples=512)

    xs, ys, _ = make_data()
    saas = GP(train_x=xs, train_y=ys, noise=1e-8, lengthscale_prior="SAAS")
    t0 = time.time()
    sinfo = saas.fit(n_restarts=N_RESTARTS, maxiter=MAXITER,
                     rng=np.random.default_rng(0))
    t_saas = time.time() - t0
    slp = np.asarray(sinfo["params"], dtype=np.float64)
    return {"warp_log_params": lp.tolist(),
            "warp_gp_size": int(gp.state.n),
            "warp_fit_neg_mll": -float(info["mll"]),
            "warp_neg_mll": float(val),
            "warp_neg_mll_grad": np.asarray(grad).tolist(),
            "warp_ns_success": bool(ok),
            "warp_logz": float(logz["mean"]),
            "warp_dlogz_sampler": float(logz["dlogz_sampler"]),
            "warp_ehmc_mean": np.mean(pool["x"], axis=0).tolist(),
            "warp_ehmc_std": np.std(pool["x"], axis=0).tolist(),
            "saas_log_params": slp.tolist(),
            "saas_fit_neg_mll": -float(sinfo["mll"]),
            "saas_neg_mll": float(gpm.neg_mll(saas.state, saas.cfg,
                                              jnp.asarray(slp))),
            "cpu_seconds_warp_fit": t_fit, "cpu_seconds_warp_ns": t_ns,
            "cpu_seconds_saas_fit": t_saas}


# the well-conditioned warp and SAAS states of chip_smoke.py phase 12: GP
# noise 1e-6, a 1 %-noise target, one lane of parameters per restart lane
WC_WARP_N, WC_WARP_D, WC_WARP_SEED, WC_WARP_LANES = 200, 6, 12, 8
WC_SAAS_N, WC_SAAS_D, WC_SAAS_SEED, WC_SAAS_LANES = 1024, 8, 14, 4
# the roundoff sensitivity: seeded relative moves of the training
# coordinates by ROUNDOFF_REL
ROUNDOFF_REL, ROUNDOFF_DRAWS, ROUNDOFF_SEED = 1e-15, 4, 15


def make_data_wc_warp():
    """The well-conditioned warp state's data: a skewed target (its peak
    near a corner) at seeded points, some on the cube's faces, 1 % noise;
    its 8 lanes of log-hyperparameters (ls, amp, log a, log b)."""
    n, d = WC_WARP_N, WC_WARP_D
    rng = np.random.default_rng(WC_WARP_SEED)
    x = rng.uniform(size=(n, d))
    x[0], x[1] = 0.0, 1.0
    x[2, 0], x[3, -1] = 0.0, 1.0
    y = -0.5 * np.sum(((x ** 2 - 0.3) / 0.25) ** 2, axis=1)
    y = y + 0.01 * np.abs(y).std() * rng.normal(size=n)
    rng = np.random.default_rng(WC_WARP_SEED + 1)
    lp = np.concatenate([np.log(np.linspace(0.3, 0.6, d)), [np.log(2.0)],
                         rng.normal(0.0, 0.4, d), rng.normal(0.0, 0.4, d)])
    return x, y, lp[None] + rng.normal(0.0, 0.1, (WC_WARP_LANES, lp.size))


def make_data_wc_saas():
    """The well-conditioned SAAS state's data: one relevant dimension with
    0.01 target noise at seeded points; its 4 lanes of log-hyperparameters
    (ls, amp, tausq)."""
    n, d = WC_SAAS_N, WC_SAAS_D
    rng = np.random.default_rng(WC_SAAS_SEED)
    x = rng.uniform(size=(n, d))
    y = -0.5 * ((x[:, 0] - 0.4) / 0.2) ** 2 + 0.01 * rng.normal(size=n)
    rng = np.random.default_rng(WC_SAAS_SEED + 2)
    lp = np.concatenate([np.log(np.linspace(0.3, 0.6, d)), [np.log(2.0)],
                         [np.log(0.5)]])
    return x, y, lp[None] + rng.normal(0.0, 0.1, (WC_SAAS_LANES, lp.size))


def roundoff_sensitivity(gpm, state, cfg, log_params):
    """(max |d neg_mll|, max |d grad|) of the JAX package's objective at
    ``log_params`` over ROUNDOFF_DRAWS seeded relative moves of the
    training coordinates by ROUNDOFF_REL: how far roundoff alone moves it
    at this state."""
    import jax.numpy as jnp

    vg = jax.value_and_grad(lambda st, p: gpm.neg_mll(st, cfg, p),
                            argnums=1)
    p = jnp.asarray(log_params)
    v0, g0 = vg(state, p)
    rng = np.random.default_rng(ROUNDOFF_SEED)
    dv = dg = 0.0
    for _ in range(ROUNDOFF_DRAWS):
        x = np.asarray(state.x) * (1.0 + ROUNDOFF_REL
                                   * rng.normal(size=state.x.shape))
        v, g = vg(state._replace(x=jnp.asarray(x)), p)
        dv = max(dv, abs(float(v) - float(v0)))
        dg = max(dg, float(np.max(np.abs(np.asarray(g) - np.asarray(g0)))))
    return dv, dg


def conditioning_reference(warp_lp, saas_lp):
    """The phase 12 numbers that bound roundoff: the JAX package's own
    roundoff sensitivity at its fitted warp state (``warp_lp``) and its
    fitted SAAS state (``saas_lp``), both ill-conditioned; and on the
    well-conditioned warp and SAAS states, neg_mll and its gradient over
    the restart lanes and one fit (8 restarts, maxiter 200 for the warp;
    4 restarts, maxiter 30 for SAAS; numpy seed 0)."""
    import jax.numpy as jnp

    from bobe_tpu.models import gp as gpm
    from bobe_tpu.models import toys
    from bobe_tpu.models.clf_gp import GPwithClassifier
    from bobe_tpu.models.gp import GP
    from bobe_tpu.utils.core import get_threshold_for_nsigma, scale_to_unit

    x, y = make_data_planck(toys, scale_to_unit)
    clf_threshold = max(75.0, get_threshold_for_nsigma(20, x.shape[1]))
    gp = GPwithClassifier(train_x=x, train_y=y, clf_type="svm",
                          minus_inf=MINUS_INF10, clf_threshold=clf_threshold,
                          gp_threshold=2 * clf_threshold,
                          probability_threshold=0.5, input_warp=True)
    warp_v, warp_g = roundoff_sensitivity(gpm, gp.state, gp.cfg, warp_lp)
    xs, ys, _ = make_data()
    saas = GP(train_x=xs, train_y=ys, noise=1e-8, lengthscale_prior="SAAS")
    saas_v, saas_g = roundoff_sensitivity(gpm, saas.state, saas.cfg, saas_lp)
    out = {"warp_roundoff_neg_mll": warp_v, "warp_roundoff_grad": warp_g,
           "saas_roundoff_neg_mll": saas_v, "saas_roundoff_grad": saas_g}
    for key, (x, y, lps), kw, fit_kw in (
            ("wc_warp", make_data_wc_warp(), {"input_warp": True},
             {"n_restarts": 8, "maxiter": 200}),
            ("wc_saas", make_data_wc_saas(),
             {"lengthscale_prior": "SAAS", "tausq": 0.5},
             {"n_restarts": N_RESTARTS, "maxiter": MAXITER})):
        g = GP(train_x=x, train_y=y, noise=1e-6, **kw)
        val, grad = jax.vmap(jax.value_and_grad(
            lambda p: gpm.neg_mll(g.state, g.cfg, p)))(jnp.asarray(lps))
        v, dg = roundoff_sensitivity(gpm, g.state, g.cfg, lps[0])
        t0 = time.time()
        info = g.fit(rng=np.random.default_rng(0), **fit_kw)
        out.update({f"{key}_neg_mll": np.asarray(val).tolist(),
                    f"{key}_neg_mll_grad": np.asarray(grad).tolist(),
                    f"{key}_roundoff_neg_mll": v,
                    f"{key}_roundoff_grad": dg,
                    f"{key}_fit_neg_mll": -float(info["mll"]),
                    f"cpu_seconds_{key}_fit": time.time() - t0})
    return out


def planck_warp_run(seed=3, save_gp=None):
    """examples/planck_like_synthetic.py with the input warp, to its end;
    the final GP written to ``save_gp`` (.npz) when given."""
    os.environ["BOBE_TPU_EX_WARP"] = "1"
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples"))
    import planck_like_synthetic as example

    t0 = time.time()
    err, res = example.main(seed=seed)
    if save_gp:
        res["gp"].save(save_gp)
    logz = res["logz"]
    return {"seed": seed, "termination_reason": res["termination_reason"],
            "logz": float(logz["mean"]), "abs_dlogz": float(err),
            "err_total": float(logz["err_total"]),
            "dlogz_sampler": float(logz["dlogz_sampler"]),
            "n_evals": int(res["gp"].clf_data_size),
            "cpu_seconds": time.time() - t0}


def main():
    if "--planck-warp-run" in sys.argv[1:]:
        args = sys.argv[1:]
        seed = int(args[args.index("--seed") + 1]) if "--seed" in args else 3
        save = args[args.index("--save-gp") + 1] if "--save-gp" in args \
            else None
        print(json.dumps({"jax": jax.__version__,
                          **planck_warp_run(seed, save)}))
        return
    if "--only-warp-saas" in sys.argv[1:]:
        ref = warp_saas_reference()
        print(json.dumps({"jax": jax.__version__, **ref,
                          **conditioning_reference(ref["warp_log_params"],
                                                   ref["saas_log_params"])}))
        return
    if "--only-conditioning" in sys.argv[1:]:
        from chip_smoke import JAX_WARP

        print(json.dumps({"jax": jax.__version__, **conditioning_reference(
            JAX_WARP["warp_log_params"], JAX_WARP["saas_log_params"])}))
        return
    from bobe_tpu.models import toys
    from bobe_tpu.models.gp import GP
    from bobe_tpu.samplers import (nested_sampling, sample_gp_ensemble,
                                   sample_gp_nuts)
    from bobe_tpu.utils.seed import set_global_seed

    set_global_seed(0)
    x, y, x0_extra = make_data()
    gp = GP(train_x=x, train_y=y, noise=1e-8)
    x0 = np.vstack([np.log(np.asarray(gp.get_hyperparams()))[None, :],
                    x0_extra])
    t0 = time.time()
    info = gp.fit(x0=x0, maxiter=MAXITER)
    t_fit = time.time() - t0
    params = np.asarray(info["params"], dtype=np.float64)

    ns_gp = GP(train_x=x, train_y=y, noise=1e-8,
               lengthscales=np.exp(params[:NDIM]),
               kernel_variance=float(np.exp(params[NDIM])))
    t0 = time.time()
    _, logz, ok = nested_sampling(ns_gp, mode="convergence",
                                  rng=np.random.default_rng(1))
    t_ns = time.time() - t0

    t0 = time.time()
    ehmc = sample_gp_ensemble(ns_gp, np_rng=np.random.default_rng(2),
                              rng_key=jax.random.PRNGKey(2), num_samples=512)
    nuts = sample_gp_nuts(ns_gp, np_rng=np.random.default_rng(3),
                          rng_key=jax.random.PRNGKey(3), num_chains=4,
                          warmup_steps=256, num_samples=512, thinning=2)
    t_pools = time.time() - t0
    pools = {f"{name}_{stat}": getattr(np, stat)(p["x"], axis=0).tolist()
             for name, p in (("ehmc", ehmc), ("nuts", nuts))
             for stat in ("mean", "std")}

    x30, y30, x0_extra30 = make_data_d30(toys.make_gaussian)
    gp30 = GP(train_x=x30, train_y=y30, noise=1e-8)
    x0_30 = np.vstack([np.log(np.asarray(gp30.get_hyperparams()))[None, :],
                       x0_extra30])
    t0 = time.time()
    info30 = gp30.fit(x0=x0_30, maxiter=MAXITER30)
    t_fit30 = time.time() - t0
    ref = warp_saas_reference()
    print(json.dumps({
        "jax": jax.__version__,
        "log_params": params.tolist(),
        "fit_neg_mll": -float(info["mll"]),
        "ns_success": bool(ok),
        "ns_logz": float(logz["mean"]),
        "ns_dlogz_sampler": float(logz["dlogz_sampler"]),
        "cpu_seconds_fit": t_fit, "cpu_seconds_ns": t_ns,
        **pools, "cpu_seconds_pools": t_pools,
        "d30_fit_neg_mll": -float(info30["mll"]),
        "d30_log_params": np.asarray(info30["params"]).tolist(),
        "cpu_seconds_fit_d30": t_fit30,
        **planck_reference(), **ref,
        **conditioning_reference(ref["warp_log_params"],
                                 ref["saas_log_params"])}))


if __name__ == "__main__":
    main()
