#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bobe_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # every phase, one card

Phases (each prints its own lines; nothing is caught, any failure exits
non-zero):

1. build the CUDA kernels from bobe_tpu_torch/csrc/gram_masked.cu;
2. hold the Gram forward kernel against its plain PyTorch version on the
   card, over rbf/matern, float32/float64, a range of capacities (the main
   path's 128, 1024 and 1280 among them) and dimensions (d=40 stages its
   dimensions in two chunks), one and four restart lanes;
2b. hold the Gram backward kernel against its plain version (rbf/matern,
   float64, four capacities, four dimensions, one and four lanes, a random
   cotangent), and two of its launches against each other bit for bit;
3. time both kernels on the card: device time from a CUDA graph of
   back-to-back launches into preallocated outputs, the wrapper's wall per
   call, the plain versions (CUDA events, median of 25) and the bound;
4. run the slice end to end: BOBE on the banana toy, WIPStd acquisition with
   an NS-mode MC pool, on the card;
5. the slice's operations at N=1024, d=8 (the bench.py cell): a GP fit, a
   WIPStd batch, and a convergence-mode nested sampling run checked against
   the JAX package's logZ for the same GP state;
6. a GP fit above the per-dimension budget: examples/gaussian_30d.py's
   target at N=1200 (capacity 1280, d=30), whose every objective runs the
   forward and backward kernels, checked against the JAX package's neg_mll;
7. phase 4's banana run with BOBE's own default MC pool (ensemble HMC), to
   convergence;
8. the MCMC MC pools at N=1024, d=8 (phase 5's GP with the JAX package's
   fitted hyperparameters): a cold ensemble-HMC pool, a warm one from its
   warm_state and a NUTS pool, each timed, their moments held to each other
   and to the JAX package's; the device launches per leapfrog step (the
   target's mean and gradient included) under torch.profiler;
9. the final NUTS samples of a banana run that ends before any nested
   sampling (min_evals > max_evals), timed (cut to 250 transitions per
   dimension, from 2000);
10. the classifier-gated state of the planck-like target (d=6, 300 seeded
   points, the JAX package's fitted hyperparameters): the port's SVM
   trained on it (and timed at n = 100, 250, 500), the gated live seeding's
   feasible fraction against the JAX package's, a convergence-mode dynamic
   NS against the JAX package's logZ, timed beside a static NS on the same
   state, the wall and device launches per NS iteration of the gated GP and
   of the plain GP of the same rows, and a cold gated ensemble-HMC pool
   against the JAX package's moments;
11. examples/planck_like_synthetic.py's run at its own settings
   (use_clf=True, do_final_ns=True) with min_evals above max_evals=120, so
   that it ends on the final fit, the dynamic NS and its top-up (cut to 3
   merged runs in all, from 16); checked for its termination, a finite
   logZ, an engaged classifier and final samples in the box, with its
   timing ledger.

The kernels' launch counts are set to 0 just before each of phases 4 to 11
and read just after; a phase that did not launch the forward kernel, or
phase 6 without a backward launch, fails. The script prints the card's name
and power limit, one JSON line describing every kernel, and as its last
line {"ok": true, "device": {...}}. Without a CUDA card it exits non-zero
before printing any result.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time

SOURCE = "bobe_tpu_torch/csrc/gram_masked.cu"
REPLACES = "bobe_tpu/ops/pallas_gram.py:79"
# the backward has no TPU kernel: it replaces the JAX package's autodiff of
# its XLA Gram build on the fit's Gram route
REPLACES_BACKWARD = "bobe_tpu/models/gp.py:390"

# NVIDIA H100 SXM peaks (data sheet): HBM3 bandwidth, FP64 and FP32 outside
# the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {8: 34e12, 4: 67e12}
# f64 operations per distinct Gram entry that the function needs: 3 per
# dimension for the distance (subtract, multiply, add), ~20 for the exp and
# the scaling; the backward adds one FMA (2) per dimension for the gradient
# sum w * D^2 and ~5 for the weight
FWD_OPS = (3, 20)
BWD_OPS = (5, 25)

# ---- phase 5 reference numbers of the JAX package (bobe_tpu as of commit
# 155be3e, JAX 0.9.0, on the CPU), printed by
#     JAX_PLATFORMS=cpu python tools/torch_port_reference.py
# on bench.py's N=1024, d=8 data: the fit from bench.py's restart seeds
# (maxiter 30) and one convergence-mode nested_sampling on a GP built from
# the fitted log-hyperparameters.
JAX_LOG_PARAMS = [0.7844588899324435, 0.6964054980573419, 0.7737947772336541,
                  0.6599924979111108, 0.6386270036440569, 0.7648455420467349,
                  0.7292378357586795, 0.6894914935417619, 5.627503208890386]
JAX_FIT_NEG_MLL = -1964.7464894774164
JAX_LOGZ = -5.618079417235099
JAX_DLOGZ_SAMPLER = 0.06326139586502569
# log of the integral of exp(-|x - 0.5|^2 / (2 * 0.2^2)) over [0, 1]^8
ANALYTIC_LOGZ_N1024 = -5.6240
BANANA_LOGZ = -3.185

N_TRAIN, NDIM, N_RESTARTS, MAXITER, SEED = 1024, 8, 4, 30, 0

# ---- phase 6 reference of the JAX package, printed by the same tool:
# examples/gaussian_30d.py's target (d=30, sigma 0.12) at N=1200 seeded
# uniform points with 1 % target noise, fit from four seeded restarts
# (maxiter 20) on the JAX package's Gram route
N30, D30, SIGMA30, MAXITER30, SEED30 = 1200, 30, 0.12, 20, 30
JAX_D30_FIT_NEG_MLL = 1163.7814835559184
# relative tolerance of the phase 6 neg_mll against the JAX package's
D30_RTOL = 1e-6

# ---- phase 8 reference of the JAX package, printed by the same tool: the
# per-dimension mean and standard deviation of a cold sample_gp_ensemble
# pool (512 samples) and of a sample_gp_nuts pool (4 chains, warmup 256, 512
# samples, thinning 2) on the GP of JAX_LOG_PARAMS
JAX_EHMC_MEAN = [0.49689276521331077, 0.49992078518869887, 0.5026468349295888,
                 0.5058199736480079, 0.49432114680117245, 0.49324801288730546,
                 0.4895336585496192, 0.5002222706616333]
JAX_EHMC_STD = [0.18114628620139656, 0.19404535877444337, 0.21017862972514154,
                0.19324592531417206, 0.19660617844530096, 0.18766265909526253,
                0.1894011842826286, 0.1803458941836067]
JAX_NUTS_MEAN = [0.4920547566236123, 0.5094304892436333, 0.507352506457011,
                 0.48289516284997397, 0.4986943389606279, 0.49619707734752994,
                 0.5155613369767995, 0.5028815084709358]
JAX_NUTS_STD = [0.18524113815603163, 0.1909502709413334, 0.19631888962349942,
                0.1895987590759816, 0.19127804621505665, 0.1844431483566775,
                0.1982995888963466, 0.18779876025205416]
# largest difference of a pool's per-dimension mean or std from another's
POOL_ATOL = 0.05
# phase 9's depth is cut to keep the script near 10 minutes: its final NUTS
# takes 250 transitions per dimension (2 x 4 chains x 250 / 4 = 500 samples)
# where a user's run takes 2000 (bo.FINAL_NUTS)
FALLBACK_SAMPLES_PER_DIM = 250

# ---- phase 10 reference of the JAX package, printed by the same tool: the
# planck-like target at N_REF10 reference draws and N_UNIF10 uniform points
# (failures at MINUS_INF10), the SVM-gated GP of BOBE(use_clf=True) fitted
# once (4 restarts, maxiter 200); the feasible fraction of its live seeding
# (500 live points, numpy seed 1) with the variance of its log, one
# convergence-mode dynamic nested_sampling (numpy seed 2) and the moments of
# a cold gated sample_gp_ensemble pool (512 samples)
N_REF10, N_UNIF10, SEED10, MINUS_INF10 = 200, 100, 10, -1e10
JAX_PLANCK = {
    "planck_log_params": [
        -0.2916060436059232, 1.609307182330881, -0.20078794254496668,
        1.609363644235881, 1.6094368429851593, 1.6094372130721708,
        9.460380583973471,
    ],
    "planck_gp_size": 209,
    "planck_n_sv": 62,
    "planck_f_hat": 0.17653333333333335,
    "planck_var_logvol0": 0.0001554884189325277,
    "planck_dyn_logz": 9.17189310608647,
    "planck_dyn_dlogz_sampler": 0.11161919155706375,
    "planck_ehmc_mean": [
        0.5046465242581957, 0.5028851313363157, 0.5039918487053004,
        0.5007602620319461, 0.49887375321722977, 0.4999037642738581,
    ],
    "planck_ehmc_std": [
        0.0491809348893158, 0.03482696382646268, 0.05238355378371699,
        0.03917535117733008, 0.03843047704848718, 0.05143024479747705,
    ],
}
# the planck-like run of phase 11: examples/planck_like_synthetic.py's
# settings, ended at max_evals (min_evals above it). Its depth is cut at the
# final NS: the merged-run cap (BOBE_TPU_NS_BOOST_CAP) is 3 where a user's
# run has 16, so the final pass is 2 dynamic runs and a 1-run static top-up
# (each NS on the gated GP takes ~30 s of the card's launch-bound loop)
PLANCK_NS_BOOST_CAP = 3
PLANCK_RUN = dict(acq="wipstd", min_evals=1000, max_evals=120,
                  max_gp_size=600, logz_threshold=0.05, fit_n_points=8,
                  batch_size=4, ns_n_points=12, convergence_n_iters=2,
                  do_final_ns=True)


def _sync():
    import torch

    torch.cuda.synchronize()


def _median_ms(fn, n=25, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    _sync()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def phase_build():
    from bobe_tpu_torch.ops import kernels as kr

    t0 = time.time()
    kr.build_library()
    print(f"[phase 1] built {kr.build_info['path']} in "
          f"{time.time() - t0:.2f} s")
    for line in kr.build_info.get("log", "").splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"[phase 1] ptxas: {line.strip()}")


def _inputs(cap, d, seed, dtype, device, lanes=None):
    """x, mask (pad rows past 0.7 cap), lengthscales and amplitude: one set
    ((d,), ()) or ``lanes`` restart lanes ((lanes, d), (lanes,)). Above d=8
    the lengthscales grow as sqrt(d / 8), so that many correlations stay
    well above roundoff and a fault in any dimension shows."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.uniform(size=(cap, d)), device=device)
    n = max(1, int(0.7 * cap))
    mask = (torch.arange(cap, device=device) < n).double()
    shape = (d,) if lanes is None else (lanes, d)
    ls = torch.as_tensor(rng.uniform(0.05, 2.0, size=shape)
                         * max(1.0, math.sqrt(d / 8)), device=device)
    amp = torch.as_tensor(rng.uniform(0.5, 3.0, size=shape[:-1]),
                          dtype=torch.float64, device=device)
    return (x.to(dtype), mask.to(dtype), ls.to(dtype), amp.to(dtype), 1e-6, n)


def phase_kernel_check():
    import torch

    from bobe_tpu_torch.ops import kernels as kr

    dev = torch.device("cuda")
    worst = {torch.float64: 0.0, torch.float32: 0.0}
    tol = {torch.float64: (1e-10, 1e-12), torch.float32: (2e-5, 2e-5)}
    n_cases = 0
    for name in ("rbf", "matern"):
        for dt in (torch.float64, torch.float32):
            for cap in (100, 128, 256, 1000, 1001, 1024, 1280, 2048):
                for d in (2, 8, 30, 40):
                    for lanes in (None, 4):
                        x, mask, ls, amp, noise, n = _inputs(
                            cap, d, 1000 * cap + d, dt, dev, lanes)
                        got = kr.gram_masked(name, x, mask, ls, amp, noise)
                        want = kr.gram_masked_plain(
                            name, x.double(), mask.double(), ls.double(),
                            amp.double(), noise)
                        what = (f"gram_masked {name} {dt} cap={cap} d={d} "
                                f"lanes={lanes or 1}")
                        rtol, atol_rel = tol[dt]
                        err = (got.double() - want).abs()
                        bound = atol_rel * amp.double()[..., None, None] \
                            + rtol * want.abs()
                        if not bool((err <= bound).all()):
                            raise AssertionError(
                                f"{what}: max error {float(err.max()):.3e} "
                                "beyond tolerance")
                        if not torch.equal(got, got.transpose(-1, -2)):
                            raise AssertionError(f"{what}: not exactly "
                                                 "symmetric")
                        eye = torch.eye(cap - n, dtype=dt, device=dev)
                        if not torch.equal(got[..., n:, n:],
                                           eye.expand_as(got[..., n:, n:])) \
                                or bool(got[..., n:, :n].abs().max() != 0):
                            raise AssertionError(f"{what}: pad block is not "
                                                 "exactly the identity")
                        worst[dt] = max(worst[dt], float(err.max()))
                        n_cases += 1
    _sync()
    print(f"[phase 2] {n_cases} cases (lanes 1 and 4) agree with "
          f"gram_masked_plain (f64 on the card): max abs err f64 "
          f"{worst[torch.float64]:.3e} (rtol 1e-10, atol 1e-12*amp), f32 "
          f"{worst[torch.float32]:.3e} (rtol 2e-5, atol 2e-5*amp); exactly "
          "symmetric; pad block exactly the identity")
    return worst[torch.float64]


def phase_backward_check():
    """The backward kernel against the plain backward, per component within
    1e-10 * sum_ij |G_ij dK_ij/dtheta| (the two sum in different orders),
    and two launches bit-identical."""
    import numpy as np
    import torch

    from bobe_tpu_torch.ops import kernels as kr

    dev = torch.device("cuda")
    worst_abs, worst_rel, n_cases = 0.0, 0.0, 0
    for name in ("rbf", "matern"):
        for cap in (128, 1024, 1280, 2048):
            for d in (2, 8, 30, 40):
                for lanes in (1, 4):
                    x, mask, ls, amp, _, _ = _inputs(
                        cap, d, 7000 + cap + d, torch.float64, dev, lanes)
                    rng = np.random.default_rng(cap + 10 * d + lanes)
                    g = torch.as_tensor(rng.normal(size=(lanes, cap, cap)),
                                        device=dev)
                    got = kr.gram_masked_backward(name, x, mask, ls, amp, g)
                    again = kr.gram_masked_backward(name, x, mask, ls, amp, g)
                    want = kr.gram_masked_backward_plain(name, x, mask, ls,
                                                         amp, g)
                    scale = kr.gram_masked_backward_plain(name, x, mask, ls,
                                                          amp, g.abs())
                    what = (f"gram_masked_backward {name} cap={cap} d={d} "
                            f"lanes={lanes}")
                    for part, k, a, w, sc in zip(("ls", "amp"), got, again,
                                                 want, scale):
                        err = (k - w).abs()
                        if not bool((err <= 1e-10 * sc).all()):
                            raise AssertionError(
                                f"{what}: d/d{part} error "
                                f"{float(err.max()):.3e} beyond 1e-10 * "
                                "sum |G dK/dtheta|")
                        if not torch.equal(k, a):
                            raise AssertionError(f"{what}: two launches "
                                                 f"differ in d/d{part}")
                        worst_abs = max(worst_abs, float(err.max()))
                        worst_rel = max(worst_rel, float((err / sc).max()))
                    n_cases += 1
    _sync()
    print(f"[phase 2b] {n_cases} backward cases agree with "
          f"gram_masked_backward_plain: max abs err {worst_abs:.3e}, max "
          f"err / sum|G dK/dtheta| {worst_rel:.3e} (tolerance 1e-10); two "
          "launches bit-identical in every case")
    return worst_abs


def _device_ms(launch, n=50, reps=5):
    """Device time of one launch: a CUDA graph of n back-to-back launches,
    replayed ``reps`` times between CUDA events; the median over n."""
    import torch

    launch()
    _sync()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            launch()
    graph.replay()
    _sync()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    times.sort()
    return times[len(times) // 2]


def _wall_ms(fn, n=50):
    """Host wall per call of ``fn``, over n calls ending on a synchronise."""
    fn()
    _sync()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    _sync()
    return (time.perf_counter() - t0) * 1e3 / n


def bound_ms(kind, cap, d, lanes, itemsize=8):
    """The least time for the work: each input read once and each output
    written once at the HBM rate, or the f64 (f32) operations on the
    cap (cap + 1) / 2 distinct entries at the FP64 (FP32) peak, whichever is
    larger. Returns (ms, "bytes" or "operations")."""
    per_dim, fixed = FWD_OPS if kind == "forward" else BWD_OPS
    inputs = cap * d + cap + lanes * (d + 1)
    # forward: writes K; backward: reads G, writes the gradients
    big = lanes * cap * cap
    nbytes = itemsize * (inputs + big + (lanes * (d + 1) if kind ==
                                         "backward" else 0))
    ops = lanes * cap * (cap + 1) / 2 * (per_dim * d + fixed)
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_FLOPS[itemsize] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernel_time():
    """Device time of both kernels at the main path's shapes, beside the
    wrapper's wall, the plain versions and the bound."""
    import numpy as np
    import torch

    from bobe_tpu_torch.ops import kernels as kr

    dev = torch.device("cuda")
    out = {}
    for cap, d in ((128, 8), (1024, 8), (1280, 8), (2048, 8), (1280, 30)):
        for lanes in (1, 4):
            x, mask, ls, amp, noise, _ = _inputs(cap, d, cap + lanes,
                                                 torch.float64, dev, lanes)
            g = torch.as_tensor(np.random.default_rng(cap).normal(
                size=(lanes, cap, cap)), device=dev)
            k_out = torch.empty((lanes, cap, cap), dtype=torch.float64,
                                device=dev)
            scratch = torch.empty(kr.backward_scratch_size(cap, d, lanes),
                                  dtype=torch.float64, device=dev)
            g_ls = torch.empty((lanes, d), dtype=torch.float64, device=dev)
            g_amp = torch.empty((lanes,), dtype=torch.float64, device=dev)
            runs = {
                "forward": (
                    lambda: kr.launch_forward("rbf", x, mask, ls, amp, noise,
                                              k_out),
                    lambda: kr.gram_masked("rbf", x, mask, ls, amp, noise),
                    lambda: kr.gram_masked_plain("rbf", x, mask, ls, amp,
                                                 noise)),
                "backward": (
                    lambda: kr.launch_backward("rbf", x, mask, ls, amp, g,
                                               scratch, g_ls, g_amp),
                    lambda: kr.gram_masked_backward("rbf", x, mask, ls, amp,
                                                    g),
                    lambda: kr.gram_masked_backward_plain("rbf", x, mask, ls,
                                                          amp, g)),
            }
            for kind, (launch, wrapper, plain) in runs.items():
                t_p0 = _median_ms(plain)
                t_dev = _device_ms(launch)
                t_wall = _wall_ms(wrapper)
                t_p1 = _median_ms(plain)
                t_bound, by = bound_ms(kind, cap, d, lanes)
                row = {"ms": t_dev, "wrapper_ms": t_wall,
                       "plain_ms": min(t_p0, t_p1), "bound_ms": t_bound,
                       "bound_by": by}
                out[(kind, cap, d, lanes)] = row
                print(f"[phase 3] {kind} rbf f64 cap={cap} d={d} "
                      f"lanes={lanes}: device {t_dev:.4f} ms, wrapper wall "
                      f"{t_wall:.4f} ms/call, plain {row['plain_ms']:.4f} ms "
                      f"(before/after {t_p0:.4f}/{t_p1:.4f}), bound "
                      f"{t_bound:.4f} ms ({by}), device/bound "
                      f"{t_dev / t_bound:.1f}x")
    return out


def _state_on(gp, device_type):
    st = gp.state
    return all(t.device.type == device_type
               for t in (st.x, st.y_raw, st.chol, st.alpha, st.log_ls))


def _banana_run(device, **run_kw):
    """BOBE on the banana toy at tests/test_bo_2d.py's settings; ``run_kw``
    overrides run()'s arguments. Returns (results, wall seconds)."""
    import os

    from bobe_tpu_torch.bo import BOBE
    from bobe_tpu_torch.models import toys

    kw = dict(acq="wipstd", min_evals=16, max_evals=160, max_gp_size=200,
              logz_threshold=0.05, batch_size=4, fit_n_points=4,
              ns_n_points=8)
    kw.update(run_kw)
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        bobe = BOBE(toys.banana, param_list=toys.banana_names,
                    param_bounds=toys.banana_bounds,
                    likelihood_name="banana_smoke", n_sobol_init=8, seed=7,
                    pool="serial", device=device, save_dir=tmp,
                    verbosity="WARNING")
        res = bobe.run(**kw)
        for suffix in ("_results.pkl", ".txt", "_stats.json", "_timing.json"):
            if not os.path.exists(os.path.join(tmp, "banana_smoke" + suffix)):
                raise AssertionError(f"banana run: result file {suffix} "
                                     "missing")
    if not _state_on(res["gp"], device.split(":")[0]):
        raise AssertionError("banana run: GP state is not on the device")
    return res, time.time() - t0


def phase_slice(device, label="4", **run_kw):
    """The slice end to end on the banana toy (tests/test_bo_2d.py's
    settings): phase 4 with an NS-mode MC pool, phase 7 with run()'s own
    default pool (ensemble HMC)."""
    import numpy as np

    res, wall = _banana_run(device, **run_kw)
    logz = res["logz"]
    if not (logz and np.isfinite(logz["mean"])):
        raise AssertionError(f"phase {label}: no successful NS evidence: "
                             f"{logz}")
    if abs(logz["mean"] - BANANA_LOGZ) >= 0.3:
        raise AssertionError(f"phase {label}: logZ {logz['mean']:.4f} is not "
                             f"within 0.3 of {BANANA_LOGZ}")
    if res["termination_reason"] != "LogZ converged":
        raise AssertionError(f"phase {label}: ended with "
                             f"'{res['termination_reason']}'")
    pool = run_kw.get("mc_points_method", "EHMC (the default)")
    timing = res["results_manager"].get_timing_summary()
    print(f"[phase {label}] banana WIPStd, MC pool {pool}, on {device}: logZ "
          f"{logz['mean']:.4f} (truth {BANANA_LOGZ}), err_total "
          f"{logz['err_total']:.4f}, dlogz_sampler "
          f"{logz['dlogz_sampler']:.4f}, {res['gp'].npoints} evaluations, "
          f"termination '{res['termination_reason']}', wall {wall:.2f} s")
    print(f"[phase {label}] timing ledger (s): " + json.dumps(
        {k: round(v, 3) for k, v in timing["phase_times"].items()}))
    return {"logz": logz["mean"], "err_total": logz["err_total"],
            "n_evals": res["gp"].npoints, "wall_s": wall,
            "ledger": timing["phase_times"]}


def _bench_data():
    """bench.py's N=1024, d=8 cell: seed-0 Gaussian data, the MC points and
    the extra restart rows of the fit."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    x = rng.uniform(size=(N_TRAIN, NDIM))
    y = -0.5 * np.sum(((x - 0.5) / 0.2) ** 2, axis=1)
    y += 0.01 * rng.normal(size=N_TRAIN)
    rng.uniform(size=(64, NDIM))  # bench.py's MC points (unused here)
    x0_extra = rng.uniform(np.log(0.05), np.log(3.0),
                           size=(N_RESTARTS - 1, NDIM + 1))
    return x, y, x0_extra


def build_gp_1024(device, log_params=None):
    """A GP on bench.py's N=1024, d=8 data, with its initial hyperparameters
    or with the given log-hyperparameters (lengthscales, then amplitude)."""
    import numpy as np

    from bobe_tpu_torch.models.gp import GP

    x, y, _ = _bench_data()
    if log_params is None:
        return GP(train_x=x, train_y=y, noise=1e-8, device=device)
    lp = np.asarray(log_params)
    return GP(train_x=x, train_y=y, noise=1e-8, device=device,
              lengthscales=np.exp(lp[:NDIM]),
              kernel_variance=float(np.exp(lp[NDIM])))


def fit_x0(gp):
    """bench.py's restart seeds: the GP's initial log-hyperparameters, then
    the extra random rows."""
    import numpy as np

    return np.vstack([np.log(gp.get_hyperparams().cpu().numpy())[None, :],
                      _bench_data()[2]])


def run_ns_1024(gp, device):
    """Phase 5d's workload: one seeded convergence-mode nested sampling."""
    import numpy as np
    import torch

    from bobe_tpu_torch.samplers import nested_sampling

    return nested_sampling(
        gp, mode="convergence", rng=np.random.default_rng(1),
        generator=torch.Generator(device=device).manual_seed(1))


def _timed(fn, device):
    import torch

    if device.startswith("cuda"):
        torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    if device.startswith("cuda"):
        torch.cuda.synchronize()
    return out, time.time() - t0


def phase_real_size(device):
    """The slice's operations at N=1024, d=8."""
    import numpy as np

    from bobe_tpu_torch.acquisition import WIPStd, get_mc_samples
    from bobe_tpu_torch.utils.seed import set_global_seed

    set_global_seed(0)
    out = {}

    # (a) the fit from bench.py's restart seeds
    gp, t_init = _timed(lambda: build_gp_1024(device), device)
    x0 = fit_x0(gp)
    info, t_fit = _timed(lambda: gp.fit(x0=x0, maxiter=MAXITER), device)
    nmll = -info["mll"]
    if not np.isfinite(nmll):
        raise AssertionError(f"phase 5a: fit neg_mll {nmll} is not finite")
    print(f"[phase 5a] GP(N={N_TRAIN}, d={NDIM}) build {t_init:.3f} s, "
          f"fit ({N_RESTARTS} restarts, maxiter {MAXITER}) {t_fit:.3f} s: "
          f"neg_mll {nmll:.6f} (JAX package on the CPU from the same x0: "
          f"{JAX_FIT_NEG_MLL:.6f})")
    out.update(fit_s=t_fit, fit_neg_mll=nmll)

    # (b) a WIPStd batch over an NS-mode MC pool of 256 points
    mc, t_mc = _timed(lambda: get_mc_samples(gp, method="NS"), device)
    acq = WIPStd()
    (pts, vals), t_acq = _timed(lambda: acq.get_next_batch(
        gp, n_batch=4, acq_kwargs={"mc_samples": mc, "mc_points_size": 256}),
        device)
    if pts.shape != (4, NDIM) or not np.all(np.isfinite(vals)):
        raise AssertionError(f"phase 5b: bad batch {pts.shape} {vals}")
    print(f"[phase 5b] NS-mode MC pool ({len(mc['x'])} samples) "
          f"{t_mc:.3f} s; WIPStd.get_next_batch(n_batch=4, 256 MC points) "
          f"{t_acq:.3f} s; values {np.array2string(vals, precision=4)}")
    out.update(mc_pool_s=t_mc, wip_batch_s=t_acq)

    # (c, d) convergence NS on a GP with the JAX package's fitted
    # hyperparameters
    ns_gp = build_gp_1024(device, JAX_LOG_PARAMS)
    (samples, logz, ok), t_ns = _timed(lambda: run_ns_1024(ns_gp, device),
                                       device)
    if not ok:
        raise AssertionError("phase 5d: NS did not succeed")
    s_port = logz["dlogz_sampler"]
    tol = 3.0 * math.sqrt(JAX_DLOGZ_SAMPLER ** 2 + s_port ** 2) + 0.02
    diff = logz["mean"] - JAX_LOGZ
    print(f"[phase 5d] convergence NS {t_ns:.3f} s ({samples['n_iter']} "
          f"outer / {samples['n_inner']} inner iterations): logZ "
          f"{logz['mean']:.4f} +- {s_port:.4f} (sampler); JAX package "
          f"{JAX_LOGZ:.4f} +- {JAX_DLOGZ_SAMPLER:.4f}; difference "
          f"{diff:+.4f}, tolerance {tol:.4f}; analytic {ANALYTIC_LOGZ_N1024}")
    if abs(diff) >= tol:
        raise AssertionError(f"phase 5d: logZ differs from the JAX package "
                             f"by {diff:+.4f} (tolerance {tol:.4f})")
    out.update(ns_s=t_ns, ns_logz=logz["mean"], ns_dlogz_sampler=s_port,
               ns_outer=samples["n_iter"], ns_inner=samples["n_inner"])
    return out


def _d30_data():
    """examples/gaussian_30d.py's target at N30 seeded uniform points with
    0.01 N(0, 1) target noise, and the extra restart rows of the fit (the
    same draws as tools/torch_port_reference.py's)."""
    import numpy as np

    from bobe_tpu_torch.models import toys

    loglike, _, _ = toys.make_gaussian(D30, sigma=SIGMA30)
    rng = np.random.default_rng(SEED30)
    x = rng.uniform(size=(N30, D30))
    y = np.array([loglike(p) for p in x]) + 0.01 * rng.normal(size=N30)
    x0_extra = rng.uniform(np.log(0.05), np.log(3.0), size=(3, D30 + 1))
    return x, y, x0_extra


def build_fit_d30(device):
    """The GP of phase 6 on its data, and the fit's four restart rows: the
    GP's initial log-hyperparameters, then the three seeded draws."""
    import numpy as np

    from bobe_tpu_torch.models.gp import GP

    x, y, x0_extra = _d30_data()
    gp = GP(train_x=x, train_y=y, noise=1e-8, device=device)
    x0 = np.vstack([np.log(gp.get_hyperparams().cpu().numpy())[None, :],
                    x0_extra])
    return gp, x0


def phase_fit_d30(device):
    """A d=30 fit above the per-dimension budget: every objective of the
    four restart lanes builds its Gram matrices in one gram_masked call and
    differentiates them through its backward."""
    import numpy as np

    from bobe_tpu_torch.models import gp as gpm

    gp, x0 = build_fit_d30(device)
    cap = gp.state.cap
    perdim = D30 * cap * cap * 8
    if perdim <= gpm.PERDIM_MAX_BYTES:
        raise AssertionError(f"phase 6: {perdim} B of per-dimension "
                             "distances is not above the fit's budget")
    info, t_fit = _timed(lambda: gp.fit(x0=x0, maxiter=MAXITER30), device)
    nmll = -info["mll"]
    rel = abs(nmll - JAX_D30_FIT_NEG_MLL) / abs(JAX_D30_FIT_NEG_MLL)
    print(f"[phase 6] GP(N={N30}, d={D30}, cap {cap}; per-dimension "
          f"distances {perdim / 2**20:.0f} MiB > budget "
          f"{gpm.PERDIM_MAX_BYTES / 2**20:.0f} MiB) fit ({len(x0)} "
          f"restarts, maxiter {MAXITER30}) {t_fit:.3f} s: neg_mll "
          f"{nmll:.6f}; JAX package on the CPU from the same x0 "
          f"{JAX_D30_FIT_NEG_MLL:.6f}; relative difference {rel:.2e} "
          f"(tolerance {D30_RTOL:g})")
    if not np.isfinite(nmll) or rel > D30_RTOL:
        raise AssertionError(f"phase 6: neg_mll {nmll} is not within "
                             f"{D30_RTOL:g} of the JAX package's")
    return {"fit_s": t_fit, "neg_mll": nmll}


def _device_launches(fn):
    """Device operations (kernels, copies, sets) that ``fn`` launches, from
    torch.profiler's CUDA activity; None where the profiler records none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        _sync()
    n = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
    return n or None


def _moments_close(name, mean, std, ref_mean, ref_std, ref_name):
    import numpy as np

    dm = float(np.max(np.abs(np.asarray(mean) - np.asarray(ref_mean))))
    ds = float(np.max(np.abs(np.asarray(std) - np.asarray(ref_std))))
    print(f"[phase 8] {name} vs {ref_name}: max |mean diff| {dm:.4f}, max "
          f"|std diff| {ds:.4f} (tolerance {POOL_ATOL})")
    if not (dm < POOL_ATOL and ds < POOL_ATOL):
        raise AssertionError(f"phase 8: {name} pool moments differ from "
                             f"{ref_name}'s beyond {POOL_ATOL}")


def phase_pools(device):
    """The MCMC MC pools at N=1024, d=8 on the GP with the JAX package's
    fitted hyperparameters: ensemble HMC cold (512 samples) and warm from
    its warm_state, NUTS (4 chains, warmup 256, 512 samples, thinning 2);
    walls, acceptance, divergences, leapfrog steps, and the device launches
    per leapfrog step."""
    import numpy as np
    import torch

    from bobe_tpu_torch import samplers
    from bobe_tpu_torch.infer import nuts
    from bobe_tpu_torch.utils.seed import set_global_seed

    set_global_seed(0)
    gp = build_gp_1024(device, JAX_LOG_PARAMS)

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    pools, out = {}, {}
    # transitions of each run: warmup plus kept samples times thinning 2
    _, kept, cold_warmup = samplers.get_ehmc_settings(NDIM, num_samples=512)
    transitions = {"ehmc_cold": cold_warmup + 2 * kept,
                   "ehmc_warm": 24 + 2 * kept, "nuts": 256 + 512}
    runs = (
        ("ehmc_cold", lambda: samplers.sample_gp_ensemble(
            gp, np_rng=np.random.default_rng(2), generator=gen(2),
            num_samples=512)),
        ("ehmc_warm", lambda: samplers.sample_gp_ensemble(
            gp, np_rng=np.random.default_rng(3), generator=gen(3),
            num_samples=512, warm_state=pools["ehmc_cold"]["warm_state"])),
        ("nuts", lambda: samplers.sample_gp_nuts(
            gp, np_rng=np.random.default_rng(4), generator=gen(4),
            num_chains=4, warmup_steps=256, num_samples=512, thinning=2)))
    for name, run in runs:
        res, wall = _timed(run, device)
        pools[name] = res
        diag = res["diagnostics"]
        x = res["x"]
        if not (x.shape[1] == NDIM and np.all(np.isfinite(x))
                and np.all((x >= 0) & (x <= 1))
                and np.all(np.isfinite(res["logp"]))):
            raise AssertionError(f"phase 8: {name} pool is not finite samples "
                                 "in the unit cube")
        n_leap = int(diag["n_leapfrog"])
        print(f"[phase 8] {name}: {len(x)} samples in {wall:.3f} s, mean "
              f"accept {np.array2string(np.asarray(diag['mean_accept']), precision=3)}, "
              f"divergences {int(np.sum(diag['n_divergent']))}, {n_leap} "
              f"lockstep leapfrog steps ({1e3 * wall / n_leap:.3f} ms each, "
              f"{n_leap / transitions[name]:.2f} per transition over "
              f"{transitions[name]}), warm path {bool(diag['warm'])}")
        out[name] = {"wall_s": wall, "n_leapfrog": n_leap,
                     "mean_accept": np.asarray(diag["mean_accept"]).tolist(),
                     "n_divergent": int(np.sum(diag["n_divergent"]))}
    if not pools["ehmc_warm"]["diagnostics"]["warm"]:
        raise AssertionError("phase 8: the warm ensemble refresh was "
                             "rejected and ran cold")
    mom = {k: (p["x"].mean(0), p["x"].std(0)) for k, p in pools.items()}
    print("[phase 8] means: " + json.dumps(
        {k: np.round(m, 4).tolist() for k, (m, _) in mom.items()}))
    print("[phase 8] stds: " + json.dumps(
        {k: np.round(sd, 4).tolist() for k, (_, sd) in mom.items()}))
    _moments_close("ehmc_cold", *mom["ehmc_cold"], *mom["nuts"], "nuts")
    _moments_close("ehmc_warm", *mom["ehmc_warm"], *mom["nuts"], "nuts")
    _moments_close("ehmc_cold", *mom["ehmc_cold"], JAX_EHMC_MEAN,
                   JAX_EHMC_STD, "the JAX package's EHMC")
    _moments_close("nuts", *mom["nuts"], JAX_NUTS_MEAN, JAX_NUTS_STD,
                   "the JAX package's NUTS")

    # device launches per lockstep leapfrog step of 64 chains: the step
    # alone, then a whole warm refresh and a few NUTS transitions
    vg = samplers._logprob_vg(gp, 1.0)
    mass = nuts._identity_mass(NDIM, True, torch.float64, device)
    z = torch.as_tensor(pools["ehmc_cold"]["warm_state"]["last_z"],
                        device=device)
    logp, grad = vg(z)
    p = torch.randn(z.shape, generator=gen(5), dtype=z.dtype, device=device)
    eps = torch.tensor(0.05, dtype=z.dtype, device=device)

    def leapfrogs(n=100):
        state = (z, p, grad)
        for _ in range(n):
            zz, pp, _, gg = nuts._leapfrog(vg, *state, eps, mass, True)
            state = (zz, pp, gg)

    per_step = _device_launches(leapfrogs)
    warm_holder = {}

    def warm_refresh():
        warm_holder["r"] = samplers.sample_gp_ensemble(
            gp, np_rng=np.random.default_rng(6), generator=gen(6),
            num_samples=512, warm_state=pools["ehmc_cold"]["warm_state"])

    refresh = _device_launches(warm_refresh)
    nuts_holder = {}

    def nuts_short():
        nuts_holder["r"] = samplers.sample_gp_nuts(
            gp, np_rng=np.random.default_rng(7), generator=gen(7),
            num_chains=4, warmup_steps=8, num_samples=8, thinning=1)

    short = _device_launches(nuts_short)
    n_warm = int(warm_holder["r"]["diagnostics"]["n_leapfrog"])
    n_nuts = int(nuts_holder["r"]["diagnostics"]["n_leapfrog"])
    fmt = lambda n, k: "not measured" if n is None else f"{n / k:.1f}"
    print(f"[phase 8] device launches per leapfrog step: the step alone "
          f"{fmt(per_step, 100)}; a warm EHMC refresh {fmt(refresh, n_warm)} "
          f"({refresh} launches / {n_warm} steps); a 16-transition NUTS run "
          f"{fmt(short, n_nuts)} ({short} launches / {n_nuts} lockstep "
          "leaves)")
    out["launches_per_leapfrog"] = {
        "step": None if per_step is None else per_step / 100,
        "ehmc_warm_refresh": None if refresh is None else refresh / n_warm,
        "nuts": None if short is None else short / n_nuts}
    return out


def phase_fallback(device):
    """A banana run that ends before any nested sampling (min_evals above
    max_evals): the final samples come from NUTS at the JAX package's
    settings (4 chains, warmup 512, every 4th transition kept) but for its
    depth, FALLBACK_SAMPLES_PER_DIM transitions per dimension where a
    user's run has bo.FINAL_NUTS's 2000; timed by the run's ledger ("MCMC
    Sampling", its last span)."""
    import numpy as np

    from bobe_tpu_torch import bo
    from bobe_tpu_torch.models import toys

    saved = bo.FINAL_NUTS["samples_per_dim"]
    bo.FINAL_NUTS["samples_per_dim"] = FALLBACK_SAMPLES_PER_DIM
    try:
        res, wall = _banana_run(device, min_evals=1000, max_evals=40)
    finally:
        bo.FINAL_NUTS["samples_per_dim"] = saved
    if res["logz"]:
        raise AssertionError("phase 9: the run reached nested sampling")
    x = res["samples"]["x"]
    n = bo.FINAL_NUTS["num_chains"] * FALLBACK_SAMPLES_PER_DIM * 2 \
        // bo.FINAL_NUTS["thinning"]
    lo, hi = toys.banana_bounds
    if not (x.shape == (n, 2) and np.all((x >= lo) & (x <= hi))
            and np.all(np.isfinite(res["samples"]["logl"]))):
        raise AssertionError(f"phase 9: fallback samples {x.shape} not "
                             "finite, in the box, or not the expected count")
    rm = res["results_manager"]
    t_nuts = rm.last_timing("MCMC Sampling")
    timing = rm.get_timing_summary()
    print(f"[phase 9] banana run ended '{res['termination_reason']}' after "
          f"{res['gp'].npoints} evaluations in {wall:.2f} s; final NUTS "
          f"samples: {len(x)} in {t_nuts:.3f} s, mean "
          f"{np.round(x.mean(0), 4).tolist()}, std "
          f"{np.round(x.std(0), 4).tolist()}")
    print("[phase 9] timing ledger (s): " + json.dumps(
        {k: round(v, 3) for k, v in timing["phase_times"].items()}))
    return {"fallback_s": t_nuts, "wall_s": wall}


def _planck_points(n_ref, n_unif, seed):
    """Seeded planck-like points in the unit cube: n_ref reference draws
    and n_unif uniform points, the failures at MINUS_INF10 (the data of
    tools/torch_port_reference.py's phase 10 at its counts)."""
    import numpy as np

    from bobe_tpu_torch.models import toys
    from bobe_tpu_torch.utils.core import scale_to_unit

    loglike, bounds, _, _ = toys.make_planck_like()
    rng = np.random.default_rng(seed)
    ref_x, ref_y = toys.planck_like_ref_draws(loglike, bounds, n_ref, rng)
    u = rng.uniform(size=(n_unif, bounds.shape[1]))
    y = []
    for p in bounds[0] + u * (bounds[1] - bounds[0]):
        try:
            y.append(loglike(p))
        except RuntimeError:
            y.append(MINUS_INF10)
    return (np.vstack([scale_to_unit(ref_x, bounds), u]),
            np.concatenate([ref_y, y]))


def _clf_threshold(d):
    from bobe_tpu_torch.utils.core import get_threshold_for_nsigma

    return max(75.0, get_threshold_for_nsigma(20, d))


def phase_planck_state(device):
    """The classifier-gated planck-like state: the SVM, the gated live
    seeding, a dynamic NS beside a static one, a cold gated EHMC pool."""
    import numpy as np
    import torch

    from bobe_tpu_torch import samplers
    from bobe_tpu_torch.models import classifiers
    from bobe_tpu_torch.models.clf_gp import GPwithClassifier
    from bobe_tpu_torch.models.gp import GP
    from bobe_tpu_torch.utils.seed import set_global_seed

    set_global_seed(0)
    out = {}
    gen = lambda seed: torch.Generator(device=device).manual_seed(seed)
    x, y = _planck_points(N_REF10, N_UNIF10, SEED10)
    thr = _clf_threshold(x.shape[1])
    lp = np.asarray(JAX_PLANCK["planck_log_params"])
    gp, t_build = _timed(lambda: GPwithClassifier(
        train_x=x, train_y=y, clf_type="svm", minus_inf=MINUS_INF10,
        clf_threshold=thr, gp_threshold=2 * thr, probability_threshold=0.5,
        lengthscales=np.exp(lp[:-1]), kernel_variance=float(np.exp(lp[-1])),
        device=device), device)
    labels = np.where(y < y.max() - thr, 0, 1)
    gate = gp._gate(x).cpu().numpy()
    m = gp.clf_metrics
    print(f"[phase 10a] GPwithClassifier on {len(x)} planck-like points "
          f"(GP rows {gp.gp_size}, the JAX package's "
          f"{JAX_PLANCK['planck_gp_size']}; cap {gp.state.cap}) built with "
          f"its SVM in {t_build:.3f} s: {m['n_support_vectors']} support "
          f"vectors (scikit-learn in the JAX package: "
          f"{JAX_PLANCK['planck_n_sv']}), {m['smo_iterations']} SMO "
          f"iterations, KKT violation {m['kkt_violation']:.2e} (tol 1e-3); "
          f"the gate on {device} reproduces the labels of "
          f"{np.mean(gate == labels):.4f} of the training points")
    if not (gp._clf_ctx is not None and np.all(gate == labels)
            and gp.gp_size == JAX_PLANCK["planck_gp_size"]
            and m["kkt_violation"] < 1e-3):
        raise AssertionError("phase 10a: the SVM does not separate its "
                             "training labels, or the GP subset differs")
    out["svm_s_by_n"] = {}
    for n in (100, 250, 500):
        xs, ys = _planck_points(n // 2, n - n // 2, 100 + n)
        lab = np.where(ys < ys.max() - thr, 0, 1)
        (params, met, pred), t = _timed(
            lambda: classifiers.train_svm_classifier(xs, lab, device=device),
            device)
        ok = np.mean(pred(torch.as_tensor(xs, device=device)).cpu().numpy()
                     == lab)
        print(f"[phase 10a] SVM training at n={n}: {t:.3f} s, "
              f"{met['smo_iterations']} SMO iterations, "
              f"{met['n_support_vectors']} support vectors, training labels "
              f"reproduced {ok:.4f}")
        out["svm_s_by_n"][n] = t

    # (b) the feasible fraction of the gated live seeding
    apply, ctx = samplers._gp_loglike(gp)
    (_, live_l, lv0, var0), t_seed = _timed(
        lambda: samplers._seed_live_points(
            gp, lambda q: apply(ctx, q), 500, x.shape[1],
            np.random.default_rng(1)), device)
    f_ref, var_ref = JAX_PLANCK["planck_f_hat"], JAX_PLANCK["planck_var_logvol0"]
    dlog = lv0 - math.log(f_ref)
    tol = 3.0 * math.sqrt(var0 + var_ref)
    print(f"[phase 10b] gated live seeding {t_seed:.3f} s: f_hat "
          f"{math.exp(lv0):.5f} (JAX package {f_ref:.5f}); log difference "
          f"{dlog:+.4f}, 3 binomial sigma {tol:.4f}")
    if abs(dlog) >= tol or not np.all(live_l > MINUS_INF10):
        raise AssertionError("phase 10b: f_hat outside the binomial error "
                             "of the JAX package's, or a live point on the "
                             "plateau")
    out.update(f_hat=math.exp(lv0), seed_s=t_seed)

    # (c) dynamic NS against the JAX package's, timed beside a static NS
    (ds, dz, dok), t_dyn = _timed(lambda: samplers.nested_sampling(
        gp, mode="convergence", dynamic=True, rng=np.random.default_rng(2),
        generator=gen(2)), device)
    (ss, sz, sok), t_sta = _timed(lambda: samplers.nested_sampling(
        gp, mode="convergence", rng=np.random.default_rng(2),
        generator=gen(2)), device)
    if not (dok and sok):
        raise AssertionError("phase 10c: a nested sampling run failed")
    s_jax = JAX_PLANCK["planck_dyn_dlogz_sampler"]
    tol = 3.0 * math.sqrt(s_jax ** 2 + dz["dlogz_sampler"] ** 2) + 0.02
    diff = dz["mean"] - JAX_PLANCK["planck_dyn_logz"]
    for name, smp, z, t in (("dynamic", ds, dz, t_dyn),
                            ("static", ss, sz, t_sta)):
        print(f"[phase 10c] {name} convergence NS {t:.3f} s, "
              f"{smp['n_calls']} surrogate calls, {smp['n_iter']} outer / "
              f"{smp['n_inner']} inner iterations: logZ {z['mean']:.4f} +- "
              f"{z['dlogz_sampler']:.4f} (sampler)")
    print(f"[phase 10c] dynamic logZ - the JAX package's dynamic "
          f"{JAX_PLANCK['planck_dyn_logz']:.4f} +- {s_jax:.4f}: "
          f"{diff:+.4f}, tolerance {tol:.4f}")
    if abs(diff) >= tol:
        raise AssertionError(f"phase 10c: dynamic logZ differs from the JAX "
                             f"package's by {diff:+.4f} (tolerance {tol:.4f})")
    out.update(dyn_s=t_dyn, dyn_calls=ds["n_calls"], dyn_logz=dz["mean"],
               dyn_dlogz_sampler=dz["dlogz_sampler"], static_s=t_sta,
               static_calls=ss["n_calls"], static_logz=sz["mean"],
               static_dlogz_sampler=sz["dlogz_sampler"])

    # what the gate costs an NS inner iteration: a short NS (200 live
    # points, 30,000 calls) on the gated GP and on the plain GP of the same
    # rows, its wall and its device launches (torch.profiler) per iteration
    for name, g in (("gated", gp), ("plain", GP.dummy_like(gp))):
        holder = {}

        def short():
            holder["r"] = samplers.nested_sampling(
                g, mode="convergence", nlive=200, maxcall=30000,
                rng=np.random.default_rng(5), generator=gen(5),
                warn_truncation=False)

        _, t = _timed(short, device)
        n_inner = holder["r"][0]["n_inner"]
        n_launch = _device_launches(short)
        per = "not measured" if n_launch is None else \
            f"{n_launch / n_inner:.1f}"
        print(f"[phase 10c] short NS on the {name} GP: {n_inner} inner "
              f"iterations, {1e3 * t / n_inner:.3f} ms and {per} device "
              "launches per inner iteration")
        out[f"short_ns_{name}_ms_per_inner"] = 1e3 * t / n_inner

    # (d) a cold gated ensemble-HMC pool
    pool, t_pool = _timed(lambda: samplers.sample_gp_ensemble(
        gp, np_rng=np.random.default_rng(3), generator=gen(3),
        num_samples=512), device)
    px = pool["x"]
    mean, std = px.mean(0), px.std(0)
    dm = float(np.max(np.abs(mean - JAX_PLANCK["planck_ehmc_mean"])))
    dsd = float(np.max(np.abs(std - JAX_PLANCK["planck_ehmc_std"])))
    feas = float(np.mean(pool["logp"] > MINUS_INF10))
    print(f"[phase 10d] cold gated EHMC pool: {len(px)} samples in "
          f"{t_pool:.3f} s, accept "
          f"{float(pool['diagnostics']['mean_accept']):.3f}, feasible "
          f"{feas:.4f}; vs the JAX package's: max |mean diff| {dm:.4f}, max "
          f"|std diff| {dsd:.4f} (tolerance {POOL_ATOL})")
    if not (dm < POOL_ATOL and dsd < POOL_ATOL and feas > 0.95):
        raise AssertionError("phase 10d: the gated pool's moments differ "
                             "from the JAX package's, or it left the "
                             "feasible region")
    out.update(pool_s=t_pool)
    return out


def phase_planck_run(device):
    """examples/planck_like_synthetic.py's run, ended at max_evals=120 by
    min_evals above it: the final fit, dynamic NS and top-up (its merged
    runs capped at PLANCK_NS_BOOST_CAP)."""
    import os

    import numpy as np

    from bobe_tpu_torch.bo import BOBE
    from bobe_tpu_torch.models import toys

    loglike, bounds, names, logz_true = toys.make_planck_like()
    ref_x, ref_y = toys.planck_like_ref_draws(loglike, bounds, 8,
                                              np.random.default_rng(3))
    t0 = time.time()
    bobe = BOBE(loglikelihood=loglike, param_list=names, param_bounds=bounds,
                n_sobol_init=48, n_cobaya_init=0, init_train_x=ref_x,
                init_train_y=ref_y, use_clf=True, clf_type="svm", seed=3,
                save=False, verbosity="WARNING", device=device)
    svm_s = []
    train = bobe.gp.train_classifier

    def timed_training():
        t = time.perf_counter()
        train()
        svm_s.append((bobe.gp.clf_data_size, time.perf_counter() - t))

    bobe.gp.train_classifier = timed_training
    cap = os.environ.get("BOBE_TPU_NS_BOOST_CAP")
    os.environ["BOBE_TPU_NS_BOOST_CAP"] = str(PLANCK_NS_BOOST_CAP)
    try:
        res = bobe.run(**PLANCK_RUN)
    finally:
        if cap is None:
            del os.environ["BOBE_TPU_NS_BOOST_CAP"]
        else:
            os.environ["BOBE_TPU_NS_BOOST_CAP"] = cap
    wall = time.time() - t0
    gp, logz = res["gp"], res["logz"]
    x, w = res["samples"]["x"], res["samples"]["weights"]
    rm = res["results_manager"]
    ledger = rm.get_timing_summary()["phase_times"]
    print(f"[phase 11] planck-like run (d=6, use_clf svm, do_final_ns) on "
          f"{device}: ended '{res['termination_reason']}' after "
          f"{gp.clf_data_size} evaluations (GP rows {gp.gp_size}) in "
          f"{wall:.2f} s; final dynamic NS logZ {logz.get('mean', np.nan):.4f} "
          f"(truth {logz_true:.4f}), dlogz_sampler "
          f"{logz.get('dlogz_sampler', np.nan):.4f}, err_total "
          f"{logz.get('err_total', np.nan):.4f}, {len(x)} samples; the last "
          f"Nested Sampling span {rm.last_timing('Nested Sampling'):.3f} s")
    print("[phase 11] SVM training (n, s): " + json.dumps(
        [(n, round(t, 4)) for n, t in svm_s]))
    print("[phase 11] timing ledger (s): " + json.dumps(
        {k: round(v, 3) for k, v in ledger.items()}))
    if res["termination_reason"] != "Maximum evaluations reached":
        raise AssertionError(f"phase 11: ended '{res['termination_reason']}'")
    if not (logz and np.isfinite(logz["mean"])
            and ledger.get("Nested Sampling", 0) > 0):
        raise AssertionError(f"phase 11: no final dynamic NS evidence: {logz}")
    if not (gp.clf_data_size > gp.gp_size and gp._clf_ctx is not None
            and np.min(gp.train_y_clf) <= bobe.minus_inf):
        raise AssertionError("phase 11: the classifier did not engage")
    lo, hi = bounds
    if not (np.all((x >= lo) & (x <= hi)) and np.all(w > 0)):
        raise AssertionError("phase 11: final samples outside the box or "
                             "with non-positive weights")
    return {"wall_s": wall, "logz": logz["mean"], "n_evals": gp.clf_data_size,
            "svm_s": svm_s, "ledger": ledger}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from bobe_tpu_torch.ops import kernels as kr

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")

    fwd = {"name": "gram_masked", "route": "cuda", "source": SOURCE,
           "replaces": REPLACES}
    bwd = {"name": "gram_masked_backward", "route": "cuda", "source": SOURCE,
           "replaces": REPLACES_BACKWARD}
    phase_build()
    fwd["max_abs_err"] = phase_kernel_check()
    bwd["max_abs_err"] = phase_backward_check()
    times = phase_kernel_time()
    # each kernel at its main-path shape: the N=1024 refresh, the d=30 fit
    for entry, key in ((fwd, ("forward", 1024, 8, 1)),
                       (bwd, ("backward", 1280, 30, 4))):
        entry.update(times[key], library_ms=None,
                     shape={"cap": key[1], "d": key[2], "lanes": key[3]})

    # the main path, phase by phase: counts from 0, comparison launches
    # above excluded
    counters = (kr.gram_masked, kr.gram_masked_backward)
    launches = {}
    results = {}
    for label, run in (("4", lambda: phase_slice("cuda",
                                                  mc_points_method="NS")),
                       ("5", lambda: phase_real_size("cuda")),
                       ("6", lambda: phase_fit_d30("cuda")),
                       ("7", lambda: phase_slice("cuda", label="7")),
                       ("8", lambda: phase_pools("cuda")),
                       ("9", lambda: phase_fallback("cuda")),
                       ("10", lambda: phase_planck_state("cuda")),
                       ("11", lambda: phase_planck_run("cuda"))):
        for c in counters:
            c.launches = 0
        res = results[label] = run()
        launches[label] = [c.launches for c in counters]
        print(f"[phase {label}] kernel launches: gram_masked "
              f"{launches[label][0]}, gram_masked_backward "
              f"{launches[label][1]}")
        if launches[label][0] <= 0:
            raise AssertionError(f"phase {label} did not launch the Gram "
                                 "kernel")
    if launches["6"][1] <= 0:
        raise AssertionError("phase 6 did not launch the Gram backward "
                             "kernel")
    res = results["6"]
    t_fwd = times[("forward", 1280, 30, 4)]["ms"]
    t_bwd = times[("backward", 1280, 30, 4)]["ms"]
    k_ms = launches["6"][0] * t_fwd + launches["6"][1] * t_bwd
    print(f"[phase 6] the two kernels' share of the fit: "
          f"{launches['6'][0]} x {t_fwd:.4f} ms + {launches['6'][1]} x "
          f"{t_bwd:.4f} ms (phase 3 device times at cap 1280, d=30, 4 "
          f"lanes) = {k_ms:.1f} ms of {res['fit_s'] * 1e3:.1f} ms "
          f"({100 * k_ms / (res['fit_s'] * 1e3):.2f} %)")
    ledgers = {k: {p: round(v, 3) for p, v in results[k]["ledger"].items()}
               for k in ("4", "7")}
    print("[phase 7] timing ledger beside phase 4's (s): "
          + json.dumps({"phase 4 (NS pool)": ledgers["4"],
                        "phase 7 (EHMC pool)": ledgers["7"]}))
    for i, entry in enumerate((fwd, bwd)):
        entry["launches"] = sum(v[i] for v in launches.values())
        entry["launches_by_phase"] = {k: v[i] for k, v in launches.items()}
    print(json.dumps({"kernels": [fwd, bwd]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
