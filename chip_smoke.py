#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bobe_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # every phase, one card

Phases (each prints its own lines; nothing is caught, any failure exits
non-zero):

1. build the CUDA kernels from bobe_tpu_torch/csrc/gram_masked.cu;
2. hold the Gram forward kernel against its plain PyTorch version on the
   card, over rbf/matern, float32/float64, a range of capacities (the main
   path's 128, 1024 and 1280 among them) and dimensions (d=40 stages its
   dimensions in two chunks), one and four restart lanes, each case also
   with one set of coordinates per lane (the input warp); and the warp
   fit's own shape (cap 256, d=6, 8 lanes, per-lane x), there also two
   launches bit for bit;
2b. hold the Gram backward kernel (one launch) against its plain version
   (rbf/matern, float64, four capacities, four dimensions, one and four
   lanes, a random cotangent), two of its launches against each other bit
   for bit, and its tickets back at 0 after every call; then its
   coordinate variant (dL/dx, one launch) the same way, with d in
   {1, 6, 30, 40}, shared and per-lane x, the warp fit's shape (cap 256,
   d=6, 8 lanes), 8 lanes at caps on both sides of the shape's switch from
   32- to 64-row tiles (200, 300, 320, 330), pad rows exactly 0, and its
   tickets back at 0 after every call;
3. time the kernels on the card: device time from a CUDA graph of
   back-to-back launches into preallocated outputs, the wrapper's wall per
   call, the plain versions (CUDA events, median of 25) and the bound; the
   per-lane forward and the dL/dx backward at the warp fit's shape (cap
   256, d=6, 8 lanes), at cap 384 and at d=30 (cap 1280, 4 lanes), with
   both backwards' device launches per wrapper call (torch.profiler; 1, or
   the phase fails) and tile edges;
4. run the slice end to end: BOBE on the banana toy, WIPStd acquisition with
   an NS-mode MC pool, on the card;
5. the slice's operations at N=1024, d=8 (the bench.py cell): a GP fit, a
   WIPStd batch, and a convergence-mode nested sampling run checked against
   the JAX package's logZ for the same GP state;
6. a GP fit above the per-dimension budget: examples/gaussian_30d.py's
   target at N=1200 (capacity 1280, d=30), whose every objective runs the
   forward and backward kernels, checked against the JAX package's neg_mll;
6b. the input warp on phase 6's data (d=30, cap 1280, 91 hyperparameters):
   neg_mll and its gradient over the four restart lanes through the
   per-lane forward and the dL/dx backward on the card against the plain
   versions on the CPU (rtol 1e-9, GP noise 1e-6), then a 4-restart warp
   fit (maxiter 20) that ends finite, with the two kernels' share of it;
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
   (use_clf=True, do_final_ns=True) with min_evals above max_evals=80, so
   that it ends on the final fit, the dynamic NS and its static top-up (cut
   to 3 merged runs in all, from up to 16); checked for its termination,
   that final pass, a finite logZ, an engaged classifier and final samples
   in the box, with its timing ledger;
12. the input warp on phase 10's gated planck-like state: neg_mll and its
   gradient at the JAX package's fitted warp and an 8-restart warp fit
   (every objective through the per-lane forward and the dL/dx backward),
   held to the JAX package within its own roundoff sensitivity there (that
   Gram's condition number is 1.8e14); a well-conditioned warp state at the
   same shape (GP noise 1e-6): neg_mll and its gradient over 8 lanes at
   rtol 1e-9, a fit no worse than the JAX package's + 1e-6 |f|; a WIPStd
   batch in warp space, a convergence NS and a cold EHMC pool against the
   JAX package's; then the SAAS prior at N=1024, d=8 (neg_mll at the JAX
   package's fit within its roundoff sensitivity, one fit, timed; a
   well-conditioned SAAS state at rtol 1e-9 and its fit within 1e-6 |f|)
   and the same fit with optimizer="adam" and "scipy", timed;
13. examples/rosenbrock_ei.py's LogEI run at its own settings, and an EI
   run cut to 40 evaluations: termination, best point, ledger;
14. a banana run with save=True cut at 24 evaluations (before any NS) and
   resumed from its own files to "LogZ converged" (rows and start iteration restored, no
   likelihood call on resume), a second resume that short-circuits with no
   likelihood call, and a banana run through the multiprocess pool (4
   workers that see no CUDA device), cut as the first run is, whose values
   equal the serial pool's;
15. examples/planck_lite_lcdm.py's constructor (a Cobaya info dict, 32
   Sobol and 8 Cobaya points, the SVM-gated GP, the multiprocess pool) and
   run, through a stand-in cobaya package written to a temporary directory
   (the recorded LCDM-lite surface over make_planck_like's log-likelihood),
   cut to 64 evaluations and ended on the final NS: the Cobaya draws equal
   _mp_cobaya_point's rows for the run's seeds, the log prior volume is
   applied, the values equal the serial pool's, logZ is finite;
16. a gloo group of two local processes: rank 0 on the card runs phase 4's
   banana (cut to 40 evaluations) and the stand-in's Cobaya draws through
   the distributed pool, whose values equal the serial pool's; rank 1
   (CUDA_VISIBLE_DEVICES="") serves them, sees 0 CUDA devices and exits
   cleanly after EXIT;
17. the cold start, in a fresh process from a copy of the package in a
   temporary directory: the imports, CUDA's start, the full nvcc build, the
   first GP fit and NS at N=1024, d=8 and a second of each;
18. the device server on the card (python -m bobe_tpu_torch.server
   --device cuda, warming d=2 at boot): phase 13's rosenbrock LogEI cut to
   40 evaluations from two fresh client processes in turn (BOBE_TPU_SERVER
   set: each loads no torch for the run, hides the card, and counts its
   own likelihood calls), in this process on the card and in a cold
   process without a server; the clients' best value and point equal the
   in-process run's at rtol 1e-9, and the mean at 5 points of client 1's GP
   (rebuilt on the CPU with the server's factor) the card's GP's within
   1e-9 of the largest of them;
   a run with a bad acquisition raises in the client and leaves the server
   up; shutdown is acknowledged; each process's wall split into imports
   and run, and the server's kernel launches;
19. the mesh (bobe_tpu_torch/parallel/mesh.py) on the card named twice (and
   on every card, the opt-in production mesh, when there are two or more),
   on phase 5's GP: sharded
   predict at 1,000 points (the mean at rtol 1e-12, the variance within
   1e-12 of its scale) and the WIPStd sweep over an uneven pool of 257 (rtol
   1e-8, the same best candidate) against the unsharded calls, 8 NUTS
   chains against the same chains run in the mesh's groups bit for bit and
   against the full batch's means within 5 standard errors, and no Gram
   launch added by the split.

The kernels' launch counts are set to 0 just before each of phases 4 to 16,
18 and 19 and read just after; a phase that did not launch the forward kernel, phase
6 without a backward launch, or phases 6b and 12 without a per-lane forward
and a dL/dx launch, fails. The script prints the card's name
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
# the coordinate gradient replaces the JAX package's autodiff through its
# warped Gram build (neg_mll under the input warp)
REPLACES_BACKWARD_X = "bobe_tpu/models/gp.py:386"

# NVIDIA H100 SXM peaks (data sheet): HBM3 bandwidth, FP64 and FP32 outside
# the tensor cores, FP64 on the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {8: 34e12, 4: 67e12}
PEAK_FLOPS_F64_MMA = 67e12
# f64 operations per distinct Gram entry that the function needs: 3 per
# dimension for the distance (subtract, multiply, add), ~20 for the exp and
# the scaling; the backward ~5 more for the weight on the vector units, and
# its lengthscale sums sum_ij W_ij D_ijk^2 as a product on the FP64 tensor
# cores (sum_i r_i u_ik^2 + sum_j c_j v_jk^2 - 2 sum_i u_ik (W v)_ik: one
# FMA per dimension and entry, and the row sums r as a column of ones),
# whichever implementation computes them
FWD_OPS = (3, 20)
BWD_OPS = (3, 25)
BWD_MMA_OPS = (2, 2)
# the coordinate variant: the same vector work, and on the tensor cores its
# two products W xs and W^T xs (an FMA for the row and one for the column,
# per dimension and entry) with the row and column sums of W (the ones
# column), which also give the lengthscale sums
BWD_X_OPS = BWD_OPS
BWD_X_MMA_OPS = (4, 4)
# (cap, d, lanes, per-lane x) of the input warp's fits on the main path: the
# planck-like warp fit of phase 12 (209 gated rows) and the planck-like warp
# run (up to 141 rows), 8 restart lanes
WARP_FIT_SHAPE = (256, 6, 8, True)

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
# phase 6b: the input warp on phase 6's data, a well-conditioned state (GP
# noise 1e-6) whose neg_mll and gradient on the card must match the plain
# versions' on the CPU to WARP30_RTOL; then a fit of WARP30_MAXITER
# iterations from the four restart rows
WARP30_NOISE, WARP30_RTOL, WARP30_MAXITER = 1e-6, 1e-9, 20

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
# settings, ended at max_evals (min_evals above it). Its depth is cut twice:
# at 80 evaluations (the example runs to convergence, up to 500), and at the
# final NS, whose merged-run cap (BOBE_TPU_NS_BOOST_CAP) is 3 where a user's
# run has 16, so the final pass is 2 dynamic runs (the count an unknown
# sampler noise gives) and a 1-run static top-up merged with them (each NS
# on the gated GP takes ~30-45 s of the card's launch-bound loop)
PLANCK_NS_BOOST_CAP = 3
PLANCK_RUN = dict(acq="wipstd", min_evals=1000, max_evals=80,
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


def _inputs(cap, d, seed, dtype, device, lanes=None, per_lane=False):
    """x, mask (pad rows past 0.7 cap), lengthscales and amplitude: one set
    ((d,), ()) or ``lanes`` restart lanes ((lanes, d), (lanes,)); with
    ``per_lane`` x holds one set of coordinates per lane (lanes, cap, d).
    Above d=8 the lengthscales grow as sqrt(d / 8), so that many
    correlations stay well above roundoff and a fault in any dimension
    shows."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    xshape = (lanes, cap, d) if per_lane else (cap, d)
    x = torch.as_tensor(rng.uniform(size=xshape), device=device)
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
    lane_x = 0
    grid = [(cap, d, lanes, per_lane)
            for cap in (100, 128, 256, 1000, 1001, 1024, 1280, 2048)
            for d in (2, 8, 30, 40)
            for lanes, per_lane in ((None, False), (4, False), (1, True),
                                    (4, True))]
    for name in ("rbf", "matern"):
        for dt in (torch.float64, torch.float32):
            for cap, d, lanes, per_lane in grid + [WARP_FIT_SHAPE]:
                x, mask, ls, amp, noise, n = _inputs(
                    cap, d, 1000 * cap + d, dt, dev, lanes, per_lane)
                got = kr.gram_masked(name, x, mask, ls, amp, noise)
                want = kr.gram_masked_plain(
                    name, x.double(), mask.double(), ls.double(),
                    amp.double(), noise)
                what = (f"gram_masked {name} {dt} cap={cap} d={d} "
                        f"lanes={lanes or 1} per-lane x={per_lane}")
                lane_x += per_lane
                rtol, atol_rel = tol[dt]
                err = (got.double() - want).abs()
                bound = atol_rel * amp.double()[..., None, None] \
                    + rtol * want.abs()
                if not bool((err <= bound).all()):
                    raise AssertionError(
                        f"{what}: max error {float(err.max()):.3e} beyond "
                        "tolerance")
                if not torch.equal(got, got.transpose(-1, -2)):
                    raise AssertionError(f"{what}: not exactly symmetric")
                eye = torch.eye(cap - n, dtype=dt, device=dev)
                if not torch.equal(got[..., n:, n:],
                                   eye.expand_as(got[..., n:, n:])) \
                        or bool(got[..., n:, :n].abs().max() != 0):
                    raise AssertionError(f"{what}: pad block is not exactly "
                                         "the identity")
                if (cap, d, lanes, per_lane) == WARP_FIT_SHAPE and not \
                        torch.equal(got, kr.gram_masked(name, x, mask, ls,
                                                        amp, noise)):
                    raise AssertionError(f"{what}: two launches differ")
                worst[dt] = max(worst[dt], float(err.max()))
                n_cases += 1
    _sync()
    print(f"[phase 2] {n_cases} cases (lanes 1, 4 and 8; {lane_x} of them "
          f"with per-lane x, the warp fit's shape {WARP_FIT_SHAPE[:3]} "
          f"among them) agree with "
          f"gram_masked_plain (f64 on the card): max abs err f64 "
          f"{worst[torch.float64]:.3e} (rtol 1e-10, atol 1e-12*amp), f32 "
          f"{worst[torch.float32]:.3e} (rtol 2e-5, atol 2e-5*amp); exactly "
          "symmetric; pad block exactly the identity; two launches at the "
          "warp fit's shape bit-identical")
    return worst[torch.float64]


def phase_backward_check():
    """The backward kernel against the plain backward, per component within
    1e-10 * sum_ij |G_ij dK_ij/dtheta| (the two sum in different orders),
    two launches bit-identical, and its tickets back at 0 after every
    call."""
    import numpy as np
    import torch

    from bobe_tpu_torch.ops import kernels as kr

    dev = torch.device("cuda")
    worst_abs, worst_rel, n_cases = 0.0, 0.0, 0
    tiles = set()
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
                    _tickets_zero(x, f"gram_masked_backward {name} cap={cap}")
                    again = kr.gram_masked_backward(name, x, mask, ls, amp, g)
                    _tickets_zero(x, f"gram_masked_backward {name} cap={cap}")
                    tiles.add(kr.backward_tile(cap, d, lanes))
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
    print(f"[phase 2b] {n_cases} backward cases (tile edges "
          f"{sorted(tiles)}) agree with "
          f"gram_masked_backward_plain: max abs err {worst_abs:.3e}, max "
          f"err / sum|G dK/dtheta| {worst_rel:.3e} (tolerance 1e-10); two "
          "launches bit-identical in every case; tickets 0 after every call")
    return worst_abs


def _tickets_zero(x, what):
    """Fail unless every ticket of the current stream's buffer is 0."""
    import torch

    from bobe_tpu_torch.ops import kernels as kr

    tickets = kr.ticket_buffer(torch.cuda.current_stream(x.device), 0)
    if bool((tickets != 0).any()):
        raise AssertionError(f"{what}: tickets not reset")


def _dx_scale(name, x, mask, ls, amp, g):
    """sum_j |W_ij| |x_ik - x_jk| / l_k^2 with W of |G|: the size of the
    terms that dL/dx_ik sums (x (lanes, cap, d) or (cap, d))."""
    import torch

    from bobe_tpu_torch.ops import kernels as kr

    X = x if x.dim() == 3 else x.expand(ls.shape[0], *x.shape)
    xs = X / ls[:, None, :]
    dsq = kr.sq_dist(xs, xs)
    if name == "rbf":
        dcorr = torch.exp(-0.5 * dsq)
    else:
        r = torch.sqrt(torch.clamp(dsq, min=1e-30))
        dcorr = (5.0 / 3.0) * (1.0 + kr.SQRT5 * r) * torch.exp(-kr.SQRT5 * r)
    ga = g.abs()
    W = (ga + ga.transpose(-1, -2)) * (mask[:, None] * mask[None, :]) \
        * amp[:, None, None] * dcorr
    out = torch.stack([
        torch.sum(W * (X[:, :, None, k] - X[:, None, :, k]).abs(), dim=-1)
        for k in range(X.shape[-1])], dim=-1)
    return out / (ls * ls)[:, None, :]


def phase_backward_x_check():
    """The coordinate variant of the backward against the plain backward
    (rbf/matern, four capacities, d in {1, 6, 30, 40}, one and four lanes,
    shared and per-lane x, and the warp fit's shape WARP_FIT_SHAPE; a random
    cotangent that is not symmetric): dL/dx
    within 1e-10 * sum_j |W_ij (x_ik - x_jk)| / l^2, the lengthscale and
    amplitude parts within 1e-10 * sum |G dK/dtheta|, pad rows exactly 0,
    and two launches bit-identical."""
    import numpy as np
    import torch

    from bobe_tpu_torch.ops import kernels as kr

    dev = torch.device("cuda")
    worst_abs, worst_rel, n_cases = 0.0, 0.0, 0
    grid = [(cap, d, lanes, per_lane)
            for cap in (128, 384, 1280, 2048)
            for d in (1, 6, 30, 40)
            for lanes, per_lane in ((1, False), (4, False), (1, True),
                                    (4, True))]
    # 8 lanes on both sides of backward_tile's switch from 32- to 64-row
    # tiles (between caps 320 and 321 at 8 lanes), ragged caps among them
    grid += [(cap, d, 8, per_lane) for cap in (200, 300, 320, 330)
             for d in (6, 30) for per_lane in (True, False)]
    lib = kr.build_library()
    if any(kr.fold_runs(t) != lib.bobe_gram_fold_runs(t) for t in range(1, 65)):
        raise AssertionError("phase 2b: kernels.fold_runs differs from the "
                             "kernel's")
    tiles = set()
    for name in ("rbf", "matern"):
        for cap, d, lanes, per_lane in grid + [WARP_FIT_SHAPE]:
            x, mask, ls, amp, _, n = _inputs(
                cap, d, 9000 + cap + d, torch.float64, dev, lanes, per_lane)
            rng = np.random.default_rng(cap + 10 * d + lanes)
            g = torch.as_tensor(rng.normal(size=(lanes, cap, cap)),
                                device=dev)
            got = kr.gram_masked_backward_x(name, x, mask, ls, amp, g)
            again = kr.gram_masked_backward_x(name, x, mask, ls, amp, g)
            want = kr.gram_masked_backward_plain(name, x, mask, ls, amp, g,
                                                 need_x=True)
            scale = kr.gram_masked_backward_plain(name, x, mask, ls, amp,
                                                  g.abs())
            scale = scale + (_dx_scale(name, x, mask, ls, amp, g),)
            what = (f"gram_masked_backward_x {name} cap={cap} d={d} "
                    f"lanes={lanes} per-lane x={per_lane}")
            for part, k, a, w, sc in zip(("ls", "amp", "x"), got, again,
                                         want, scale):
                err = (k - w).abs()
                if not bool((err <= 1e-10 * sc + 1e-300).all()):
                    raise AssertionError(f"{what}: d/d{part} error "
                                         f"{float(err.max()):.3e} beyond "
                                         "tolerance")
                if not torch.equal(k, a):
                    raise AssertionError(f"{what}: two launches differ in "
                                         f"d/d{part}")
                if part == "x":
                    worst_abs = max(worst_abs, float(err.max()))
                    worst_rel = max(worst_rel, float(
                        (err / sc.clamp(min=1e-300)).max()))
            if bool((got[2][:, n:] != 0).any()):
                raise AssertionError(f"{what}: pad rows of dL/dx are not "
                                     "exactly 0")
            _tickets_zero(x, what)
            tiles.add(kr.backward_tile(cap, d, lanes))
            n_cases += 1
    _sync()
    print(f"[phase 2b] {n_cases} dL/dx cases (tile edges "
          f"{sorted(tiles)}) agree with "
          f"gram_masked_backward_plain(need_x=True): max abs err "
          f"{worst_abs:.3e}, max err / sum_j|W (x_i - x_j)|/l^2 "
          f"{worst_rel:.3e} (tolerance 1e-10); pad rows exactly 0; two "
          "launches bit-identical in every case; tickets 0 after every call")
    if tiles != {32, 64}:
        raise AssertionError(f"phase 2b: the dL/dx cases ran tile edges "
                             f"{sorted(tiles)}, not both 32 and 64")
    return worst_abs


def _device_ms(launch, n=50, reps=5):
    """Device time of one launch: a CUDA graph of n back-to-back launches,
    replayed ``reps`` times between CUDA events; the median over n. The
    warm-up launch runs on the capture stream, so that whatever a launch
    allocates once (the coordinate backward's ticket buffer, one per
    stream) is allocated outside the graph."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        launch()
    _sync()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
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


def bound_ms(kind, cap, d, lanes, itemsize=8, per_lane=False):
    """The least time for the work: each input read once and each output
    written once at the HBM rate, the f64 (f32) vector operations on the
    cap (cap + 1) / 2 distinct entries at the FP64 (FP32) peak, or the
    backwards' products at the FP64 tensor-core peak, whichever is largest
    (the tensor cores run beside the vector units). ``kind``:
    forward, backward or backward_x (which also writes dL/dx). Returns (ms,
    "bytes" or "operations")."""
    per_dim, fixed = {"forward": FWD_OPS, "backward": BWD_OPS,
                      "backward_x": BWD_X_OPS}[kind]
    inputs = (lanes if per_lane else 1) * cap * d + cap + lanes * (d + 1)
    # forward: writes K; backward: reads G, writes the gradients
    big = lanes * cap * cap
    outputs = {"forward": 0, "backward": lanes * (d + 1),
               "backward_x": lanes * (d + 1) + lanes * cap * d}[kind]
    nbytes = itemsize * (inputs + big + outputs)
    entries = lanes * cap * (cap + 1) / 2
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = entries * (per_dim * d + fixed) / PEAK_FLOPS[itemsize] * 1e3
    if kind != "forward":
        mma_dim, mma_fixed = {"backward": BWD_MMA_OPS,
                              "backward_x": BWD_X_MMA_OPS}[kind]
        t_ops = max(t_ops, entries * (mma_dim * d + mma_fixed)
                    / PEAK_FLOPS_F64_MMA * 1e3)
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
            _time_shape(kr, dev, out, cap, d, lanes, per_lane=False)
    # the input warp's fit: per-lane x, the forward and the dL/dx backward,
    # at the planck-like warp fit's shape, at cap 384 and at d=30
    for cap, d, lanes, _ in (WARP_FIT_SHAPE, (384, 6, 8, True),
                             (1280, 30, 4, True)):
        _time_shape(kr, dev, out, cap, d, lanes, per_lane=True)
    return out


def _time_shape(kr, dev, out, cap, d, lanes, per_lane):
    """Phase 3's timings of one shape into ``out``: with shared x the
    forward and the backward; with per-lane x the forward and the
    coordinate backward."""
    import numpy as np
    import torch

    x, mask, ls, amp, noise, _ = _inputs(cap, d, cap + lanes,
                                         torch.float64, dev, lanes,
                                         per_lane)
    g = torch.as_tensor(np.random.default_rng(cap).normal(
        size=(lanes, cap, cap)), device=dev)
    k_out = torch.empty((lanes, cap, cap), dtype=torch.float64,
                        device=dev)
    part = torch.empty(kr.backward_scratch_sizes(
        cap, d, lanes, kr.backward_tile(cap, d, lanes))[0],
        dtype=torch.float64, device=dev)
    g_ls = torch.empty((lanes, d), dtype=torch.float64, device=dev)
    g_amp = torch.empty((lanes,), dtype=torch.float64, device=dev)
    if per_lane:
        n_part, n_dx, _ = kr.backward_scratch_sizes(
            cap, d, lanes, kr.backward_tile(cap, d, lanes), need_x=True)
        part_x = torch.empty(n_part, dtype=torch.float64, device=dev)
        dx_scratch = torch.empty(n_dx, dtype=torch.float64, device=dev)
        g_x = torch.empty((lanes, cap, d), dtype=torch.float64,
                          device=dev)
    runs = {
        "forward": (
            lambda: kr.launch_forward("rbf", x, mask, ls, amp, noise,
                                      k_out),
            lambda: kr.gram_masked("rbf", x, mask, ls, amp, noise),
            lambda: kr.gram_masked_plain("rbf", x, mask, ls, amp,
                                         noise)),
        "backward": (
            lambda: kr.launch_backward("rbf", x, mask, ls, amp, g, part,
                                       g_ls, g_amp),
            lambda: kr.gram_masked_backward("rbf", x, mask, ls, amp,
                                            g),
            lambda: kr.gram_masked_backward_plain("rbf", x, mask, ls,
                                                  amp, g)),
    }
    if per_lane:
        runs["backward_x"] = (
            lambda: kr.launch_backward("rbf", x, mask, ls, amp, g, part_x,
                                       g_ls, g_amp, dxpart=dx_scratch,
                                       grad_x=g_x),
            lambda: kr.gram_masked_backward_x("rbf", x, mask, ls, amp,
                                              g),
            lambda: kr.gram_masked_backward_plain(
                "rbf", x, mask, ls, amp, g, need_x=True))
        del runs["backward"]
    for kind, (launch, wrapper, plain) in runs.items():
        t_p0 = _median_ms(plain)
        t_dev = _device_ms(launch)
        t_wall = _wall_ms(wrapper)
        t_p1 = _median_ms(plain)
        t_bound, by = bound_ms(kind, cap, d, lanes,
                               per_lane=per_lane)
        row = {"ms": t_dev, "wrapper_ms": t_wall,
               "plain_ms": min(t_p0, t_p1), "bound_ms": t_bound,
               "bound_by": by}
        extra = ""
        if kind != "forward":
            # device launches of one wrapper call, and its tile edge
            row["launches_per_call"] = _launches_per_call(wrapper)
            row["tile"] = kr.backward_tile(cap, d, lanes)
            extra = (f", {row['launches_per_call']} launch(es) per call, "
                     f"tile {row['tile']}")
            if row["launches_per_call"] != 1:
                raise AssertionError(f"phase 3: the {kind} made "
                                     f"{row['launches_per_call']} device "
                                     "launches in one call, not 1")
        out[(kind, cap, d, lanes, per_lane)] = row
        print(f"[phase 3] {kind} rbf f64 cap={cap} d={d} "
              f"lanes={lanes} per-lane x={per_lane}: device "
              f"{t_dev:.4f} ms, wrapper wall "
              f"{t_wall:.4f} ms/call, plain {row['plain_ms']:.4f} ms "
              f"(before/after {t_p0:.4f}/{t_p1:.4f}), bound "
              f"{t_bound:.4f} ms ({by}), device/bound "
              f"{t_dev / t_bound:.1f}x{extra}")


def _state_on(gp, device_type):
    st = gp.state
    return all(t.device.type == device_type
               for t in (st.x, st.y_raw, st.chol, st.alpha, st.log_ls))


def _banana_run(device, pool="serial", **run_kw):
    """BOBE on the banana toy at tests/test_bo_2d.py's settings through
    ``pool``; ``run_kw`` overrides run()'s arguments. Returns (results, wall
    seconds)."""
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
                    pool=pool, device=device, save_dir=tmp,
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


def _warp_d30_x0(gp):
    """Phase 6b's four restart rows: the warped GP's own initial
    log-hyperparameters (identity warp), then phase 6's three seeded
    lengthscale and amplitude rows with warps drawn near the identity, as
    gp.fit draws its random restarts."""
    import numpy as np

    _, _, x0_extra = _d30_data()
    warps = np.random.default_rng(SEED30 + 1).normal(
        0.0, 0.1, size=(len(x0_extra), 2 * D30))
    return np.vstack([np.log(gp.get_hyperparams().cpu().numpy())[None],
                      np.hstack([x0_extra, warps])])


def phase_warp_d30(device):
    """The input warp at d=30 (phase 6's data, cap 1280, four restart
    lanes): neg_mll and its gradient through the per-lane forward and the
    dL/dx backward on ``device`` against the plain versions on the CPU,
    then a warp fit from the same rows."""
    import numpy as np
    import torch

    from bobe_tpu_torch.models import gp as gpm
    from bobe_tpu_torch.ops import kernels as kr

    x, y, _ = _d30_data()
    gps = {dev: gpm.GP(train_x=x, train_y=y, noise=WARP30_NOISE,
                       input_warp=True, device=dev)
           for dev in (device, "cpu")}
    gp = gps[device]
    x0 = _warp_d30_x0(gp)
    out = {}
    for dev, g in gps.items():
        tlp = torch.as_tensor(x0, device=g.device).requires_grad_(True)
        val = gpm.neg_mll(g.state, g.cfg, tlp)
        (grad,) = torch.autograd.grad(val.sum(), tlp)
        out[dev] = (val.detach().cpu().numpy(), grad.cpu().numpy())
    (v, gr), (rv, rg) = out[device], out["cpu"]
    e_v = float(np.max(np.abs(v - rv) / np.abs(rv)))
    e_g = float(np.max(np.max(np.abs(gr - rg), axis=1)
                       / np.max(np.abs(rg), axis=1)))
    print(f"[phase 6b] warped GP (N={N30}, d={D30}, cap {gp.state.cap}, "
          f"{x0.shape[1]} hyperparameters, noise {WARP30_NOISE:g}): neg_mll "
          f"over {len(x0)} restart lanes on {device} against the plain "
          f"versions on the CPU: max relative error {e_v:.2e}, gradient "
          f"{e_g:.2e} (tolerance {WARP30_RTOL:g})")
    if not (e_v <= WARP30_RTOL and e_g <= WARP30_RTOL):
        raise AssertionError("phase 6b: neg_mll or its gradient differs from "
                             f"the plain versions' beyond rtol {WARP30_RTOL:g}")
    fx, bx = kr.gram_masked.launches_lane_x, kr.gram_masked_backward_x.launches
    info, t_fit = _timed(lambda: gp.fit(x0=x0, maxiter=WARP30_MAXITER), device)
    n_fwd = kr.gram_masked.launches_lane_x - fx
    n_dx = kr.gram_masked_backward_x.launches - bx
    print(f"[phase 6b] warp fit ({len(x0)} restarts, maxiter "
          f"{WARP30_MAXITER}) {t_fit:.3f} s: neg_mll {-info['mll']:.6f} "
          f"(from {float(np.min(rv)):.6f} at the best restart row); "
          f"{n_fwd} per-lane forward and {n_dx} dL/dx backward launches")
    if not np.isfinite(info["mll"]) or -info["mll"] > float(np.min(rv)):
        raise AssertionError("phase 6b: the warp fit failed or ended above "
                             "its best starting point")
    if n_fwd <= 0 or n_dx <= 0:
        raise AssertionError("phase 6b: the warp fit launched no per-lane "
                             "forward or no dL/dx backward")
    return {"fit_s": t_fit, "neg_mll": -info["mll"], "err": e_v,
            "grad_err": e_g, "fit_fwd": n_fwd, "fit_dx": n_dx}


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


def _launches_per_call(fn, tries=3):
    """_device_launches of one call of ``fn``. torch.profiler's CUDA
    tracing now and then records no device activity at all for a call
    (None); such a profile is taken again, up to ``tries`` times, so that
    a count is read whenever the tracer works."""
    for _ in range(tries):
        n = _device_launches(fn)
        if n is not None:
            return n
    return None


def _moments_close(name, mean, std, ref_mean, ref_std, ref_name,
                   label="8"):
    import numpy as np

    dm = float(np.max(np.abs(np.asarray(mean) - np.asarray(ref_mean))))
    ds = float(np.max(np.abs(np.asarray(std) - np.asarray(ref_std))))
    print(f"[phase {label}] {name} vs {ref_name}: max |mean diff| "
          f"{dm:.4f}, max |std diff| {ds:.4f} (tolerance {POOL_ATOL})")
    if not (dm < POOL_ATOL and ds < POOL_ATOL):
        raise AssertionError(f"phase {label}: {name} pool moments differ "
                             f"from {ref_name}'s beyond {POOL_ATOL}")


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
    # rows, its wall per iteration; its device launches per iteration
    # (torch.profiler) from a third as many calls, since the profiler's
    # post-processing takes longer than the run
    for name, g in (("gated", gp), ("plain", GP.dummy_like(gp))):
        holder = {}

        def short(maxcall=30000):
            holder["r"] = samplers.nested_sampling(
                g, mode="convergence", nlive=200, maxcall=maxcall,
                rng=np.random.default_rng(5), generator=gen(5),
                warn_truncation=False)

        _, t = _timed(short, device)
        n_inner = holder["r"][0]["n_inner"]
        n_launch = _device_launches(lambda: short(10000))
        per = "not measured" if n_launch is None else \
            f"{n_launch / holder['r'][0]['n_inner']:.1f}"
        print(f"[phase 10c] short NS on the {name} GP: {n_inner} inner "
              f"iterations, {1e3 * t / n_inner:.3f} ms per inner iteration; "
              f"{per} device launches per inner iteration over the "
              f"{holder['r'][0]['n_inner']} of a 10,000-call run")
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
    """examples/planck_like_synthetic.py's run, ended at max_evals=80 by
    min_evals above it: the final fit, the dynamic NS and its static top-up
    (its merged runs capped at PLANCK_NS_BOOST_CAP)."""
    import os

    import numpy as np

    from bobe_tpu_torch import bo as bo_mod
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
    # every NS call of the run: (dynamic, merged with an earlier run, runs)
    ns_calls = []
    ns = bo_mod.nested_sampling

    def recorded_ns(*args, **kw):
        ns_calls.append((bool(kw.get("dynamic", False)),
                         kw.get("merge_with") is not None,
                         int(kw.get("n_runs", 1))))
        return ns(*args, **kw)

    bo_mod.nested_sampling = recorded_ns
    cap = os.environ.get("BOBE_TPU_NS_BOOST_CAP")
    os.environ["BOBE_TPU_NS_BOOST_CAP"] = str(PLANCK_NS_BOOST_CAP)
    try:
        res = bobe.run(**PLANCK_RUN)
    finally:
        bo_mod.nested_sampling = ns
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
    print("[phase 11] NS calls (dynamic, merged with an earlier run, runs): "
          + json.dumps(ns_calls))
    print("[phase 11] SVM training (n, s): " + json.dumps(
        [(n, round(t, 4)) for n, t in svm_s]))
    print("[phase 11] timing ledger (s): " + json.dumps(
        {k: round(v, 3) for k, v in ledger.items()}))
    if res["termination_reason"] != "Maximum evaluations reached":
        raise AssertionError(f"phase 11: ended '{res['termination_reason']}'")
    if not (logz and np.isfinite(logz["mean"])
            and ledger.get("Nested Sampling", 0) > 0):
        raise AssertionError(f"phase 11: no final dynamic NS evidence: {logz}")
    top_up = PLANCK_NS_BOOST_CAP - 2
    if ns_calls[-2:] != [(True, False, 2), (False, True, top_up)]:
        raise AssertionError("phase 11: the final pass is not 2 dynamic runs "
                             f"and a {top_up}-run static top-up merged with "
                             f"them: {ns_calls}")
    if not (gp.clf_data_size > gp.gp_size and gp._clf_ctx is not None
            and np.min(gp.train_y_clf) <= bobe.minus_inf):
        raise AssertionError("phase 11: the classifier did not engage")
    lo, hi = bounds
    if not (np.all((x >= lo) & (x <= hi)) and np.all(w > 0)):
        raise AssertionError("phase 11: final samples outside the box or "
                             "with non-positive weights")
    return {"wall_s": wall, "logz": logz["mean"], "n_evals": gp.clf_data_size,
            "svm_s": svm_s, "ledger": ledger}


# ---- phase 12: the input warp and the SAAS prior
# reference numbers of the JAX package, printed by
#     JAX_PLATFORMS=cpu python tools/torch_port_reference.py --only-warp-saas
# phase 10's planck-like points with gp_kwargs={"input_warp": True}: the
# gated GP fitted with 8 restarts (maxiter 200, numpy seed 0), neg_mll and
# its gradient at the fitted parameters, a convergence-mode static NS (numpy
# seed 2), a cold ensemble-HMC pool (512 samples); bench.py's N=1024, d=8
# data with lengthscale_prior="SAAS" fitted with 4 restarts (maxiter 30,
# numpy seed 0) (JAX 0.9.0)
JAX_WARP = {
    "warp_log_params": [
        -0.33343287410220745, 1.6092521332824028, -0.2792578790604294,
        1.6094198444225691, 1.6094368375416779, 1.6094372130721708,
        9.111336098971037, -0.03938276648448403, -0.010485989062404914,
        -0.13622625679432146, -0.030674636387490805, -0.013886315197755818,
        -0.007288536637922972, -0.04532375403460956, -0.0040354159174652605,
        -0.1264624890322521, -0.04750318581678334, -0.009965587247081442,
        -0.03268736114257609,
    ],
    "warp_gp_size": 209,
    "warp_fit_neg_mll": -662.1023981306741,
    "warp_neg_mll": -662.1023981306755,
    "warp_neg_mll_grad": [
        0.05883307711332913, -0.06918842319058496, -0.16774495976655063,
        -4.5672840090105895, -39.634010401215214, -65.0369218197331,
        0.04036934572064585, -0.007224605106810139, 0.780317857635114,
        0.07144554021744343, -0.34548152169287855, -0.013516096232432502,
        -0.8890599174704549, -0.03393442397473745, -0.4773849336717677,
        0.25747832376670676, 0.012084361239804747, 0.5787240287229577,
        -0.20333770801746254,
    ],
    "warp_logz": 9.630806425181865,
    "warp_dlogz_sampler": 0.14511254063018875,
    "warp_ehmc_mean": [
        0.49982895589470133, 0.5016566522008218, 0.5061805447021034,
        0.49817058307838363, 0.4993177439338571, 0.49918071025139,
    ],
    "warp_ehmc_std": [
        0.049167512467074265, 0.03466288433392816, 0.051940447672755706,
        0.036549970527140416, 0.03854038877093055, 0.052168477592905944,
    ],
    "saas_log_params": [
        0.7735185987493418, 0.6859316324407039, 0.7576858233086144,
        0.6488496150290021, 0.6277946333096873, 0.7478711441843019,
        0.7130266985706782, 0.6756077831509397, 5.505064951025728,
        -0.4233548068375085,
    ],
    "saas_fit_neg_mll": -1967.4759117855713,
    "saas_neg_mll": -1967.4759437290961,
}
WARP_RESTARTS, WARP_MAXITER = 8, 200
# The fitted warp and SAAS states above are ill-conditioned (the warped
# gated Gram at noise 1e-8 has condition number 1.8e14): there roundoff alone
# moves the objective far beyond rtol 1e-9. Their neg_mll, gradient and fit
# are held to the JAX package's own roundoff sensitivity at that state (the
# most its neg_mll and gradient move when the training coordinates move by
# 1e-15 relative; 4 seeded draws), carried in JAX_ROUNDOFF. The
# well-conditioned warp and SAAS states (GP noise 1e-6, a 1 %-noise target;
# WC_WARP_* and WC_SAAS_* as in the tool) are held to WARP_RTOL for neg_mll
# and each gradient component (relative to the lane's largest), and their
# fits to the JAX package's + 1e-6 |f|.
WARP_RTOL = 1e-9
WC_WARP_N, WC_WARP_D, WC_WARP_SEED, WC_WARP_LANES = 200, 6, 12, 8
WC_SAAS_N, WC_SAAS_D, WC_SAAS_SEED, WC_SAAS_LANES = 1024, 8, 14, 4
# printed by
#     JAX_PLATFORMS=cpu python tools/torch_port_reference.py --only-conditioning
JAX_ROUNDOFF = {
    "warp_roundoff_neg_mll": 0.00829293069398318,
    "warp_roundoff_grad": 0.17236391552651675,
    "saas_roundoff_neg_mll": 3.5929206660512136e-05,
    "wc_warp_neg_mll": [
        223.91122923327194, 244.46750923855285, 294.5167718134976,
        250.05081762772204, 214.39554693804723, 265.17304069397284,
        243.44156307452863, 291.72274424150936,
    ],
    "wc_warp_neg_mll_grad": [
        [
            -37.51495813590202, 4.595700325995062, -33.300550111646736,
            -28.544118782538803, -29.708290358846458, -35.77170415862452,
            29.265763774351175, -21.611052600713453, -18.10127067947058,
            -15.897082405252302, -15.312812558431586, -13.284011478405956,
            -3.926586960710036, 34.081095923423774, 55.38623655256813,
            30.013846907833873, 33.32208565582962, 26.01961981313479,
            22.031033177528045,
        ],
        [
            -14.586655397803382, 57.937192714612465, -8.056932376829005,
            13.347070607203298, 10.578706727709081, 3.5932657595759334,
            -31.195994950341717, -2.6786912193910535, -71.04101477274622,
            -15.84196796077086, -41.67931447717972, -31.950544197229796,
            -3.1766753989953234, 27.93616863239371, 170.6570330417211,
            44.88931515976317, 67.97525999350091, 47.96098624302096,
            14.304496248444874,
        ],
        [
            16.273229475817597, 208.51593961040976, 25.646622717444142,
            151.7110673931981, 41.144289315566766, 74.07673374024331,
            -109.25774052277528, 87.21967316121523, -220.17255389399062,
            8.804273044570198, -171.35372253786875, 3.369626970017015,
            22.245294255912412, -28.54188164517193, 471.5359422092697,
            9.947411326149325, 198.2033231810137, 8.981199166624945,
            -16.747923906391524,
        ],
        [
            -25.739496286960986, 67.4114702997521, -10.646241878068768,
            43.18464543222075, 1.1002147602220644, 5.599161413493582,
            -25.22779826223859, 29.015837599247146, -84.04024392459883,
            -13.753980809815083, -56.47282884920247, -10.89221755874955,
            6.155675721204937, -3.796310088683821, 201.70725091854942,
            33.710249348372585, 69.32792654253893, 27.522076568830027,
            12.725274259432949,
        ],
        [
            -46.70220475179199, 49.003892287231494, -18.70426109220363,
            -7.5030220716567415, -16.643710785777753, -20.13001624992575,
            -2.565135772453107, -9.267918322273708, -53.881526427779335,
            -18.15576379029154, -32.78552146811541, -18.251186628806735,
            -6.353258269542922, 17.81395228942545, 138.72636733573924,
            33.55358876200812, 62.89013064904967, 28.54464958594933,
            24.323563152228957,
        ],
        [
            -28.806382594896277, 107.3577595016047, -15.667746959182113,
            58.764684217847154, 6.384989518950666, 21.774546568226015,
            -47.792421913112264, 27.15092555707418, -108.0597976282815,
            -16.716047377913007, -77.36447365517625, -21.702169520302938,
            1.0709420958495315, 1.3217296950576927, 245.78208666950889,
            42.019366071785136, 108.17507187866589, 38.91802512695489,
            17.816189059976775,
        ],
        [
            -37.316004648751246, 33.85916644694617, -27.162062236330645,
            14.1762080876163, -5.43155261379991, 8.887171726195945,
            -8.884017878021679, 2.5963698573904432, -46.311130700993445,
            -15.357033438868486, -44.71203788822954, -15.207715475446594,
            -9.459553398592348, 12.404939325662767, 121.50119105026194,
            38.009346542866204, 64.51578669892889, 36.795460768259716,
            16.768423069095554,
        ],
        [
            84.8290572301733, 140.42141093740148, 81.71922636760208,
            184.73653463197388, 54.53452498545464, 104.53383681534486,
            -117.9099056080199, 71.44216927395678, -179.27732469104552,
            61.607514359922234, -106.9870351805211, 22.93969601264044,
            53.08883712126458, -19.213752093399084, 375.2334436656979,
            -40.075337252817796, 54.02266534663866, -11.086062501464806,
            -55.37855933362129,
        ],
    ],
    "wc_warp_fit_neg_mll": -155.52765937439295,
    "wc_saas_neg_mll": [
        476.162429152472, 527.5896469618481, 727.4376117816404,
        679.3623964465472,
    ],
    "wc_saas_neg_mll_grad": [
        [
            -276.57016250976335, -320.6657789794434, -298.7501028722695,
            -284.82810661484007, -262.4043310801689, -281.08761228121256,
            -256.43953141277876, -258.46135652606085, 455.37461833396924,
            -13.873908533204288,
        ],
        [
            -228.35155551091486, -324.9400156793815, -302.76624364593584,
            -271.27432144073794, -269.06433551898465, -255.33297657604493,
            -247.94094185994436, -244.2024129275516, 442.93407091566274,
            -13.782760686003158,
        ],
        [
            -261.2351635799837, -284.7734132274255, -274.363744791537,
            -258.45192981516726, -249.7795786679539, -245.38727704670654,
            -219.88387808405045, -238.07409034363098, 467.43570819380994,
            -13.96297784265937,
        ],
        [
            -222.21228368499763, -319.3644693524468, -293.32810078413615,
            -264.6408077298526, -303.5592763968646, -264.85139124196735,
            -242.73721445479234, -228.3196018583473, 453.72221697350807,
            -13.794522455006462,
        ],
    ],
    "wc_saas_fit_neg_mll": -2176.5908805126132,
}

# ---- phase 13: examples/rosenbrock_ei.py's run at its own settings, then
# acq="ei" cut to 40 evaluations
ROSEN_RUN = dict(acq="logei", max_evals=120, max_gp_size=150, ei_goal=1e-8,
                 convergence_n_iters=2, zeta_ei=0.01)
EI_RUN_EVALS = 40

# ---- phase 14: the banana run cut at BANANA_CUT evaluations with
# save=True (min_evals above the cut, so no NS, and its final NUTS samples
# cut to CUT_NUTS), resumed from its own files to "LogZ converged"; the
# multiprocess pool's banana run (four worker processes) cut the same way
BANANA_CUT = 24
CUT_NUTS = {"num_chains": 4, "warmup_steps": 128, "samples_per_dim": 64,
            "thinning": 1}
POOL_WORKERS = 4

# ---- phase 15: examples/planck_lite_lcdm.py's constructor and run through a
# stand-in cobaya package (cobaya, CAMB and the Planck data are not on the
# card's host), the run cut to max_evals=64 (from 500) and min_evals with it
# (from 100). A cut run has not converged, and without an NS it would end on
# the final NUTS fallback (2000 transitions per dimension): it ends on the
# final NS instead (do_final_ns=True, the example's default is False), whose
# unknown sampler noise gives 2 merged dynamic runs, and the merged-run cap
# COBAYA_NS_BOOST_CAP = 2 (16 by default) leaves no top-up. The stand-in's
# surface is the one recorded from cobaya for
# examples/cosmo_input/LCDM_lite.yaml.
COBAYA_SURFACE = "tests/data/cobaya_lcdm_lite_surface.json"
COBAYA_INIT = dict(likelihood_name="planck_lite_lcdm", n_sobol_init=32,
                   n_cobaya_init=8, use_clf=True, clf_type="svm", seed=10,
                   pool="multiprocess")
COBAYA_RUN = dict(acq="wipstd", min_evals=64, max_evals=64, max_gp_size=600,
                  logz_threshold=0.02, fit_n_points=8, batch_size=4,
                  ns_n_points=12, convergence_n_iters=2, do_final_ns=True)
COBAYA_NS_BOOST_CAP = 2

# ---- phase 16: a gloo group of two local processes; rank 1 sees no card.
# The group's timeout bounds a worker's wait between rounds.
DIST_TIMEOUT_S = 180
DIST_BANANA_EVALS = 40
DIST_COBAYA_DRAWS = 8

# the stand-in cobaya.model of phases 15 and 16
STAND_IN_MODEL = '''"""Stand-in for cobaya.model: the sampled parameters,
bounds and labels of a recorded cobaya surface ("stand_in" in the info
dict); the log-posterior of bobe_tpu_torch.models.toys.make_planck_like
mapped affinely from those bounds onto its own (a failed "theory code"
gives -inf); reference draws around its peak."""
import numpy as np

from bobe_tpu_torch.models.toys import make_planck_like


class _Parameterization:
    def __init__(self, surface):
        self._surface = surface

    def sampled_params(self):
        return {k: None for k in self._surface["sampled_params"]}

    def labels(self):
        return dict(self._surface["labels"])


class _Prior:
    def __init__(self, bounds):
        self._bounds = bounds

    def bounds(self, confidence_for_unbounded=1.0):
        return self._bounds.copy()  # (d, 2), as cobaya returns them


class Model:
    def __init__(self, info):
        surface = info["stand_in"]
        self.parameterization = _Parameterization(surface)
        bounds = np.asarray(surface["bounds"], dtype=float)
        self.prior = _Prior(bounds)
        self._lo, self._width = bounds[:, 0], bounds[:, 1] - bounds[:, 0]
        self._loglike, pb, _, self.logz_toy = make_planck_like(len(bounds))
        self._plo, self._pwidth = pb[0], pb[1] - pb[0]

    def logpost(self, x, make_finite=False):
        u = (np.asarray(x, dtype=float) - self._lo) / self._width
        try:
            return float(self._loglike(self._plo + u * self._pwidth))
        except RuntimeError:
            return -np.inf

    def get_valid_point(self, max_tries, ignore_fixed_ref,
                        logposterior_as_dict, random_state):
        for _ in range(max_tries):
            y = self._loglike.unwarp(random_state.standard_normal(
                len(self._lo)))
            x = self._lo + (y - self._plo) / self._pwidth * self._width
            lp = self.logpost(x)
            if np.isfinite(lp):
                return x, {"logpost": lp}
        raise RuntimeError(f"no valid point in {max_tries} tries")


def get_model(info):
    return Model(info)
'''

STAND_IN_YAML = '''"""Stand-in for cobaya.yaml."""
import yaml


def yaml_load(text):
    return yaml.safe_load(text)
'''


class CountingLikelihood:
    """A module-level wrapper of a likelihood that counts its calls (it
    pickles for the worker processes)."""

    def __init__(self, fn):
        self.fn = fn
        self.calls = 0

    def __call__(self, x):
        self.calls += 1
        return self.fn(x)


def _wc_warp_data():
    """The well-conditioned warp state's data and its lanes of
    log-hyperparameters (tools/torch_port_reference.make_data_wc_warp)."""
    import numpy as np

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


def _wc_saas_data():
    """The well-conditioned SAAS state's data and its lanes of
    log-hyperparameters (tools/torch_port_reference.make_data_wc_saas)."""
    import numpy as np

    n, d = WC_SAAS_N, WC_SAAS_D
    rng = np.random.default_rng(WC_SAAS_SEED)
    x = rng.uniform(size=(n, d))
    y = -0.5 * ((x[:, 0] - 0.4) / 0.2) ** 2 + 0.01 * rng.normal(size=n)
    rng = np.random.default_rng(WC_SAAS_SEED + 2)
    lp = np.concatenate([np.log(np.linspace(0.3, 0.6, d)), [np.log(2.0)],
                         [np.log(0.5)]])
    return x, y, lp[None] + rng.normal(0.0, 0.1, (WC_SAAS_LANES, lp.size))


def _lanes_match(label, gp, lps, ref_val, ref_grad):
    """neg_mll and its gradient over the restart lanes ``lps`` against the
    JAX package's, at WARP_RTOL (each gradient component relative to its
    lane's largest). Returns (max relative error of neg_mll, of the
    gradient)."""
    import numpy as np
    import torch

    from bobe_tpu_torch.models import gp as gpm

    tlp = torch.as_tensor(lps, device=gp.device).requires_grad_(True)
    val = gpm.neg_mll(gp.state, gp.cfg, tlp)
    (grad,) = torch.autograd.grad(val.sum(), tlp)
    val, grad = val.detach().cpu().numpy(), grad.cpu().numpy()
    rv, rg = np.asarray(ref_val), np.asarray(ref_grad)
    e_v = float(np.max(np.abs(val - rv) / np.abs(rv)))
    e_g = float(np.max(np.max(np.abs(grad - rg), axis=1)
                       / np.max(np.abs(rg), axis=1)))
    print(f"[phase {label}] neg_mll over {len(lps)} restart lanes (cap "
          f"{gp.state.cap}) against the JAX package's: max relative error "
          f"{e_v:.2e}, gradient {e_g:.2e} (tolerance {WARP_RTOL:g})")
    if e_v > WARP_RTOL or e_g > WARP_RTOL:
        raise AssertionError(f"phase {label}: neg_mll or its gradient "
                             "differs from the JAX package's beyond rtol "
                             f"{WARP_RTOL:g}")
    return e_v, e_g


def _warp_gp(device, log_params=None):
    """Phase 10's gated planck-like GP with the input warp, at its initial
    hyperparameters or at ``log_params`` (ls, amp, log a, log b)."""
    import numpy as np

    from bobe_tpu_torch.models.clf_gp import GPwithClassifier

    x, y = _planck_points(N_REF10, N_UNIF10, SEED10)
    thr = _clf_threshold(x.shape[1])
    gp = GPwithClassifier(train_x=x, train_y=y, clf_type="svm",
                          minus_inf=MINUS_INF10, clf_threshold=thr,
                          gp_threshold=2 * thr, probability_threshold=0.5,
                          input_warp=True, device=device)
    if log_params is not None:
        gp.update_hyperparams(np.asarray(log_params))
    return gp


def phase_warp_saas(device):
    """The input warp (per-lane warped coordinates through the Gram kernels
    and their dL/dx) and the SAAS prior, held to the JAX package."""
    import numpy as np
    import torch

    from bobe_tpu_torch import samplers
    from bobe_tpu_torch.acquisition import WIPStd, get_mc_samples
    from bobe_tpu_torch.models import gp as gpm
    from bobe_tpu_torch.ops import kernels as kr
    from bobe_tpu_torch.utils.seed import set_global_seed

    set_global_seed(0)
    out = {}
    gen = lambda seed: torch.Generator(device=device).manual_seed(seed)
    ref = JAX_WARP
    lp = np.asarray(ref["warp_log_params"])

    # (a) neg_mll and its gradient at the JAX package's fitted parameters,
    # an ill-conditioned state: held to the JAX package's own roundoff
    # sensitivity there
    rnd = JAX_ROUNDOFF
    gp = _warp_gp(device)
    if gp.gp_size != ref["warp_gp_size"]:
        raise AssertionError(f"phase 12a: GP rows {gp.gp_size}, the JAX "
                             f"package's {ref['warp_gp_size']}")
    tlp = torch.as_tensor(lp, device=gp.device).requires_grad_(True)
    val = gpm.neg_mll(gp.state, gp.cfg, tlp)
    (grad,) = torch.autograd.grad(val, tlp)
    val, grad = float(val.detach()), grad.cpu().numpy()
    g_ref = np.asarray(ref["warp_neg_mll_grad"])
    err = abs(val - ref["warp_neg_mll"])
    g_err = float(np.max(np.abs(grad - g_ref)))
    tol_v = max(WARP_RTOL * abs(ref["warp_neg_mll"]),
                rnd["warp_roundoff_neg_mll"])
    tol_g = max(WARP_RTOL * float(np.max(np.abs(g_ref))),
                rnd["warp_roundoff_grad"])
    print(f"[phase 12a] warped gated planck-like GP ({gp.gp_size} rows, cap "
          f"{gp.state.cap}, {lp.size} hyperparameters) on {device}: neg_mll "
          f"at the JAX package's fit {val:.10f} (JAX {ref['warp_neg_mll']:.10f}"
          f", |diff| {err:.3e}, relative {err / abs(val):.2e}; tolerance "
          f"{tol_v:.3e}, the JAX package's own roundoff sensitivity there); "
          f"gradient max |diff| {g_err:.3e} (max |grad| "
          f"{np.max(np.abs(g_ref)):.3e}, tolerance {tol_g:.3e})")
    if err > tol_v or g_err > tol_g:
        raise AssertionError("phase 12a: neg_mll or its gradient differs "
                             "from the JAX package's beyond its roundoff")
    out.update(neg_mll_abs_err=err, grad_err=g_err)

    # (b) the fit: 8 restarts from the JAX package's seeds
    nx0 = kr.gram_masked_backward_x.launches
    info, t_fit = _timed(lambda: gp.fit(n_restarts=WARP_RESTARTS,
                                        maxiter=WARP_MAXITER,
                                        rng=np.random.default_rng(0)), device)
    n_dx = kr.gram_masked_backward_x.launches - nx0
    f_port, f_jax = -info["mll"], ref["warp_fit_neg_mll"]
    tol = max(1e-6 * abs(f_jax), rnd["warp_roundoff_neg_mll"])
    print(f"[phase 12b] warp fit ({WARP_RESTARTS} restarts, maxiter "
          f"{WARP_MAXITER}) {t_fit:.3f} s: neg_mll {f_port:.6f} (JAX package "
          f"from the same restarts {f_jax:.6f}, difference "
          f"{f_port - f_jax:+.3e}, tolerance {tol:.3e}: the JAX package's "
          f"roundoff sensitivity); {n_dx} dL/dx backward launches; fitted "
          f"warp a {np.exp(gp.state.log_wa.cpu().numpy())}, b "
          f"{np.exp(gp.state.log_wb.cpu().numpy())}")
    if n_dx <= 0:
        raise AssertionError("phase 12b: the warp fit launched no dL/dx "
                             "backward")
    if not f_port <= f_jax + tol:
        raise AssertionError("phase 12b: the warp fit is worse than the JAX "
                             "package's")
    out.update(fit_s=t_fit, fit_neg_mll=f_port, dx_launches=n_dx)

    # (b2) the well-conditioned warp state at the warp fit's shape: neg_mll
    # and its gradient over 8 lanes at rtol 1e-9, and a fit
    xw, yw, wlps = _wc_warp_data()
    wg = gpm.GP(train_x=xw, train_y=yw, noise=1e-6, input_warp=True,
                device=device)
    nx0 = kr.gram_masked_backward_x.launches
    out["wc_warp_err"] = _lanes_match("12b", wg, wlps,
                                      rnd["wc_warp_neg_mll"],
                                      rnd["wc_warp_neg_mll_grad"])
    winfo, t_wfit = _timed(lambda: wg.fit(n_restarts=WARP_RESTARTS,
                                          maxiter=WARP_MAXITER,
                                          rng=np.random.default_rng(0)),
                           device)
    n_wdx = kr.gram_masked_backward_x.launches - nx0
    f_port, f_jax = -winfo["mll"], rnd["wc_warp_fit_neg_mll"]
    print(f"[phase 12b] well-conditioned warp fit (N={WC_WARP_N}, "
          f"d={WC_WARP_D}, {WARP_RESTARTS} restarts, maxiter {WARP_MAXITER}) "
          f"{t_wfit:.3f} s: neg_mll {f_port:.8f} (JAX package {f_jax:.8f}, "
          f"difference {f_port - f_jax:+.3e}, tolerance "
          f"{1e-6 * abs(f_jax):.3e}: 1e-6 |f|); {n_wdx} dL/dx backward "
          "launches with the lanes above")
    if n_wdx <= 0 or not f_port <= f_jax + 1e-6 * abs(f_jax):
        raise AssertionError("phase 12b: the well-conditioned warp fit "
                             "launched no dL/dx backward or is worse than "
                             "the JAX package's")
    out.update(wc_fit_s=t_wfit, wc_fit_neg_mll=f_port)

    # (c) a WIPStd batch in warp space over a uniform pool of 256 points
    mc = get_mc_samples(gp, method="uniform", num_samples=256,
                        np_rng=np.random.default_rng(4))
    (pts, vals), t_acq = _timed(lambda: WIPStd().get_next_batch(
        gp, n_batch=4, acq_kwargs={"mc_samples": mc, "mc_points_size": 256},
        rng=np.random.default_rng(5)), device)
    if pts.shape != (4, 6) or not np.all(np.isfinite(vals)) \
            or not np.all((pts >= 0) & (pts <= 1)):
        raise AssertionError(f"phase 12c: bad batch {pts} {vals}")
    print(f"[phase 12c] WIPStd batch of 4 in warp space {t_acq:.3f} s: "
          f"values {np.array2string(vals, precision=4)}")
    out["wip_batch_s"] = t_acq

    # (d) convergence NS on the JAX package's fitted warp state
    ns_gp = _warp_gp(device, lp)
    (smp, z, ok), t_ns = _timed(lambda: samplers.nested_sampling(
        ns_gp, mode="convergence", rng=np.random.default_rng(2),
        generator=gen(2)), device)
    s_jax = ref["warp_dlogz_sampler"]
    tol = 3.0 * math.sqrt(s_jax ** 2 + z["dlogz_sampler"] ** 2) + 0.02
    diff = z["mean"] - ref["warp_logz"]
    print(f"[phase 12d] convergence NS on the JAX package's warp state "
          f"{t_ns:.3f} s ({smp['n_calls']} surrogate calls): logZ "
          f"{z['mean']:.4f} +- {z['dlogz_sampler']:.4f}; JAX package "
          f"{ref['warp_logz']:.4f} +- {s_jax:.4f}; difference {diff:+.4f}, "
          f"tolerance {tol:.4f}")
    if not ok or abs(diff) >= tol:
        raise AssertionError("phase 12d: NS failed or logZ is outside the "
                             "tolerance of the JAX package's")
    out.update(ns_s=t_ns, ns_logz=z["mean"])

    # (e) a cold ensemble-HMC pool on the same state
    pool, t_pool = _timed(lambda: samplers.sample_gp_ensemble(
        ns_gp, num_samples=512, np_rng=np.random.default_rng(3),
        generator=gen(3)), device)
    _moments_close("warp EHMC", np.mean(pool["x"], axis=0),
                   np.std(pool["x"], axis=0), ref["warp_ehmc_mean"],
                   ref["warp_ehmc_std"], "JAX package", label="12e")
    print(f"[phase 12e] cold gated EHMC pool on the warp state "
          f"{t_pool:.3f} s")
    out["ehmc_s"] = t_pool

    # (f) SAAS at N=1024, d=8: neg_mll at the JAX package's fit (an
    # ill-conditioned state: held to the JAX package's roundoff sensitivity
    # there), one fit; then the well-conditioned SAAS state at rtol 1e-9 and
    # its fit
    x, y, _ = _bench_data()
    saas = lambda **kw: gpm.GP(train_x=x, train_y=y, noise=1e-8,
                               lengthscale_prior="SAAS", device=device, **kw)
    sg = saas()
    slp = np.asarray(ref["saas_log_params"])
    sval = float(sg.neg_mll(slp))
    serr = abs(sval - ref["saas_neg_mll"])
    stol = max(WARP_RTOL * abs(ref["saas_neg_mll"]),
               rnd["saas_roundoff_neg_mll"])
    sinfo, t_saas = _timed(lambda: sg.fit(n_restarts=N_RESTARTS,
                                          maxiter=MAXITER,
                                          rng=np.random.default_rng(0)),
                           device)
    print(f"[phase 12f] SAAS GP (N={N_TRAIN}, d={NDIM}): neg_mll at the JAX "
          f"package's fit {sval:.8f} (JAX {ref['saas_neg_mll']:.8f}, |diff| "
          f"{serr:.3e}, relative {serr / abs(sval):.2e}, tolerance "
          f"{stol:.3e}: the JAX package's roundoff sensitivity there); fit "
          f"({N_RESTARTS} restarts, maxiter {MAXITER}) {t_saas:.3f} s: "
          f"neg_mll {-sinfo['mll']:.6f} (JAX package "
          f"{ref['saas_fit_neg_mll']:.6f}), tausq {sg.tausq:.4g}")
    if serr > stol or not np.isfinite(sinfo["mll"]):
        raise AssertionError("phase 12f: SAAS neg_mll differs from the JAX "
                             "package's, or the fit failed")
    out.update(saas_fit_s=t_saas, saas_fit_neg_mll=-sinfo["mll"])
    xc, yc, clps = _wc_saas_data()
    cg = gpm.GP(train_x=xc, train_y=yc, noise=1e-6, lengthscale_prior="SAAS",
                tausq=0.5, device=device)
    out["wc_saas_err"] = _lanes_match("12f", cg, clps,
                                      rnd["wc_saas_neg_mll"],
                                      rnd["wc_saas_neg_mll_grad"])
    cinfo, t_cfit = _timed(lambda: cg.fit(n_restarts=N_RESTARTS,
                                          maxiter=MAXITER,
                                          rng=np.random.default_rng(0)),
                           device)
    f_port, f_jax = -cinfo["mll"], rnd["wc_saas_fit_neg_mll"]
    print(f"[phase 12f] well-conditioned SAAS fit (N={WC_SAAS_N}, "
          f"d={WC_SAAS_D}, {N_RESTARTS} restarts, maxiter {MAXITER}) "
          f"{t_cfit:.3f} s: neg_mll {f_port:.8f} (JAX package {f_jax:.8f}, "
          f"difference {f_port - f_jax:+.3e}, tolerance "
          f"{1e-6 * abs(f_jax):.3e}: 1e-6 |f|)")
    if not f_port <= f_jax + 1e-6 * abs(f_jax):
        raise AssertionError("phase 12f: the well-conditioned SAAS fit is "
                             "worse than the JAX package's")
    out["wc_saas_fit_s"] = t_cfit

    # (g) the same fit with optimizer="adam" and "scipy"
    for opt in ("adam", "scipy"):
        og = saas(optimizer=opt)
        oinfo, t_opt = _timed(lambda: og.fit(n_restarts=N_RESTARTS,
                                             maxiter=MAXITER,
                                             rng=np.random.default_rng(0)),
                              device)
        print(f"[phase 12g] SAAS fit with optimizer={opt!r} ({N_RESTARTS} "
              f"restarts, maxiter {MAXITER}) {t_opt:.3f} s: neg_mll "
              f"{-oinfo['mll']:.6f}")
        if not np.isfinite(oinfo["mll"]):
            raise AssertionError(f"phase 12g: the {opt} fit failed")
        out[f"{opt}_fit_s"] = t_opt
    return out


def _rosen_run(device, **run_kw):
    """BOBE on the Rosenbrock valley at examples/rosenbrock_ei.py's
    settings; returns (results, wall seconds)."""
    from bobe_tpu_torch.bo import BOBE
    from bobe_tpu_torch.models import toys

    t0 = time.time()
    bobe = BOBE(loglikelihood=toys.rosenbrock,
                param_list=toys.rosenbrock_names,
                param_bounds=toys.rosenbrock_bounds,
                likelihood_name="rosenbrock", n_sobol_init=16, seed=0,
                save=False, verbosity="WARNING", device=device)
    res = bobe.run(**run_kw)
    return res, time.time() - t0


def phase_ei(device):
    """examples/rosenbrock_ei.py's LogEI run, then an EI run cut to 40
    evaluations."""
    import numpy as np

    out = {}
    for label, kw in (("logei", ROSEN_RUN),
                      ("ei", dict(ROSEN_RUN, acq="ei",
                                  max_evals=EI_RUN_EVALS))):
        res, wall = _rosen_run(device, **kw)
        best = np.asarray(res["best_pt"])
        dist = float(np.linalg.norm(best - 1.0))
        ledger = res["results_manager"].get_timing_summary()["phase_times"]
        print(f"[phase 13] rosenbrock acq={kw['acq']!r} on {device}: ended "
              f"'{res['termination_reason']}' after {res['gp'].npoints} "
              f"evaluations in {wall:.2f} s; best point "
              f"{np.array2string(best, precision=5)} (distance to (1, 1) "
              f"{dist:.4f}), value {res['best_val']:.6f}")
        print(f"[phase 13] timing ledger (s): " + json.dumps(
            {k: round(v, 3) for k, v in ledger.items()}))
        if res["termination_reason"] not in (
                "Maximum evaluations reached", "Maximum GP size reached",
                f"{kw['acq'].upper()} goal reached") \
                or not np.all(np.isfinite(best)):
            raise AssertionError(f"phase 13: {kw['acq']} run ended "
                                 f"'{res['termination_reason']}'")
        out[label] = {"wall_s": wall, "n_evals": res["gp"].npoints,
                      "distance": dist, "ledger": ledger}
    return out


def phase_resume_pool(device):
    """A banana run with save=True cut at BANANA_CUT evaluations, resumed
    from its own files to "LogZ converged"; a second resume that
    short-circuits with no likelihood call; a banana run through the
    multiprocess pool, cut the same way, whose values equal the serial
    pool's."""
    import numpy as np

    from bobe_tpu_torch import bo
    from bobe_tpu_torch.bo import BOBE
    from bobe_tpu_torch.models import toys
    from bobe_tpu_torch.parallel.pool import MultiprocessPool, SerialPool
    from bobe_tpu_torch.utils.core import scale_from_unit

    out = {}
    run_kw = dict(acq="wipstd", min_evals=16, max_gp_size=200,
                  logz_threshold=0.05, batch_size=4, fit_n_points=4,
                  ns_n_points=8)
    with tempfile.TemporaryDirectory() as tmp:
        like = CountingLikelihood(toys.banana)
        make = lambda **kw: BOBE(like, param_list=toys.banana_names,
                                 param_bounds=toys.banana_bounds,
                                 likelihood_name="banana_resume",
                                 n_sobol_init=8, seed=7, device=device,
                                 save_dir=tmp, verbosity="WARNING", **kw)
        first = make()
        final_nuts, bo.FINAL_NUTS = bo.FINAL_NUTS, CUT_NUTS
        try:
            r1, t1 = _timed(lambda: first.run(
                max_evals=BANANA_CUT, **dict(run_kw, min_evals=1000)), device)
        finally:
            bo.FINAL_NUTS = final_nuts
        if r1["termination_reason"] != "Maximum evaluations reached":
            raise AssertionError(f"phase 14a: the first run ended "
                                 f"'{r1['termination_reason']}'")
        n1, it1 = r1["gp"].npoints, first.current_iteration
        calls = like.calls
        second = make(resume=True)
        if like.calls != calls or second.gp.npoints != n1 \
                or second.start_iteration != it1:
            raise AssertionError(
                f"phase 14a: the resume restored {second.gp.npoints} rows "
                f"from iteration {second.start_iteration} with "
                f"{like.calls - calls} calls (want {n1} rows, iteration "
                f"{it1}, 0 calls)")
        if not np.array_equal(second.gp.train_x.cpu().numpy(),
                              r1["gp"].train_x.cpu().numpy()):
            raise AssertionError("phase 14a: resumed GP rows differ")
        r2, t2 = _timed(lambda: second.run(max_evals=160, **run_kw), device)
        print(f"[phase 14a] banana save=True cut at {BANANA_CUT} evaluations "
              f"('{r1['termination_reason']}', {n1} rows, iteration {it1}) in "
              f"{t1:.2f} s; resume=True restored {n1} rows from iteration "
              f"{it1} with no likelihood call, then ran to "
              f"'{r2['termination_reason']}' at {r2['gp'].npoints} "
              f"evaluations in {t2:.2f} s: logZ {r2['logz']['mean']:.4f} "
              f"(truth {BANANA_LOGZ})")
        if r2["termination_reason"] != "LogZ converged":
            raise AssertionError("phase 14a: the resumed run did not "
                                 "converge")
        calls = like.calls
        third = make(resume=True)
        r3 = third.run(max_evals=160, **run_kw)
        print(f"[phase 14b] a second resume at logz_threshold "
              f"{run_kw['logz_threshold']}: '{r3['termination_reason']}', "
              f"{like.calls - calls} likelihood calls, logZ "
              f"{r3['logz']['mean']:.4f}")
        if r3["termination_reason"] != "Already converged in previous run" \
                or like.calls != calls:
            raise AssertionError("phase 14b: the converged resume did not "
                                 "short-circuit")
        out.update(cut_s=t1, resume_s=t2, n_evals=r2["gp"].npoints)

    pool = MultiprocessPool(n_workers=POOL_WORKERS)
    final_nuts, bo.FINAL_NUTS = bo.FINAL_NUTS, CUT_NUTS
    try:
        res, t_mp = _timed(lambda: BOBE(
            toys.banana, param_list=toys.banana_names,
            param_bounds=toys.banana_bounds, likelihood_name="banana_pool",
            n_sobol_init=8, seed=7, device=device, save=False, pool=pool,
            verbosity="WARNING").run(max_evals=BANANA_CUT,
                                     **dict(run_kw, min_evals=1000)), device)
    finally:
        bo.FINAL_NUTS = final_nuts
    gp = res["gp"]
    pts = scale_from_unit(gp.train_x.cpu().numpy(), toys.banana_bounds)
    got = gp.train_y_raw.cpu().numpy()
    want = SerialPool().run_map_objective(res["likelihood"], pts)
    view = pool.run_map_objective(_worker_cuda_view, np.zeros((8, 1)))
    pool.close()
    print(f"[phase 14c] banana with pool='multiprocess' ({POOL_WORKERS} "
          f"workers) cut at {BANANA_CUT} evaluations on {device}: "
          f"'{res['termination_reason']}' at "
          f"{gp.npoints} evaluations in {t_mp:.2f} s; every value equals the "
          f"serial pool's at the same points: "
          f"{bool(np.array_equal(got, want))}; CUDA devices the workers see: "
          f"{sorted(set(view.tolist()))}")
    if not np.array_equal(got, want) or np.any(view != 0):
        raise AssertionError("phase 14c: pool values differ from the serial "
                             "pool's, or a worker sees a CUDA device")
    out["pool_s"] = t_mp
    return out


def _worker_cuda_view(x):
    """In a pool worker: the number of CUDA devices torch sees there."""
    import torch

    return float(torch.cuda.device_count())


def _stand_in_info():
    """The info dict of the stand-in model: the recorded cobaya surface."""
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, COBAYA_SURFACE)) as f:
        surface = json.load(f)
    return {"likelihood": {"planck_like_stand_in": None},
            "stand_in": surface}


class _StandIn:
    """Writes the stand-in cobaya package into a temporary directory, puts
    that directory first on sys.path (forkserver workers start from the
    parent's sys.path) and takes it away again, with the modules."""

    def __enter__(self):
        import os

        self._tmp = tempfile.TemporaryDirectory()
        self.path = self._tmp.name
        pkg = os.path.join(self.path, "cobaya")
        os.makedirs(pkg)
        for name, text in (("__init__.py", '"""Stand-in cobaya."""\n'),
                           ("model.py", STAND_IN_MODEL),
                           ("yaml.py", STAND_IN_YAML)):
            with open(os.path.join(pkg, name), "w") as f:
                f.write(text)
        self._drop()
        sys.path.insert(0, self.path)
        return self

    def _drop(self):
        for k in [k for k in sys.modules
                  if k == "cobaya" or k.startswith("cobaya.")]:
            del sys.modules[k]

    def __exit__(self, *exc):
        sys.path.remove(self.path)
        self._drop()
        self._tmp.cleanup()


def phase_cobaya(device):
    """examples/planck_lite_lcdm.py through the stand-in cobaya: the initial
    design's Cobaya draws against _mp_cobaya_point's rows for the same
    seeds, the pool's values against the serial pool's, the log-prior-volume
    shift, and a finite logZ."""
    import os

    import numpy as np
    from scipy.stats import qmc

    from bobe_tpu_torch.bo import BOBE
    from bobe_tpu_torch.likelihood import CobayaLikelihood
    from bobe_tpu_torch.parallel.pool import SerialPool
    from bobe_tpu_torch.utils.core import scale_from_unit

    info = _stand_in_info()
    with _StandIn(), tempfile.TemporaryDirectory() as tmp:
        (bobe, t_init) = _timed(lambda: BOBE(
            loglikelihood=info, save_dir=tmp, device=device,
            verbosity="WARNING", **COBAYA_INIT), device)
        lk = bobe.loglikelihood
        if not isinstance(lk, CobayaLikelihood):
            raise AssertionError("phase 15a: the info dict did not give a "
                                 "CobayaLikelihood")
        n_workers = bobe.pool.size
        bounds = lk.param_bounds
        x0 = scale_from_unit(bobe.gp.train_x_clf.copy(), bounds)
        y0 = bobe.gp.train_y_clf.copy()
        # the run's own seeds: Sobol's scrambling draws from the run's rng,
        # then the multiprocess pool draws one seed per Cobaya point
        rng = np.random.default_rng(COBAYA_INIT["seed"])
        qmc.Sobol(d=lk.ndim, scramble=True, rng=rng).random(
            COBAYA_INIT["n_sobol_init"])
        seeds = rng.integers(0, 2**31 - 1, size=COBAYA_INIT["n_cobaya_init"])
        # _mp_cobaya_point's body, in this process
        rows = [lk._get_single_valid_point(np.random.default_rng(s))
                for s in seeds]
        found = 0
        for pt, lp in rows:
            hit = np.flatnonzero(np.all(np.isclose(x0, pt, rtol=1e-12,
                                                   atol=1e-12), axis=1))
            found += int(len(hit) == 1 and y0[hit[0]] == lp)
        surface = info["stand_in"]
        vol = float(np.sum(np.log(np.diff(np.asarray(surface["bounds"]),
                                          axis=1))))
        shift = [lk(pt) - lk.cobaya_model.logpost(pt) for pt, _ in rows]
        print(f"[phase 15a] BOBE(<info dict>, {COBAYA_INIT}) on {device}: "
              f"{len(y0)} initial rows in {t_init:.2f} s with {n_workers} "
              f"workers; Cobaya draws found in the design with "
              f"_mp_cobaya_point's values for the run's seeds: {found} of "
              f"{len(rows)}; log prior volume {lk.logprior_vol:.6f} (the "
              f"recorded bounds' {vol:.6f}), applied: "
              f"{np.allclose(shift, vol, rtol=0, atol=1e-12)}")
        if found != len(rows) or len(y0) != COBAYA_INIT["n_sobol_init"] \
                + COBAYA_INIT["n_cobaya_init"]:
            raise AssertionError("phase 15a: the Cobaya draws are not "
                                 "_mp_cobaya_point's rows for the run's "
                                 "seeds")
        if abs(lk.logprior_vol - vol) > 1e-12 \
                or not np.allclose(shift, vol, rtol=0, atol=1e-12) \
                or lk.param_list != surface["sampled_params"]:
            raise AssertionError("phase 15a: the adapter's parameters or "
                                 "log prior volume are wrong")
        cap = os.environ.get("BOBE_TPU_NS_BOOST_CAP")
        os.environ["BOBE_TPU_NS_BOOST_CAP"] = str(COBAYA_NS_BOOST_CAP)
        try:
            res, t_run = _timed(lambda: bobe.run(**COBAYA_RUN), device)
        finally:
            if cap is None:
                del os.environ["BOBE_TPU_NS_BOOST_CAP"]
            else:
                os.environ["BOBE_TPU_NS_BOOST_CAP"] = cap
        gp = res["gp"]
        pts = scale_from_unit(gp.train_x_clf, bounds)
        got = gp.train_y_clf
        want = SerialPool().run_map_objective(lk, pts)
        logz = res["logz"]
        truth = lk.cobaya_model.logz_toy + lk.logprior_vol
        timing = res["results_manager"].get_timing_summary()["phase_times"]
        print(f"[phase 15b] run({COBAYA_RUN}) in {t_run:.2f} s: "
              f"'{res['termination_reason']}' at {len(got)} evaluations "
              f"(batch size {bobe.batch_size}), logZ "
              f"{logz.get('mean', float('nan')):.4f} (the stand-in's "
              f"{truth:.4f}; the run is cut), values equal to the serial "
              f"pool's at the same points (rtol 1e-12): "
              f"{bool(np.allclose(got, want, rtol=1e-12, atol=0))}; "
              f"classifier engaged: {bool(gp.use_clf)}")
        print("[phase 15b] timing ledger (s): " + json.dumps(
            {k: round(v, 3) for k, v in timing.items()}))
        if not np.allclose(got, want, rtol=1e-12, atol=0):
            raise AssertionError("phase 15b: the pool's values differ from "
                                 "the serial pool's")
        if not (logz and np.isfinite(logz["mean"])):
            raise AssertionError(f"phase 15b: no finite logZ: {logz}")
        if len(got) < COBAYA_RUN["max_evals"]:
            raise AssertionError(f"phase 15b: ended at {len(got)} "
                                 "evaluations")
    return {"init_s": t_init, "run_s": t_run, "n_workers": n_workers,
            "n_evals": len(got), "logz": logz["mean"], "ledger": timing}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _init_group(port, rank):
    from datetime import timedelta

    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2,
                            timeout=timedelta(seconds=DIST_TIMEOUT_S))


def phase_distributed(device):
    """Rank 0 of a two-process gloo group on the card, rank 1 a local
    process that sees no card: the banana run and the stand-in's Cobaya
    draws through the distributed pool, against the serial pool."""
    import os

    import numpy as np
    import torch.distributed as dist

    from bobe_tpu_torch.likelihood import CobayaLikelihood
    from bobe_tpu_torch.parallel.pool import DistributedPool, SerialPool
    from bobe_tpu_torch.utils.core import scale_from_unit

    here = os.path.dirname(os.path.abspath(__file__))
    port = _free_port()
    with _StandIn() as stand_in:
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        env["PYTHONPATH"] = os.pathsep.join(
            [stand_in.path, here]
            + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
        worker = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dist-worker",
             str(port)], env=env, cwd=here, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        try:
            _init_group(port, 0)
            try:
                pool = DistributedPool()
                res, wall = _banana_run(device, pool=pool,
                                        mc_points_method="NS",
                                        max_evals=DIST_BANANA_EVALS)
                gp = res["gp"]
                pts = scale_from_unit(gp.train_x.cpu().numpy(),
                                      res["likelihood"].param_bounds)
                got = gp.train_y_raw.cpu().numpy()
                want = SerialPool().run_map_objective(res["likelihood"], pts)
                lk = CobayaLikelihood(_stand_in_info())
                cpool = DistributedPool()
                draws, t_draw = _timed(lambda: cpool.get_cobaya_initial_points(
                    lk, DIST_COBAYA_DRAWS), device)
                cpool.close()
            finally:
                dist.destroy_process_group()
            out, err = worker.communicate(timeout=60)
        finally:
            if worker.poll() is None:
                worker.kill()
                worker.communicate()
    serial_lp = [lk(pt) for pt, _ in draws]
    draws_ok = all(lp == s for (_, lp), s in zip(draws, serial_lp))
    marker = "DIST_WORKER_EXIT cuda_devices=0 cuda_initialized=False"
    print(f"[phase 16] gloo group of 2 (rank 0 on {device}, rank 1 with "
          f"CUDA_VISIBLE_DEVICES=''): dynamic task queue {pool._dyn}; "
          f"banana NS pool '{res['termination_reason']}' at {gp.npoints} "
          f"evaluations in {wall:.2f} s, logZ {res['logz']['mean']:.4f} "
          f"(truth {BANANA_LOGZ}); values equal to the serial pool's: "
          f"{bool(np.array_equal(got, want))}; {len(draws)} Cobaya draws "
          f"over both ranks in {t_draw:.2f} s, each value the serial "
          f"adapter's at its point: {draws_ok}; worker exit code "
          f"{worker.returncode}, '{marker}' printed: {marker in out}")
    if not pool._dyn:
        raise AssertionError("phase 16: the dynamic task queue did not come "
                             "up")
    if not np.array_equal(got, want) or not draws_ok \
            or len(draws) != DIST_COBAYA_DRAWS:
        raise AssertionError("phase 16: the distributed pool's values "
                             "differ from the serial pool's")
    if worker.returncode != 0 or marker not in out:
        raise AssertionError(f"phase 16: rank 1 did not exit cleanly "
                             f"(code {worker.returncode}):\n{out[-2000:]}"
                             f"\n{err[-3000:]}")
    return {"banana_s": wall, "n_evals": gp.npoints, "draws_s": t_draw,
            "logz": res["logz"]["mean"]}


def _dist_worker(port):
    """Rank 1 of phase 16: serves the banana run inside BOBE's constructor,
    then the Cobaya draws, and reports what it saw of CUDA."""
    import torch
    import torch.distributed as dist

    _init_group(port, 1)
    from bobe_tpu_torch.bo import BOBE
    from bobe_tpu_torch.likelihood import CobayaLikelihood
    from bobe_tpu_torch.models import toys
    from bobe_tpu_torch.parallel.pool import DistributedPool

    with tempfile.TemporaryDirectory() as tmp:
        bobe = BOBE(toys.banana, param_list=toys.banana_names,
                    param_bounds=toys.banana_bounds,
                    likelihood_name="banana_smoke", n_sobol_init=8, seed=7,
                    pool=DistributedPool(), save_dir=tmp,
                    verbosity="WARNING")
        if bobe.run() is not None:
            raise AssertionError("a worker rank's run() returned a result")
    DistributedPool().worker_loop(CobayaLikelihood(_stand_in_info()))
    print(f"DIST_WORKER_EXIT cuda_devices={torch.cuda.device_count()} "
          f"cuda_initialized={torch.cuda.is_initialized()}", flush=True)
    dist.destroy_process_group()


def phase_cold_start():
    """A fresh process from a copy of the package in a temporary directory
    (no compiled kernel library, no bytecode): the imports, CUDA's start,
    the full nvcc build, the first GP fit and NS at N=1024, d=8 and, for
    comparison, a second of each."""
    import os
    import shutil

    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copytree(os.path.join(here, "bobe_tpu_torch"),
                        os.path.join(tmp, "bobe_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(os.path.join(here, "chip_smoke.py"), tmp)
        t0 = time.time()
        out = subprocess.run([sys.executable, "chip_smoke.py", "--cold-start"],
                             cwd=tmp, capture_output=True, text=True,
                             timeout=600)
        wall = time.time() - t0
    if out.returncode != 0:
        raise AssertionError(f"phase 17: the cold-start process failed:\n"
                             f"{out.stderr[-3000:]}")
    res = json.loads(out.stdout.strip().splitlines()[-1])["cold_start"]
    res["process_wall_s"] = wall
    print("[phase 17] cold start in a fresh process (s): " + json.dumps(
        {k: round(v, 3) if isinstance(v, float) else v
         for k, v in res.items()}))
    return res


def _cold_start():
    """The body of phase 17, in the fresh process."""
    import os

    import numpy as np

    here = os.path.dirname(os.path.abspath(__file__))
    out = {}
    t0 = time.perf_counter()
    import torch
    out["import_torch_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    import bobe_tpu_torch
    out["import_bobe_tpu_torch_s"] = time.perf_counter() - t0
    from bobe_tpu_torch.ops import kernels as kr

    if not bobe_tpu_torch.__file__.startswith(here) or kr._LIBS:
        raise AssertionError("the cold start did not import the copy, or "
                             "found a library loaded")
    t0 = time.perf_counter()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    out["cuda_init_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    kr.build_library()
    out["nvcc_build_s"] = time.perf_counter() - t0
    if not kr.build_info["path"].startswith(here):
        raise AssertionError(f"the library was not built in the copy: "
                             f"{kr.build_info['path']}")
    for k in ("first", "second"):
        gp, out[f"{k}_gp_build_s"] = _timed(lambda: build_gp_1024("cuda"),
                                            "cuda")
        x0 = fit_x0(gp)
        info, out[f"{k}_fit_s"] = _timed(
            lambda: gp.fit(x0=x0, maxiter=MAXITER), "cuda")
        ns_gp = build_gp_1024("cuda", JAX_LOG_PARAMS)
        (_, logz, ok), out[f"{k}_ns_s"] = _timed(
            lambda: run_ns_1024(ns_gp, "cuda"), "cuda")
        if not (ok and np.isfinite(logz["mean"]) and np.isfinite(info["mll"])):
            raise AssertionError("the cold-start fit or NS failed")
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps({"cold_start": out}), flush=True)


# ---- phase 18: the device server on the card. Phase 13's rosenbrock LogEI
# cut to 40 evaluations, run by two fresh client processes in turn (each
# with BOBE_TPU_SERVER set, so the package loads no torch there and hides
# the card), once in this process on the card and once in a fresh process
# without a server (phase 17's cold measure); the server warms d=2 at boot
# (--prewarm-d 2 at 64 points)
SERVER_RUN = dict(ROSEN_RUN, max_evals=EI_RUN_EVALS)
# the five points where client 1's GP, rebuilt on the CPU with the server's
# factor and alphas, is held to the in-process GP on the card; client 2 holds
# the GP state as it came over the wire and never imports torch. The two
# devices round the cross-kernel row and its product with alpha apart, and
# |alpha| magnifies that: a reading on the H100 was 3.4e-6 at
# most, 8.3e-11 of the largest of the five means but 9.5e-8 of a mean 3,400
# times smaller. So the means are held within SERVER_RTOL of the largest.
SERVER_MEAN_X = [[0.1 + 0.2 * i, 0.9 - 0.2 * i] for i in range(5)]
SERVER_STATE_KEYS = ("train_x", "train_y", "lengthscales", "alphas")
SERVER_RTOL = 1e-9
# ---- phase 19: the mesh on one card named twice, on phase 5's N=1024, d=8
# GP (the JAX package's fitted hyperparameters): 1,000 query points (not a
# multiple of the mesh, so padding runs), an uneven WIPStd pool of 257
# points, 8 NUTS chains (64 warmup and 32 kept transitions of 2). The
# predicted mean is held at rtol 1e-12; the variance, amp + noise - sum V^2,
# carries an absolute roundoff of its prior scale amp * y_std^2 that depends
# on the batch's width (the solve's blocking), so it is held at 1e-12 of
# that scale; the WIPStd values divide by variances down to 3e-9 of that
# scale, which magnifies the same roundoff: they are held at rtol 1e-8
# (read: 3.3e-9 on the card, 2.0e-10 on the CPU) with the same best
# candidate. Predictions split in the mesh's chunks one after another on
# one device must equal the sharded ones bit for bit.
MESH_PREDICT_N, MESH_POOL_N, MESH_CHAINS = 1000, 257, 8
MESH_NUTS = dict(num_warmup=64, num_samples=32, thinning=2, max_depth=6)
MESH_RTOL, MESH_WIP_RTOL = 1e-12, 1e-8
# NUTS over the mesh draws what it draws unsharded, but the GP mean of half
# the chains is a product of another width, whose roundoff the trajectories
# amplify until the chains part (6.2 in logit space after 96 transitions,
# on the H100): against the full batch the two pools are held
# statistically, every dimension's means within MESH_NUTS_Z standard errors
# of their difference (from the 128 kept samples each, as if independent)
MESH_NUTS_Z = 5.0


def _rosen_counted():
    """The rosenbrock log-likelihood with a call counter."""
    from bobe_tpu_torch.models import toys

    calls = [0]

    def rosen(x):
        calls[0] += 1
        return toys.rosenbrock(x)

    return rosen, calls


def _rosen_bobe(loglikelihood, **kw):
    # the package's BOBE, as a user imports it: in a client process (with
    # BOBE_TPU_SERVER set) the client's, which loads no torch
    from bobe_tpu_torch import BOBE
    from bobe_tpu_torch.models import toys

    return BOBE(loglikelihood=loglikelihood,
                param_list=toys.rosenbrock_names,
                param_bounds=toys.rosenbrock_bounds,
                likelihood_name="rosenbrock", n_sobol_init=16, seed=0,
                save=False, verbosity="WARNING", **kw)


def _server_client(rebuild):
    """The body of a phase 18 client process (BOBE_TPU_SERVER set): phase
    18's run through the server, its wall split into imports and run, what
    the process loaded, and the GP: rebuilt on the CPU and its mean at 5
    points (``rebuild``), or its state as it came over the wire, with torch
    never imported."""
    import os

    t0 = time.perf_counter()
    import bobe_tpu_torch  # noqa: F401
    t_import = time.perf_counter() - t0
    rosen, calls = _rosen_counted()
    t1 = time.perf_counter()
    res = _rosen_bobe(rosen).run(**SERVER_RUN)
    t_run = time.perf_counter() - t1
    out = {"import_s": t_import, "run_s": t_run,
           "torch_loaded": "torch" in sys.modules,
           "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
           "calls": calls[0], "best_val": float(res["best_val"]),
           "best_pt": [float(v) for v in res["best_pt"]],
           "termination": res["termination_reason"],
           "gp_state": {k: res.gp_state[k].tolist() for k in SERVER_STATE_KEYS}}
    if rebuild:
        t2 = time.perf_counter()
        gp = res["gp"]  # rebuilt on the CPU: imports torch here
        out["gp_rebuild_s"] = time.perf_counter() - t2
        import torch

        out["gp_device"] = str(gp.device)
        out["gp_mean"] = gp.predict_mean_batched(SERVER_MEAN_X).tolist()
        out["cuda_initialized"] = torch.cuda.is_initialized()
    out["torch_at_exit"] = "torch" in sys.modules
    print(json.dumps({"server_client": out}), flush=True)


def _server_inproc(device):
    """The body of phase 18's cold process: the same run in process on
    ``device``, no server."""
    t0 = time.perf_counter()
    import torch
    import bobe_tpu_torch  # noqa: F401
    t_import = time.perf_counter() - t0
    rosen, calls = _rosen_counted()
    t1 = time.perf_counter()
    res = _rosen_bobe(rosen, device=device).run(**SERVER_RUN)
    if device.startswith("cuda"):
        torch.cuda.synchronize()
    print(json.dumps({"server_inproc": {
        "import_s": t_import, "run_s": time.perf_counter() - t1,
        "calls": calls[0], "best_val": float(res["best_val"])}}),
        flush=True)


def _child(args, env=None, timeout=600):
    """``python chip_smoke.py *args`` from this script's directory; returns
    (the JSON of its last line, its wall in seconds)."""
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.time()
    out = subprocess.run([sys.executable, "chip_smoke.py", *args], cwd=here,
                         env=env, capture_output=True, text=True,
                         timeout=timeout)
    wall = time.time() - t0
    if out.returncode != 0:
        raise AssertionError(f"chip_smoke.py {' '.join(args)} failed:\n"
                             f"{out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1]), wall


def phase_server(device):
    """The device server on the card (bobe_tpu_torch/server.py, client.py):
    boot, two client processes, the run in process and in a cold process,
    a failing run, shutdown."""
    import os

    import numpy as np

    from bobe_tpu_torch import client

    here = os.path.dirname(os.path.abspath(__file__))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        sock = os.path.join(tmp, "server.sock")
        env = dict(os.environ)
        for k in ("BOBE_TPU_SERVER", "BOBE_TPU_CLIENT_PINNED"):
            env.pop(k, None)
        env["BOBE_TPU_SERVER_ROLE"] = "server"
        log_path = os.path.join(tmp, "server.log")
        t0 = time.time()
        with open(log_path, "w") as logf:
            proc = subprocess.Popen(
                [sys.executable, "-m", "bobe_tpu_torch.server", "--device",
                 device, "--socket", sock, "--idle-timeout", "600",
                 "--prewarm-d", "2", "--prewarm-max-n", "64"],
                cwd=here, env=env, stdout=logf, stderr=subprocess.STDOUT)
        try:
            pong = None
            while pong is None:
                if proc.poll() is not None or time.time() - t0 > 300:
                    raise AssertionError(
                        "phase 18: the server did not come up:\n"
                        + open(log_path).read()[-3000:])
                time.sleep(0.2)
                pong = client.ping(sock)
            out["server_boot_s"] = time.time() - t0
            if pong.get("package") != "bobe_tpu_torch" or \
                    not pong.get("device", "").startswith(device):
                raise AssertionError(f"phase 18: unexpected pong {pong}")
            before = pong["launches"]
            cenv = dict(os.environ, BOBE_TPU_SERVER=sock)
            for k in ("BOBE_TPU_SERVER_ROLE", "CUDA_VISIBLE_DEVICES",
                      "BOBE_TPU_CLIENT_PINNED"):
                cenv.pop(k, None)
            clients = []
            for mode in ("rebuild", "state"):
                res, wall = _child(["--server-client", mode], env=cenv)
                res = res["server_client"]
                res["process_wall_s"] = wall
                clients.append(res)
            after = client.ping(sock)
            out["server_launches"] = {
                k: after["launches"][k] - before[k] for k in before}
            # the same run in this process on the card
            rosen, calls = _rosen_counted()
            t1 = time.time()
            local = _rosen_bobe(rosen, device=device).run(**SERVER_RUN)
            out["inproc_run_s"] = time.time() - t1
            n_local = calls[0]
            # a failing run leaves the server up
            try:
                _rosen_bobe(_rosen_counted()[0], server=sock).run(
                    acq="not_an_acquisition")
                raise AssertionError("phase 18: a run with a bad acq did "
                                     "not raise")
            except RuntimeError as e:
                if "device-server run failed" not in str(e):
                    raise
            if client.ping(sock) is None:
                raise AssertionError("phase 18: the server died with the "
                                     "failed run")
            cold, cold_wall = _child(["--server-inproc", device], env={
                k: v for k, v in cenv.items() if k != "BOBE_TPU_SERVER"})
            cold = cold["server_inproc"]
            cold["process_wall_s"] = cold_wall
            if not client.shutdown(sock):
                raise AssertionError("phase 18: shutdown not acknowledged")
            proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    # checks: the clients loaded no torch and hid the card, the likelihood
    # ran in them, and every run equals the in-process one
    local_state = local["gp"].state_dict()
    card_mean = local["gp"].predict_mean_batched(SERVER_MEAN_X).cpu().numpy()
    mean_scale = float(np.max(np.abs(card_mean)))
    close = lambda a, b: np.allclose(a, b, rtol=SERVER_RTOL, atol=0)
    for i, c in enumerate(clients):
        bad = []
        if c["torch_loaded"] or c["cuda_visible_devices"] != "":
            bad.append("the client loaded torch for its run or could reach "
                       "the card")
        if i == 0 and (c["cuda_initialized"] or c["gp_device"] != "cpu"):
            bad.append("the rebuilt GP is not on the CPU, or CUDA started")
        if i == 1 and c["torch_at_exit"]:
            bad.append("the client imported torch without reading the GP")
        if c["calls"] != n_local:
            bad.append(f"{c['calls']} likelihood calls, in process "
                       f"{n_local}")
        if not close(c["best_val"], local["best_val"]) or \
                not close(c["best_pt"], local["best_pt"]):
            bad.append(f"best {c['best_val']!r} at {c['best_pt']}, in "
                       f"process {local['best_val']!r} at "
                       f"{list(local['best_pt'])}")
        for k in SERVER_STATE_KEYS:
            if not close(np.asarray(c["gp_state"][k]), local_state[k]):
                bad.append(f"the GP state's {k} differs")
        if "gp_mean" in c and not np.allclose(
                c["gp_mean"], card_mean, rtol=0,
                atol=SERVER_RTOL * mean_scale):
            bad.append(f"rebuilt GP mean {c['gp_mean']} != the card's "
                       f"{card_mean.tolist()}")
        if bad:
            raise AssertionError(f"phase 18 client {i + 1}: " + "; ".join(bad))
    if not np.allclose(cold["best_val"], local["best_val"], rtol=SERVER_RTOL,
                       atol=0) or cold["calls"] != n_local:
        raise AssertionError(f"phase 18: the cold process's run differs: "
                             f"{cold}")
    # the CPU's plain versions count no launch
    if device.startswith("cuda") and out["server_launches"]["gram_masked"] <= 0:
        raise AssertionError("phase 18: the server's runs launched no Gram "
                             "kernel")
    out.update(clients=clients, cold=cold, calls=n_local,
               best_val=float(local["best_val"]),
               mean_rel_card_vs_rebuilt=float(np.max(np.abs(
                   np.asarray(clients[0]["gp_mean"]) - card_mean)
                   / np.abs(card_mean))),
               mean_scaled_card_vs_rebuilt=float(np.max(np.abs(
                   np.asarray(clients[0]["gp_mean"]) - card_mean))
                   / mean_scale))
    for i, c in enumerate(clients):
        gp_note = (f"the GP's rebuild on the CPU, torch's import with it, "
                   f"{c['gp_rebuild_s']:.2f} s" if "gp_rebuild_s" in c else
                   "no GP rebuild: torch never imported")
        print(f"[phase 18] client {i + 1}: process wall "
              f"{c['process_wall_s']:.2f} s = imports {c['import_s']:.3f} s "
              f"+ run {c['run_s']:.2f} s (+ {gp_note}, and the "
              f"interpreter); torch loaded by the run: {c['torch_loaded']}, "
              f"at exit: {c['torch_at_exit']}, CUDA_VISIBLE_DEVICES="
              f"{c['cuda_visible_devices']!r}, CUDA initialised: "
              f"{c.get('cuda_initialized', False)}; {c['calls']} likelihood "
              f"calls in the client; best {c['best_val']:.12g}")
    print(f"[phase 18] cold process without a server: wall "
          f"{cold['process_wall_s']:.2f} s = imports {cold['import_s']:.3f} "
          f"s + run {cold['run_s']:.2f} s; in this process (warm): run "
          f"{out['inproc_run_s']:.2f} s; server boot (torch, CUDA, the "
          f"library, one Gram launch, the d=2 prewarm) "
          f"{out['server_boot_s']:.2f} s")
    print(f"[phase 18] {len(clients)} client runs equal the in-process run "
          f"at rtol {SERVER_RTOL} (best value, best point, the GP state over "
          f"the wire; client 1's GP rebuilt on the CPU against the "
          f"in-process GP on the card at 5 points within {SERVER_RTOL} of "
          f"the largest mean: {out['mean_scaled_card_vs_rebuilt']:.2e} of "
          f"it, {out['mean_rel_card_vs_rebuilt']:.2e} relative at most); "
          f"the server's "
          f"kernel launches over the two runs: "
          + json.dumps(out["server_launches"]))
    return out


def phase_mesh(device):
    """The mesh (bobe_tpu_torch/parallel/mesh.py) on the card named twice,
    and on every card when there are two or more: sharded predict, WIPStd
    sweep and NUTS against the unsharded calls."""
    import os

    import numpy as np
    import torch

    from bobe_tpu_torch import acquisition as acq
    from bobe_tpu_torch import samplers
    from bobe_tpu_torch.infer.nuts import run_chain
    from bobe_tpu_torch.models import gp as gpm
    from bobe_tpu_torch.ops import kernels as kr
    from bobe_tpu_torch.parallel import mesh as pm
    from bobe_tpu_torch.utils.seed import split_generator

    gp = build_gp_1024(device, JAX_LOG_PARAMS)
    rng = np.random.default_rng(19)
    xq = torch.as_tensor(rng.uniform(size=(MESH_PREDICT_N, NDIM)),
                         device=device)
    pool = torch.as_tensor(rng.uniform(size=(MESH_POOL_N, NDIM)),
                           device=device)
    init = torch.as_tensor(rng.normal(size=(MESH_CHAINS, NDIM)),
                           device=device)
    make_vg, ctx = samplers._logprob_target(gp, 1.0)
    gens = lambda: split_generator(
        torch.Generator(device=device).manual_seed(19), MESH_CHAINS)
    sync = (torch.cuda.synchronize if device.startswith("cuda")
            else (lambda: None))
    rel = lambda a, b: float(torch.max(torch.abs(a - b) / torch.abs(b)))

    sync()
    t0 = time.time()
    n0 = kr.gram_masked.launches
    mean_u, var_u = gpm.predict(gp.state, gp.cfg, xq)
    chunked = [gpm.predict(gp.state, gp.cfg, c) for c in torch.chunk(xq, 2)]
    acq_u = acq._wip_sweep_core(gp, pool, True)[0]
    zs_u, _, diag_u = run_chain(make_vg(ctx), init, gens(), **MESH_NUTS)
    sync()
    n_unsharded = kr.gram_masked.launches - n0
    t_unsharded = time.time() - t0
    # the chains in the mesh's groups, unsharded (not timed)
    half = MESH_CHAINS // 2
    groups = [run_chain(make_vg(ctx), init[r], gens()[r], **MESH_NUTS)[0]
              for r in (slice(0, half), slice(half, None))]
    meshes = [("cuda:0 named twice", pm.get_mesh([device, device]))]
    if torch.cuda.device_count() >= 2:
        # the production mesh is opt-in (BOBE_TPU_MESH=1)
        os.environ["BOBE_TPU_MESH"] = "1"
        try:
            prod = pm.production_mesh(device)
        finally:
            os.environ.pop("BOBE_TPU_MESH")
        meshes.append((f"production mesh of {torch.cuda.device_count()} "
                       "cards", prod))
    else:
        print("[phase 19] one card on this host: the mesh runs on cuda:0 "
              "named twice (a run across two cards needs a host with two)")
    out = {"unsharded_s": t_unsharded}
    for label, mesh in meshes:
        t0 = time.time()
        n0 = kr.gram_masked.launches
        mean_s, var_s = pm.sharded_predict(gp, xq, mesh)
        acq_s = pm.sharded_wip_sweep(gp, pool, True, mesh)
        zs_s, _, diag_s = pm.sharded_nuts(make_vg, ctx, init, gens(), mesh,
                                          **MESH_NUTS)
        sync()
        n_sharded = kr.gram_masked.launches - n0
        wall = time.time() - t0
        var_scale = float(torch.exp(gp.state.log_amp) * gp.state.y_std ** 2)
        errs = {"predict_mean": rel(mean_s, mean_u),
                "predict_var": float(torch.max(torch.abs(var_s - var_u)))
                / var_scale,
                "predict_var_rel": rel(var_s, var_u),
                "wip_sweep": rel(acq_s, acq_u)}
        bad = [f"{k} {errs[k]:.2e} (limit {lim})" for k, lim in (
            ("predict_mean", MESH_RTOL), ("predict_var", MESH_RTOL),
            ("wip_sweep", MESH_WIP_RTOL)) if not errs[k] <= lim]
        if int(torch.argmin(acq_s)) != int(torch.argmin(acq_u)):
            bad.append("the WIPStd sweep's best candidate differs")
        if len(mesh) == 2 and not (
                torch.equal(mean_s, torch.cat([c[0] for c in chunked]))
                and torch.equal(var_s, torch.cat([c[1] for c in chunked]))):
            bad.append("predictions differ from the same chunks unsharded")
        if mean_s.shape != (MESH_PREDICT_N,) or \
                acq_s.shape != (MESH_POOL_N,):
            bad.append("shapes")
        grouped = torch.cat(groups) if len(mesh) == 2 else None
        if grouped is not None and not torch.equal(zs_s, grouped):
            bad.append("NUTS chains differ from the same chains run in the "
                       "mesh's groups")
        chain_diff = float(torch.max(torch.abs(zs_s - zs_u)))
        xs_s = torch.sigmoid(zs_s).reshape(-1, NDIM)
        xs_u = torch.sigmoid(zs_u).reshape(-1, NDIM)
        gap = torch.abs(xs_s.mean(0) - xs_u.mean(0))
        se = torch.sqrt((xs_s.var(0) + xs_u.var(0)) / xs_s.shape[0])
        moments, z_max = float(gap.max()), float((gap / se).max())
        if not z_max <= MESH_NUTS_Z:
            bad.append(f"NUTS means differ by {z_max:.2f} standard errors")
        if n_sharded != n_unsharded:
            bad.append(f"forward Gram launches {n_sharded} sharded, "
                       f"{n_unsharded} unsharded")
        if bad:
            raise AssertionError(f"phase 19 ({label}): " + "; ".join(bad))
        print(f"[phase 19] {label}: predict at {MESH_PREDICT_N} points "
              f"(padded to {len(mesh) * -(-MESH_PREDICT_N // len(mesh))}) "
              f"from unsharded: mean {errs['predict_mean']:.1e} relative, "
              f"var {errs['predict_var']:.1e} of its scale "
              f"({errs['predict_var_rel']:.1e} relative), limits "
              f"{MESH_RTOL}; WIPStd sweep over an uneven pool of "
              f"{MESH_POOL_N} {errs['wip_sweep']:.1e} relative (limit "
              f"{MESH_WIP_RTOL}); NUTS {MESH_CHAINS} chains equal the "
              f"same chains run in the mesh's groups bit for bit, "
              f"{chain_diff:.1e} from the full batch (the batch width's "
              f"roundoff, amplified), means {moments:.4f} apart "
              f"({z_max:.2f} standard errors, limit {MESH_NUTS_Z}); forward "
              f"Gram launches {n_sharded} (unsharded {n_unsharded}); "
              f"{wall:.2f} s sharded, {t_unsharded:.2f} s unsharded")
        out[label] = dict(errs, nuts_chain_diff=chain_diff,
                          nuts_mean_diff=moments, nuts_mean_z=z_max,
                          wall_s=wall,
                          launches=n_sharded)
    return out


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
    bwd_x = {"name": "gram_masked_backward_x", "route": "cuda",
             "source": SOURCE, "replaces": REPLACES_BACKWARD_X}
    phase_build()
    fwd["max_abs_err"] = phase_kernel_check()
    bwd["max_abs_err"] = phase_backward_check()
    bwd_x["max_abs_err"] = phase_backward_x_check()
    times = phase_kernel_time()
    # each kernel at its main-path shape: the N=1024 refresh, the d=30 fit,
    # the planck-like warp fit's per-lane shape
    for entry, key in ((fwd, ("forward", 1024, 8, 1, False)),
                       (bwd, ("backward", 1280, 30, 4, False)),
                       (bwd_x, ("backward_x", *WARP_FIT_SHAPE))):
        entry.update(times[key], library_ms=None,
                     shape={"cap": key[1], "d": key[2], "lanes": key[3],
                            "per_lane_x": key[4]})
    fwd["per_lane_x"] = times[("forward", *WARP_FIT_SHAPE)]

    # the main path, phase by phase: counts from 0, comparison launches
    # above excluded
    counters = (kr.gram_masked, kr.gram_masked_backward,
                kr.gram_masked_backward_x)
    launches = {}
    lane_x = {}
    results = {}
    for label, run in (("4", lambda: phase_slice("cuda",
                                                  mc_points_method="NS")),
                       ("5", lambda: phase_real_size("cuda")),
                       ("6", lambda: phase_fit_d30("cuda")),
                       ("6b", lambda: phase_warp_d30("cuda")),
                       ("7", lambda: phase_slice("cuda", label="7")),
                       ("8", lambda: phase_pools("cuda")),
                       ("9", lambda: phase_fallback("cuda")),
                       ("10", lambda: phase_planck_state("cuda")),
                       ("11", lambda: phase_planck_run("cuda")),
                       ("12", lambda: phase_warp_saas("cuda")),
                       ("13", lambda: phase_ei("cuda")),
                       ("14", lambda: phase_resume_pool("cuda")),
                       ("15", lambda: phase_cobaya("cuda")),
                       ("16", lambda: phase_distributed("cuda")),
                       ("18", lambda: phase_server("cuda")),
                       ("19", lambda: phase_mesh("cuda"))):
        for c in counters:
            c.launches = 0
        kr.gram_masked.launches_lane_x = 0
        t_phase = time.time()
        res = results[label] = run()
        launches[label] = [c.launches for c in counters]
        lane_x[label] = kr.gram_masked.launches_lane_x
        print(f"[phase {label}] kernel launches: gram_masked "
              f"{launches[label][0]} (per-lane x {lane_x[label]}), "
              f"gram_masked_backward {launches[label][1]}, "
              f"gram_masked_backward_x {launches[label][2]}; phase wall "
              f"{time.time() - t_phase:.1f} s")
        if launches[label][0] <= 0:
            raise AssertionError(f"phase {label} did not launch the Gram "
                                 "kernel")
    if launches["6"][1] <= 0:
        raise AssertionError("phase 6 did not launch the Gram backward "
                             "kernel")
    for label in ("6b", "12"):
        if launches[label][2] <= 0 or lane_x[label] <= 0:
            raise AssertionError(f"phase {label} did not launch the per-lane "
                                 "forward and the dL/dx backward")
    res = results["6"]
    t_fwd = times[("forward", 1280, 30, 4, False)]["ms"]
    t_bwd = times[("backward", 1280, 30, 4, False)]["ms"]
    k_ms = launches["6"][0] * t_fwd + launches["6"][1] * t_bwd
    print(f"[phase 6] the two kernels' share of the fit: "
          f"{launches['6'][0]} x {t_fwd:.4f} ms + {launches['6'][1]} x "
          f"{t_bwd:.4f} ms (phase 3 device times at cap 1280, d=30, 4 "
          f"lanes) = {k_ms:.1f} ms of {res['fit_s'] * 1e3:.1f} ms "
          f"({100 * k_ms / (res['fit_s'] * 1e3):.2f} %)")
    res = results["6b"]
    t_fwd = times[("forward", 1280, 30, 4, True)]["ms"]
    t_bwd = times[("backward_x", 1280, 30, 4, True)]["ms"]
    k_ms = res["fit_fwd"] * t_fwd + res["fit_dx"] * t_bwd
    print(f"[phase 6b] the per-lane forward and the dL/dx backward's share "
          f"of the warp fit: {res['fit_fwd']} x {t_fwd:.4f} ms + "
          f"{res['fit_dx']} x {t_bwd:.4f} ms (phase 3 device times at cap "
          f"1280, d=30, 4 lanes, per-lane x) = {k_ms:.1f} ms of "
          f"{res['fit_s'] * 1e3:.1f} ms "
          f"({100 * k_ms / (res['fit_s'] * 1e3):.2f} %)")
    ledgers = {k: {p: round(v, 3) for p, v in results[k]["ledger"].items()}
               for k in ("4", "7")}
    print("[phase 7] timing ledger beside phase 4's (s): "
          + json.dumps({"phase 4 (NS pool)": ledgers["4"],
                        "phase 7 (EHMC pool)": ledgers["7"]}))
    for i, entry in enumerate((fwd, bwd, bwd_x)):
        entry["launches"] = sum(v[i] for v in launches.values())
        entry["launches_by_phase"] = {k: v[i] for k, v in launches.items()}
    fwd["per_lane_x"]["launches_by_phase"] = lane_x
    # both backwards at every timed shape, launches per call
    for entry, kind in ((bwd, "backward"), (bwd_x, "backward_x")):
        entry["by_shape"] = [
            {"cap": k[1], "d": k[2], "lanes": k[3], "ms": v["ms"],
             "bound_ms": v["bound_ms"], "bound_by": v["bound_by"],
             "launches_per_call": v["launches_per_call"], "tile": v["tile"]}
            for k, v in times.items() if k[0] == kind]
    phase_cold_start()
    print(json.dumps({"kernels": [fwd, bwd, bwd_x]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-worker"]:
        _dist_worker(int(sys.argv[2]))
    elif sys.argv[1:] == ["--cold-start"]:
        _cold_start()
    elif sys.argv[1:2] == ["--server-client"]:
        _server_client(sys.argv[2] == "rebuild")
    elif sys.argv[1:2] == ["--server-inproc"]:
        _server_inproc(sys.argv[2])
    else:
        sys.exit(main())
