#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bobe_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # every phase, one card

Phases (each prints its own lines; nothing is caught, any failure exits
non-zero):

1. build the CUDA Gram kernel from bobe_tpu_torch/csrc/gram_masked.cu;
2. hold the kernel against its plain PyTorch version on the card, over
   rbf/matern, float32/float64, a range of capacities and dimensions;
3. time the kernel and the plain version (CUDA events, median of 25);
4. run the slice end to end: BOBE on the banana toy, WIPStd acquisition with
   an NS-mode MC pool, on the card;
5. the slice's operations at N=1024, d=8 (the bench.py cell): a GP fit, a
   WIPStd batch, and a convergence-mode nested sampling run checked against
   the JAX package's logZ for the same GP state.

The kernel's launch count is set to 0 just before phase 4 and before
phase 5 and read just after each; a phase that did not launch the kernel
fails. The script prints the card's name and power limit, one JSON line
describing every kernel, and as its last line {"ok": true, "device": {...}}.
Without a CUDA card it exits non-zero before printing any result.
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


def _inputs(cap, d, seed, dtype, device):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.uniform(size=(cap, d)), device=device)
    n = max(1, int(0.7 * cap))
    mask = (torch.arange(cap, device=device) < n).double()
    ls = torch.as_tensor(rng.uniform(0.05, 2.0, size=d), device=device)
    amp = torch.tensor(float(rng.uniform(0.5, 3.0)), dtype=torch.float64,
                       device=device)
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
            for cap in (100, 128, 256, 1000, 1024, 2048):
                for d in (2, 8, 30):
                    x, mask, ls, amp, noise, n = _inputs(
                        cap, d, 1000 * cap + d, dt, dev)
                    got = kr.gram_masked(name, x, mask, ls, amp, noise)
                    want = kr.gram_masked_plain(name, x.double(),
                                                mask.double(), ls.double(),
                                                amp.double(), noise)
                    rtol, atol_rel = tol[dt]
                    err = (got.double() - want).abs()
                    bound = atol_rel * float(amp) + rtol * want.abs()
                    if not bool((err <= bound).all()):
                        raise AssertionError(
                            f"gram_masked {name} {dt} cap={cap} d={d}: max "
                            f"error {float(err.max()):.3e} beyond tolerance")
                    if not torch.equal(got, got.T):
                        raise AssertionError(
                            f"gram_masked {name} {dt} cap={cap} d={d}: not "
                            "exactly symmetric")
                    eye = torch.eye(cap - n, dtype=dt, device=dev)
                    if not torch.equal(got[n:, n:], eye) or \
                            bool(got[n:, :n].abs().max() != 0):
                        raise AssertionError(
                            f"gram_masked {name} {dt} cap={cap} d={d}: pad "
                            "block is not exactly the identity")
                    worst[dt] = max(worst[dt], float(err.max()))
                    n_cases += 1
    _sync()
    print(f"[phase 2] {n_cases} cases agree with gram_masked_plain (f64 on "
          f"the card): max abs err f64 {worst[torch.float64]:.3e} "
          f"(rtol 1e-10, atol 1e-12*amp), f32 {worst[torch.float32]:.3e} "
          "(rtol 2e-5, atol 2e-5*amp); exactly symmetric; pad block exactly "
          "the identity")
    return worst[torch.float64]


def phase_kernel_time():
    import torch

    from bobe_tpu_torch.ops import kernels as kr

    dev = torch.device("cuda")
    out = {}
    for cap in (128, 1024, 2048):
        x, mask, ls, amp, noise, _ = _inputs(cap, 8, cap, torch.float64, dev)
        t_p0 = _median_ms(lambda: kr.gram_masked_plain("rbf", x, mask, ls,
                                                       amp, noise))
        t_k = _median_ms(lambda: kr.gram_masked("rbf", x, mask, ls, amp,
                                                noise))
        t_p1 = _median_ms(lambda: kr.gram_masked_plain("rbf", x, mask, ls,
                                                       amp, noise))
        t_p = min(t_p0, t_p1)
        out[cap] = (t_k, t_p)
        print(f"[phase 3] gram_masked rbf f64 cap={cap} d=8: kernel "
              f"{t_k:.4f} ms, plain {t_p:.4f} ms (plain before/after "
              f"{t_p0:.4f}/{t_p1:.4f} ms; median of 25, CUDA events)")
    return out


def _state_on(gp, device_type):
    st = gp.state
    return all(t.device.type == device_type
               for t in (st.x, st.y_raw, st.chol, st.alpha, st.log_ls))


def phase_slice(device):
    """The slice end to end on the banana toy (tests/test_bo_2d.py's
    settings, with an NS-mode MC pool)."""
    import numpy as np

    from bobe_tpu_torch.bo import BOBE
    from bobe_tpu_torch.models import toys

    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        bobe = BOBE(toys.banana, param_list=toys.banana_names,
                    param_bounds=toys.banana_bounds,
                    likelihood_name="banana_smoke", n_sobol_init=8, seed=7,
                    pool="serial", device=device, save_dir=tmp,
                    verbosity="WARNING")
        res = bobe.run(acq="wipstd", mc_points_method="NS", min_evals=16,
                       max_evals=160, max_gp_size=200, logz_threshold=0.05,
                       batch_size=4, fit_n_points=4, ns_n_points=8)
        import os

        for suffix in ("_results.pkl", ".txt", "_stats.json", "_timing.json"):
            if not os.path.exists(os.path.join(tmp, "banana_smoke" + suffix)):
                raise AssertionError(f"phase 4: result file {suffix} missing")
    wall = time.time() - t0
    logz = res["logz"]
    if not (logz and np.isfinite(logz["mean"])):
        raise AssertionError(f"phase 4: no successful NS evidence: {logz}")
    if abs(logz["mean"] - BANANA_LOGZ) >= 0.3:
        raise AssertionError(f"phase 4: logZ {logz['mean']:.4f} is not "
                             f"within 0.3 of {BANANA_LOGZ}")
    if not _state_on(res["gp"], device.split(":")[0]):
        raise AssertionError("phase 4: GP state is not on the device")
    timing = res["results_manager"].get_timing_summary()
    print(f"[phase 4] banana WIPStd/NS on {device}: logZ "
          f"{logz['mean']:.4f} (truth {BANANA_LOGZ}), err_total "
          f"{logz['err_total']:.4f}, dlogz_sampler "
          f"{logz['dlogz_sampler']:.4f}, {res['gp'].npoints} evaluations, "
          f"termination '{res['termination_reason']}', wall {wall:.2f} s")
    print("[phase 4] timing ledger (s): " + json.dumps(
        {k: round(v, 3) for k, v in timing["phase_times"].items()}))
    return {"logz": logz["mean"], "err_total": logz["err_total"],
            "n_evals": res["gp"].npoints, "wall_s": wall}


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

    kernel = {"name": "gram_masked", "route": "cuda", "source": SOURCE,
              "replaces": REPLACES}
    phase_build()
    kernel["max_abs_err"] = phase_kernel_check()
    kernel["ms"], kernel["plain_ms"] = phase_kernel_time()[1024]
    # the main path: counts from 0, comparison launches above excluded
    kr.gram_masked.launches = 0
    phase_slice("cuda")
    kernel["launches"] = kr.gram_masked.launches
    print(f"[phase 4] gram_masked kernel launches: {kernel['launches']}")
    if kernel["launches"] <= 0:
        raise AssertionError("phase 4 did not launch the Gram kernel")
    kr.gram_masked.launches = 0
    phase_real_size("cuda")
    launches5 = kr.gram_masked.launches
    print(f"[phase 5] gram_masked kernel launches: {launches5}")
    if launches5 <= 0:
        raise AssertionError("phase 5 did not launch the Gram kernel")
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
