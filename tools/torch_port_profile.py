"""Where the time goes in the PyTorch port on one NVIDIA card.

Profiles, with torch.profiler (CPU + CUDA activities), three workloads of
chip_smoke.py's phases 5 and 6, built by chip_smoke's own functions, after
one warm-up run of each:

* ``fit1024``: phase 5a, GP.fit at N=1024, d=8 (bench.py's data and restart
  seeds, 4 restarts, 30 its);
* ``ns1024``: phase 5d, one convergence-mode nested_sampling on that data
  with the JAX package's fitted hyperparameters;
* ``fit_d30``: phase 6, GP.fit at N=1200, d=30 (capacity 1280, above the
  per-dimension budget: the Gram forward and backward kernels in every
  objective; 4 restarts, 20 its).

Each run gets a fresh GP, built outside the profiled window.

The banana end-to-end run is left out: it launches a few million kernels,
and the profiler's post-processing of them takes longer than the run (over
20 minutes on an H100 host); its phase walls come from the run's timing
ledger (chip_smoke.py phase 4).

For each it prints the wall time, the summed device-kernel time, the
device's busy share (kernel time over wall), the number of kernel launches,
and the kernels with the most device time, then the same as one JSON line
per workload.

    python tools/torch_port_profile.py
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402


def _workloads():
    """name -> setup(); setup builds a fresh GP and returns the run."""
    import chip_smoke as cs

    def fit1024():
        gp = cs.build_gp_1024("cuda")
        x0 = cs.fit_x0(gp)
        return lambda: gp.fit(x0=x0, maxiter=cs.MAXITER)

    def ns1024():
        gp = cs.build_gp_1024("cuda", cs.JAX_LOG_PARAMS)
        return lambda: cs.run_ns_1024(gp, "cuda")

    def fit_d30():
        gp, x0 = cs.build_fit_d30("cuda")
        return lambda: gp.fit(x0=x0, maxiter=cs.MAXITER30)

    return {"fit1024": fit1024, "ns1024": ns1024, "fit_d30": fit_d30}


def profile(name, setup, top=8):
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    setup()()  # warm-up: kernel build, cuBLAS/cuSOLVER handles
    fn = setup()
    torch.cuda.synchronize()
    t0 = time.time()
    fn()
    torch.cuda.synchronize()
    wall_plain = time.time() - t0
    fn = setup()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    n_launch = sum(e.count for e in kernels)
    kernels.sort(key=lambda e: -e.self_device_time_total)
    # busy_share: kernel time over the profiled wall; busy_share_unprofiled:
    # the same kernel time over the wall of an identical run without the
    # profiler, taken just before it
    out = {"workload": name, "wall_s": wall, "wall_unprofiled_s": wall_plain,
           "kernel_s": busy_us / 1e6, "busy_share": busy_us / 1e6 / wall,
           "busy_share_unprofiled": busy_us / 1e6 / wall_plain,
           "launches": n_launch,
           "top": [{"kernel": e.key[:90], "s": e.self_device_time_total / 1e6,
                    "count": e.count} for e in kernels[:top]]}
    return out


def main():
    if not torch.cuda.is_available():
        print("torch_port_profile: no CUDA device visible", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    for name, setup in _workloads().items():
        res = profile(name, setup)
        res["card"] = card
        print(f"{name}: wall {res['wall_s']:.3f} s (unprofiled "
              f"{res['wall_unprofiled_s']:.3f} s), kernels "
              f"{res['kernel_s']:.3f} s, busy {res['busy_share']:.1%} "
              f"({res['busy_share_unprofiled']:.1%} of the unprofiled wall), "
              f"{res['launches']} launches")
        for t in res["top"]:
            print(f"    {t['s']:.4f} s  x{t['count']:<7d} {t['kernel']}")
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
