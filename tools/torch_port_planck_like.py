"""examples/planck_like_synthetic.py on the PyTorch port, to convergence, on
one CUDA card.

The planck-like target (bobe_tpu_torch/models/toys.make_planck_like: d=6,
curved degeneracies, a hard failure region, analytic logZ) through
``bobe_tpu_torch.BOBE`` at the example's own settings: 48 Sobol points plus
8 reference draws, the SVM-gated GP (``use_clf=True``), WIPStd with the
default ensemble-HMC pool, logz_threshold 0.05 over two successive checks,
120 to 500 evaluations, ``do_final_ns=True``; with ``--warp`` the GP warps
its inputs (``gp_kwargs={"input_warp": True}``, what the example's
BOBE_TPU_EX_WARP=1 selects), so every fit objective runs the per-lane Gram
forward and the dL/dx backward. Prints the card, the run's
termination, logZ against the truth, the count of true evaluations, the
wall, the seconds of every classifier training by dataset size and the
timing ledger, then one JSON line of the same numbers.

    python tools/torch_port_planck_like.py [--seed 3] [--max-evals 500] [--warp]
        [--device cpu] [--save-gp final_gp.npz]

Without a CUDA card the port's default device raises.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import numpy as np
    import torch

    from bobe_tpu_torch.bo import BOBE
    from bobe_tpu_torch.models import toys

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--max-evals", type=int, default=500)
    ap.add_argument("--warp", action="store_true",
                    help="the Kumaraswamy input warp (BOBE_TPU_EX_WARP=1)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default), or cpu for a rehearsal")
    ap.add_argument("--save-gp", default=None, metavar="PATH",
                    help="write the final GP to PATH (.npz, loads in either "
                         "package)")
    args = ap.parse_args()
    from bobe_tpu_torch.ops import kernels as kr

    card = (subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
        if args.device.startswith("cuda") else "cpu")
    print(card)
    loglike, bounds, names, logz_true = toys.make_planck_like()
    ref_x, ref_y = toys.planck_like_ref_draws(
        loglike, bounds, 8, np.random.default_rng(args.seed))
    t0 = time.time()
    bobe = BOBE(loglikelihood=loglike, param_list=names, param_bounds=bounds,
                n_sobol_init=48, n_cobaya_init=0, init_train_x=ref_x,
                init_train_y=ref_y, use_clf=True, clf_type="svm",
                seed=args.seed, save=False, verbosity="INFO",
                device=args.device,
                gp_kwargs={"input_warp": True} if args.warp else None)
    svm_s = []
    train = bobe.gp.train_classifier

    def timed_training():
        t = time.perf_counter()
        train()
        svm_s.append((bobe.gp.clf_data_size, time.perf_counter() - t))

    bobe.gp.train_classifier = timed_training
    res = bobe.run(acq="wipstd", min_evals=120, max_evals=args.max_evals,
                   max_gp_size=600, logz_threshold=0.05, fit_n_points=8,
                   batch_size=4, ns_n_points=12, convergence_n_iters=2,
                   do_final_ns=True)
    if args.device.startswith("cuda"):
        torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {"gram_masked": kr.gram_masked.launches,
                "gram_masked_per_lane_x": kr.gram_masked.launches_lane_x,
                "gram_masked_backward": kr.gram_masked_backward.launches,
                "gram_masked_backward_x": kr.gram_masked_backward_x.launches}
    gp, logz = res["gp"], res["logz"]
    if args.save_gp:
        gp.save(args.save_gp)
    ledger = res["results_manager"].get_timing_summary()["phase_times"]
    err = abs(logz["mean"] - logz_true)
    print(f"{res['termination_reason']}: logZ {logz['mean']:.4f} (truth "
          f"{logz_true:.4f}, |dlogZ| {err:.4f}, target <= 0.1), err_total "
          f"{logz['err_total']:.4f}, dlogz_sampler "
          f"{logz['dlogz_sampler']:.4f}; {gp.clf_data_size} true evaluations "
          f"(GP rows {gp.gp_size}); wall {wall:.2f} s")
    print("SVM training (n, s): " + json.dumps(
        [(n, round(t, 4)) for n, t in svm_s]))
    print("timing ledger (s): " + json.dumps(
        {k: round(v, 3) for k, v in ledger.items()}))
    print("kernel launches: " + json.dumps(launches))
    if args.warp:
        print(f"fitted warp: a {np.exp(gp.state.log_wa.cpu().numpy())}, "
              f"b {np.exp(gp.state.log_wb.cpu().numpy())}")
    print(json.dumps({
        "card": card, "warp": bool(args.warp), "launches": launches,
        "termination_reason": res["termination_reason"],
        "logz": logz["mean"], "logz_true": logz_true, "abs_dlogz": err,
        "err_total": logz["err_total"],
        "dlogz_sampler": logz["dlogz_sampler"],
        "n_evals": int(gp.clf_data_size), "gp_rows": int(gp.gp_size),
        "wall_s": wall, "svm_s": svm_s, "ledger": ledger}))
    ok = res["termination_reason"] == "LogZ converged"
    if args.warp and args.device.startswith("cuda"):
        ok = ok and launches["gram_masked_backward_x"] > 0
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
