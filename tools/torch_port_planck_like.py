"""examples/planck_like_synthetic.py on the PyTorch port, to convergence, on
one CUDA card.

The planck-like target (bobe_tpu_torch/models/toys.make_planck_like: d=6,
curved degeneracies, a hard failure region, analytic logZ) through
``bobe_tpu_torch.BOBE`` at the example's own settings: 48 Sobol points plus
8 reference draws, the SVM-gated GP (``use_clf=True``), WIPStd with the
default ensemble-HMC pool, logz_threshold 0.05 over two successive checks,
120 to 500 evaluations, ``do_final_ns=True``. Prints the card, the run's
termination, logZ against the truth, the count of true evaluations, the
wall, the seconds of every classifier training by dataset size and the
timing ledger, then one JSON line of the same numbers.

    python tools/torch_port_planck_like.py [--seed 3] [--max-evals 500]

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
    args = ap.parse_args()

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    loglike, bounds, names, logz_true = toys.make_planck_like()
    ref_x, ref_y = toys.planck_like_ref_draws(
        loglike, bounds, 8, np.random.default_rng(args.seed))
    t0 = time.time()
    bobe = BOBE(loglikelihood=loglike, param_list=names, param_bounds=bounds,
                n_sobol_init=48, n_cobaya_init=0, init_train_x=ref_x,
                init_train_y=ref_y, use_clf=True, clf_type="svm",
                seed=args.seed, save=False, verbosity="INFO")
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
    torch.cuda.synchronize()
    wall = time.time() - t0
    gp, logz = res["gp"], res["logz"]
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
    print(json.dumps({
        "card": card, "termination_reason": res["termination_reason"],
        "logz": logz["mean"], "logz_true": logz_true, "abs_dlogz": err,
        "err_total": logz["err_total"],
        "dlogz_sampler": logz["dlogz_sampler"],
        "n_evals": int(gp.clf_data_size), "gp_rows": int(gp.gp_size),
        "wall_s": wall, "svm_s": svm_s, "ledger": ledger}))
    return 0 if res["termination_reason"] == "LogZ converged" else 1


if __name__ == "__main__":
    sys.exit(main())
