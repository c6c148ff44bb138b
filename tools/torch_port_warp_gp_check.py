"""Where a warp run's logZ error comes from: the final GP of a planck-like
warp run (written by ``tools/torch_port_planck_like.py --save-gp`` or
``tools/torch_port_reference.py --planck-warp-run --save-gp``), read by
the JAX package on the CPU.

For each file it prints one JSON line:

- ``logz_as_saved``: the JAX package's final-precision NS (convergence
  mode, dlogz 0.01, ``--runs`` merged runs, numpy seed 0) on the GP at its
  saved hyperparameters, beside the truth;
- ``jax_refit_neg_mll`` / ``port_refit_neg_mll``: both packages' refit of
  the saved rows from the same restarts (the run's own refit settings at
  this size: 4 restarts, maxiter 250, numpy seed 0; the port on the CPU),
  with the saved fit's neg_mll;
- ``logz_jax_refit``: the same NS on the JAX package's refit.

    JAX_PLATFORMS=cpu python tools/torch_port_warp_gp_check.py GP.npz [...]
        [--runs 17]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("files", nargs="+")
    ap.add_argument("--runs", type=int, default=17)
    args = ap.parse_args()

    import jax.numpy as jnp

    from bobe_tpu.bo import load_gp_file
    from bobe_tpu.models import toys
    from bobe_tpu.samplers import nested_sampling
    from bobe_tpu_torch.bo import load_gp_file as port_load_gp_file

    logz_true = toys.make_planck_like()[3]

    def ns_logz(gp):
        _, z, ok = nested_sampling(gp, mode="convergence", dlogz=0.01,
                                   n_runs=args.runs,
                                   rng=np.random.default_rng(0))
        return float(z["mean"]), float(z["dlogz_sampler"]), bool(ok)

    for path in args.files:
        gp = load_gp_file(path, clf=True)
        st = gp.state
        saved_f = float(gp.neg_mll(jnp.concatenate(
            [st.log_ls, st.log_amp[None], st.log_wa, st.log_wb])))
        as_saved = ns_logz(gp)
        jinfo = gp.fit(n_restarts=4, maxiter=250,
                       rng=np.random.default_rng(0))
        refit = ns_logz(gp)
        port = port_load_gp_file(path, clf=True, device="cpu")
        pinfo = port.fit(n_restarts=4, maxiter=250,
                         rng=np.random.default_rng(0))
        print(json.dumps({
            "file": os.path.basename(path), "gp_rows": int(gp.state.n),
            "logz_true": logz_true,
            "saved_neg_mll": saved_f,
            "logz_as_saved": as_saved[0], "dlogz_sampler": as_saved[1],
            "jax_refit_neg_mll": -float(jinfo["mll"]),
            "port_refit_neg_mll": -float(pinfo["mll"]),
            "logz_jax_refit": refit[0],
            "jax_refit_log_params": np.asarray(jinfo["params"]).tolist()}),
            flush=True)


if __name__ == "__main__":
    main()
