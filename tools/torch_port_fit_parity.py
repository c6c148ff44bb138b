"""Where the card's and the CPU's fits of the same GP part, and why.

One GP fit -- 230 noiseless points of a Gaussian in d=8 (capacity 256),
four seeded restarts, maxiter 20, noise 1e-8 -- runs four ways: on the card
and on the CPU, each through the Gram route (every objective through
gram_masked and its backward, with the per-dimension budget set to 0) and
through the per-dimension route. The script prints each fit's neg_mll and
the relative differences between them.

It then takes every objective call of the card's Gram-route fit and
evaluates the same log-hyperparameters again through all four routes. On
the card's Gram route it holds each kernel launch against its plain version
on the same inputs (the backward with the cotangent G that the objective
gives it). It prints the largest differences of the kernels, of the
objective's value and gradient between routes, and the condition numbers
of the Gram matrices there. Last, it shows how far apart the points are that the card's and
the CPU's Gram-route fits ask for, call by call.

    python tools/torch_port_fit_parity.py
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bobe_tpu_torch.models import gp as tgp  # noqa: E402
from bobe_tpu_torch.ops import kernels as tkr  # noqa: E402

N, D, MAXITER, SEED = 230, 8, 20, 16


def _data():
    rng = np.random.default_rng(SEED)
    x = rng.uniform(size=(N, D))
    y = -0.5 * np.sum(((x - 0.5) / 0.25) ** 2, axis=1)
    x0 = np.vstack([np.zeros(D + 1), rng.uniform(np.log(0.05), np.log(3.0),
                                                 size=(3, D + 1))])
    return x, y, x0


def _gp(device):
    x, y, _ = _data()
    return tgp.GP(train_x=x, train_y=y, noise=1e-8, device=device)


def run_fit(device, route):
    """The fit's neg_mll and the log-hyperparameters of each objective
    call, on ``device`` through ``route`` ("gram" or "perdim")."""
    calls = []
    neg_mll, budget = tgp.neg_mll, tgp.PERDIM_MAX_BYTES

    def recording(state, cfg, lp, dsq_perdim=None):
        calls.append(lp.detach().cpu().clone())
        return neg_mll(state, cfg, lp, dsq_perdim=dsq_perdim)

    tgp.neg_mll = recording
    tgp.PERDIM_MAX_BYTES = 0 if route == "gram" else 1 << 62
    try:
        f = -_gp(device).fit(x0=_data()[2], maxiter=MAXITER)["mll"]
    finally:
        tgp.neg_mll, tgp.PERDIM_MAX_BYTES = neg_mll, budget
    return f, calls


def value_grad(gp, lp, perdim):
    lp = lp.to(gp.state.x.device).clone().requires_grad_(True)
    dsq = tkr.sq_dist_perdim(gp.state.x) if perdim else None
    v = tgp.neg_mll(gp.state, gp.cfg, lp, dsq_perdim=dsq)
    (g,) = torch.autograd.grad(v.sum(), lp)
    return v.detach().cpu(), g.cpu()


def _rel_value(a, b):
    return float(((a - b).abs() / b.abs()).max())


def _rel_grad(a, b):
    """Per lane, the largest component difference over the largest
    component; the worst lane."""
    return float(((a - b).abs().amax(-1) / b.abs().amax(-1)).max())


def main():
    if not torch.cuda.is_available():
        print("torch_port_fit_parity: no CUDA device visible", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    fits = {(dev, route): run_fit(dev, route)
            for dev in ("cuda", "cpu") for route in ("gram", "perdim")}
    for key, (f, calls) in fits.items():
        print(f"fit {key[0]:4s} {key[1]:6s}: neg_mll {f:.12f} "
              f"({len(calls)} objective calls)")
    for a, b in ((("cuda", "gram"), ("cpu", "gram")),
                 (("cuda", "perdim"), ("cpu", "perdim")),
                 (("cuda", "gram"), ("cuda", "perdim")),
                 (("cpu", "gram"), ("cpu", "perdim"))):
        fa, fb = fits[a][0], fits[b][0]
        print(f"{a[0]} {a[1]} vs {b[0]} {b[1]}: neg_mll differs by "
              f"{fa - fb:+.3e} ({abs(fa - fb) / abs(fb):.2e} relative)")

    calls = fits[("cuda", "gram")][1]
    card, cpu = _gp("cuda"), _gp("cpu")
    routes = {"card kernels": (card, False), "card per-dimension": (card, True),
              "CPU plain Gram": (cpu, False), "CPU per-dimension": (cpu, True)}
    err = {"forward": 0.0, "backward": 0.0}
    forward_cuda = tkr._gram_masked_cuda
    backward_cuda = tkr._gram_masked_backward_cuda

    def checked_forward(name, x, mask, ls, amp, noise):
        k = forward_cuda(name, x, mask, ls, amp, noise)
        want = tkr.gram_masked_plain(name, x, mask, ls, amp, noise)
        e = (k - want).abs().amax((-2, -1)) / amp
        err["forward"] = max(err["forward"], float(e.max()))
        return k

    def checked_backward(name, x, mask, ls, amp, grad):
        got = backward_cuda(name, x, mask, ls, amp, grad)
        want = tkr.gram_masked_backward_plain(name, x, mask, ls, amp, grad)
        scale = tkr.gram_masked_backward_plain(name, x, mask, ls, amp,
                                               grad.abs())
        for k, w, sc in zip(got, want, scale):
            err["backward"] = max(err["backward"],
                                  float(((k - w).abs() / sc).max()))
        return got

    # the launches of the card's Gram route pass through these two
    tkr._gram_masked_cuda = checked_forward
    tkr._gram_masked_backward_cuda = checked_backward
    try:
        at = {name: [value_grad(gp, lp, perdim) for lp in calls]
              for name, (gp, perdim) in routes.items()}
    finally:
        tkr._gram_masked_cuda = forward_cuda
        tkr._gram_masked_backward_cuda = backward_cuda
    print(f"at the {len(calls)} objective calls of the card's Gram-route "
          "fit, each kernel against its plain version on the same inputs: "
          f"forward {err['forward']:.2e} of the amplitude, backward "
          f"{err['backward']:.2e} of sum |G dK/dtheta| (G as the fit's "
          "objective gives it)")
    for a, b in (("card kernels", "card per-dimension"),
                 ("card kernels", "CPU plain Gram"),
                 ("CPU plain Gram", "CPU per-dimension")):
        dv = max(_rel_value(p[0], q[0]) for p, q in zip(at[a], at[b]))
        dg = max(_rel_grad(p[1], q[1]) for p, q in zip(at[a], at[b]))
        print(f"  objective, {a} vs {b}: value {dv:.2e}, gradient {dg:.2e} "
              "relative (worst call)")
    conds = []
    for lp in calls:
        K = tkr.gram_masked_plain(cpu.cfg.kernel, cpu.state.x,
                                  cpu.state.mask(), torch.exp(lp[:, :D]),
                                  torch.exp(lp[:, D]), cpu.cfg.noise)
        ev = torch.linalg.eigvalsh(K)
        conds.append(ev[:, -1] / ev[:, 0])
    conds = torch.cat(conds)
    print(f"  condition number of the Gram matrix at those calls: "
          f"{float(conds.min()):.1e} to {float(conds.max()):.1e}")

    a, b = fits[("cuda", "gram")][1], fits[("cpu", "gram")][1]
    gaps = [float((p - q).abs().max()) if p.shape == q.shape else np.inf
            for p, q in zip(a, b)]
    firsts = [next((k for k, gap in enumerate(gaps) if gap > t), None)
              for t in (1e-12, 1e-8)]
    print(f"the card's and the CPU's Gram-route fits ask for points more "
          f"than 1e-12 apart first at objective call {firsts[0]}, more than "
          f"1e-8 apart at call {firsts[1]}; the largest log-hyperparameter "
          "gap at calls " + ", ".join(
              f"{k}: {gaps[k]:.1e}"
              for k in sorted(set(range(0, len(gaps), 10)) | {len(gaps) - 1})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
