"""The comparison that decides ``correct``: what the timed path produced,
against the plain reference (reference/gp.py), once the window has closed.

The reference works every row out again: the set-up rows come from the
points the program asked the benchmark's likelihood to evaluate and from the
rows the benchmark made, each batch's rows from the batch the program chose;
each target is the benchmark's own toy at that point, and the gate's rows
are the configuration's rule on them. The program's outputs are only
judged: each fit's objective values at its hyperparameters and its gradient
at its starts, each batch's acquisition values at its points
and pools and how far each pick lies from the best of its candidates, each
MC pool's values at its samples, each evidence's values at its points and
its logZ, against the reference's and against the toy's analytic truth.

``stand_in="control"`` puts the reference computed in float32 in the
program's place, with the same rows, points and hyperparameters, and its own
choice among each pick's candidates: the numbers it gives are the control's
readings. ``stand_in="witness"`` puts the float64 reference there with its
rows in reverse order: what it reads is the roundoff that the state's
conditioning alone gives, a witness for the program's readings.

Numbers (each compared with its limit in the cell's file):

* ``fit_gap``: the largest |objective - reference| / (1 + |reference|) over
  the fits' basins;
* ``fit_grad``: the largest gap between the gradient a fit's optimizer got
  at a start (through the Gram kernels' backward in ``gauss30``) and the
  reference's by autograd, |g - g_ref| over the larger of |g_ref| and the
  fit's median |g_ref|, over the starts where the reference's Gram matrix
  factors with no jitter;
* ``acq_gap``: the largest relative gap of a batch point's WIPStd value;
* ``acq_opt``: the largest relative excess of a pick's WIPStd, as the
  reference works it out, over the best of the pick's candidates (the pool's
  points, after the rows and the earlier picks): a selection that does no
  work picks worse than the greedy choice;
* ``pool_gap``: the largest gap (nats) of an MC pool sample's value, over
  the samples the gate lets through;
* ``dead_gap``: the largest gap (nats) of an evidence point's value, over
  the points the gate lets through;
* ``logz_gap``: the largest |logZ - reference| (nats), the reference
  integrating its own values over its own volume ledger (from the gated
  start volume the program estimated);
* ``logz_truth``: the largest |logZ - the toy's analytic logZ| (nats): the
  surrogate's own error bounds it, and a wrong start volume or replacements
  drawn from the wrong constrained prior move it;
* ``ns_order``: points killed below the previous kill batch's threshold
  (exact: nested sampling never does);
* ``rows_off``: GP rows the program holds that the gate's rule does not
  give, or the other way round (exact).
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.special import erfc
from scipy.stats import chi2

from .gp import JITTER, Reference, ns_ledger, trapezoid_logz


def gate_threshold(nsigma, d):
    """The GP's rows lie within twice max(75, the chi^2 n-sigma contour's
    delta-loglike) of the best target."""
    delta = 0.5 * chi2.isf(erfc(nsigma / np.sqrt(2.0)), d)
    return 2.0 * max(75.0, float(delta))


def _stand_in(model, device, stand_in):
    """The reference that stands in for the program, and whether its rows
    are reversed."""
    if stand_in is None:
        return None, False
    if stand_in == "control":
        return Reference(model, device, torch.float32), False
    if stand_in == "witness":
        return Reference(model, device), True
    raise ValueError(f"unknown stand-in '{stand_in}'")


class Rows:
    """The rows of a state: set-up rows plus the batches chosen so far,
    their targets from the benchmark's toy, filtered by the gate's rule."""

    def __init__(self, info, model):
        self.bounds = info["bounds"]
        self.loglike = info["loglike"]
        self.minus_inf = info["minus_inf"]
        lo, hi = self.bounds
        self.x0 = (info["rows_phys"] - lo) / (hi - lo)
        self.y0 = self.evaluate(info["rows_phys"])
        self.gate = (gate_threshold(model["clf_nsigma_threshold"],
                                    self.bounds.shape[1])
                     if model.get("gated") else None)

    def evaluate(self, phys):
        out = []
        for p in np.atleast_2d(phys):
            try:
                v = float(self.loglike(p))
            except RuntimeError:
                v = self.minus_inf
            out.append(self.minus_inf if not np.isfinite(v)
                       or v < self.minus_inf else v)
        return np.asarray(out)

    def at(self, batches):
        """(x, y) after the given list of batches (unit-cube points)."""
        lo, hi = self.bounds
        xs, ys = [self.x0], [self.y0]
        for b in batches:
            b = np.atleast_2d(b)
            xs.append(b)
            ys.append(self.evaluate(b * (hi - lo) + lo))
        x, y = np.vstack(xs), np.concatenate(ys)
        if self.gate is not None:
            keep = y > y.max() - self.gate
            x, y = x[keep], y[keep]
        return x, y


def _max(values):
    values = [float(v) for v in values]
    if any(not np.isfinite(v) for v in values):
        return float("inf")
    return max(values) if values else 0.0


def _rows(x, y, reverse):
    return (x[::-1].copy(), y[::-1].copy()) if reverse else (x, y)


def _host(lp):
    """Log hyperparameters on the host, of a record's pair of device
    tensors (log lengthscales, log amplitude) or of an array."""
    if isinstance(lp, tuple):
        return np.concatenate([lp[0].detach().cpu().numpy().reshape(-1),
                               [float(lp[1])]])
    return np.asarray(lp, dtype=np.float64)


def _fit_numbers(ref, low, rev, x, y, f):
    """(fit_gap readings, fit_grad readings) of one fit's record."""
    gaps = []
    for params, value in f["basins"]:
        r = ref.neg_mll(x, y, params)
        if low is not None:
            value = low.neg_mll(*_rows(x, y, rev), params)
        gaps.append(abs(value - r) / (1.0 + abs(r)))
    starts = f["starts"]["x"].detach().cpu().numpy()
    got = f["starts"]["grad"].detach().cpu().numpy()
    refs = [ref.gradient(x, y, p) for p in starts]
    if low is not None:
        got = [low.gradient(*_rows(x, y, rev), p, JITTER) for p in starts]
    norms = [np.linalg.norm(g) for g in refs if g is not None]
    scale = float(np.median(norms)) if norms else 0.0
    grads = []
    for g, r in zip(got, refs):
        if r is None:
            continue
        if g is None or not np.all(np.isfinite(g)):
            grads.append(float("inf"))
            continue
        grads.append(np.linalg.norm(g - r) / max(np.linalg.norm(r), scale))
    return gaps, grads


def _acq_opt(ref, low, rev, x, y, lp, picks, mc_sets, values):
    """Each pick's relative excess over the best of its candidates."""
    fused = len(mc_sets) == 1
    out = []
    for j, (z, sd) in enumerate(ref.wip_steps(x, y, lp, picks, fused)):
        pool = mc_sets[0 if fused else j]
        cand = ref.wip_candidates(z, sd, lp, pool)
        if low is None:
            v = values[j]
        else:
            zs = z[::-1].copy() if rev else z
            v = cand[int(np.argmin(low.wip_candidates(zs, sd, lp, pool)))]
        best = float(np.min(cand))
        out.append(max(0.0, float(v) - best) / best)
    return out


def judge_loop(run, model, device, stand_in=None):
    """The loop cell's numbers from its kept records."""
    ref = Reference(model, device)
    low, rev = _stand_in(model, device, stand_in)
    rows = Rows(run["info"], model)
    fit, grad, acq, opt, pool, off = [], [], [], [], [], 0
    floor = 0.5 * run["info"]["minus_inf"]
    for rec in [run["setup_rec"]] + run["records"]:
        picks = {a["k"]: a["picks"] for a in rec["acq"]}
        upto = lambda j: rows.at([picks[k] for k in range(1, j + 1)])
        for f in rec["fit"]:
            x, y = upto(f["rows_upto"])
            gaps, g = _fit_numbers(ref, low, rev, x, y, f)
            fit += gaps
            grad += g
        for a in rec["acq"]:
            x, y = upto(a["k"] - 1)
            off += abs(a["gp_size"] - x.shape[0])
            lp = _host(a["log_params"])
            r = ref.wipstd(x, y, lp, a["picks"], a["mc_sets"])
            vals = a["vals"] if low is None else low.wipstd(
                *_rows(x, y, rev), lp, a["picks"], a["mc_sets"])
            acq.append(np.max(np.abs(vals - r) / np.abs(r)))
            opt += _acq_opt(ref, low, rev, x, y, lp, a["picks"],
                            a["mc_sets"], r)
        for p in rec["pool"]:
            logp = np.asarray(p["logp"])
            ok = logp > floor
            if not np.any(ok):
                continue
            x, y = upto(p["rows_upto"])
            q = np.asarray(p["x"])[ok]
            lp = _host(p["log_params"])
            r = ref.mean(x, y, lp, q)
            vals = logp[ok] if low is None else low.mean(
                *_rows(x, y, rev), lp, q)
            pool.append(np.max(np.abs(vals - r)))
    return {"fit_gap": _max(fit), "fit_grad": _max(grad),
            "acq_gap": _max(acq), "acq_opt": _max(opt),
            "pool_gap": _max(pool), "rows_off": float(off)}


def _order_violations(logl, nlive, kill_frac):
    k = max(1, int(round(nlive * kill_frac)))
    n_dead = len(logl) - nlive
    batches = np.asarray(logl[:n_dead]).reshape(-1, k)
    bad = 0
    for b in range(1, batches.shape[0]):
        bad += int(np.sum(batches[b] < batches[b - 1].max()))
    bad += int(np.sum(np.asarray(logl[n_dead:]) < batches[-1].max())) \
        if batches.shape[0] else 0
    return bad


def judge_evidence(run, model, device, ns, stand_in=None):
    """The evidence cell's numbers from its kept evidences."""
    ref = Reference(model, device)
    low, rev = _stand_in(model, device, stand_in)
    rows = Rows(run["info"], model)
    x, y = rows.at([])
    xs, ys = _rows(x, y, rev)
    lp = run["log_params"]
    fit = []
    for params, value in run["setup_rec"]["fit"][0]["basins"]:
        r = ref.neg_mll(x, y, params)
        if low is not None:
            value = low.neg_mll(xs, ys, params)
        fit.append(abs(value - r) / (1.0 + abs(r)))
    floor = 0.5 * run["info"]["minus_inf"]
    dead, logz, truth, order = [], [], [], 0
    for ev in run["records"]:
        logl = np.asarray(ev["logl"])
        ok = logl > floor
        r = np.full(logl.shape, run["info"]["minus_inf"])
        r[ok] = ref.mean(x, y, lp, ev["x"][ok])
        vals = logl.copy()
        if low is not None:
            vals[ok] = low.mean(xs, ys, lp, ev["x"][ok])
        dead.append(np.max(np.abs(vals[ok] - r[ok])) if np.any(ok) else 0.0)
        lv = ns_ledger(len(logl), ns["nlive"], ns["kill_frac"], ev["logvol0"])
        z_ref = trapezoid_logz(r, lv, ev["logvol0"])
        dt = np.float32 if stand_in == "control" else np.float64
        z = ev["logz"] if low is None else trapezoid_logz(
            vals.astype(dt), lv.astype(dt), dt(ev["logvol0"]))
        logz.append(abs(z - z_ref))
        truth.append(abs(z - run["info"]["logz_true"]))
        order += _order_violations(vals, ns["nlive"], ns["kill_frac"])
    return {"fit_gap": _max(fit), "dead_gap": _max(dead),
            "logz_gap": _max(logz), "logz_truth": _max(truth),
            "ns_order": float(order),
            "rows_off": float(abs(run["gp_size"] - x.shape[0]))}
