"""The plain reference: a Gaussian-process surrogate written out in plain
PyTorch, in the precision it is given.

It follows the model the configurations state (an RBF kernel with ARD
lengthscales, an amplitude on standardized targets, a fixed noise on the
diagonal, the lengthscale and amplitude priors) and nothing of the program:
no padded buffers, no Gram kernel, no incremental factor, no jitter ladder of
the program's. Distances are exact differences, each solve comes from one
Cholesky factor of the whole matrix, and every quantity is worked out again
from the rows it is given.

The same code in float32, with TF32 off, is the control: the step below the
program's float64 that a later change might be tempted to take.
"""
from __future__ import annotations

import math

import numpy as np
import torch

LOG_2PI = math.log(2.0 * math.pi)
# variances below this floor are clipped to it, as the model states
VAR_FLOOR = 1e-12
# relative jitter tried, in order, when a factorization fails (the
# reference's own ladder; in float64 the first rung succeeds)
JITTER = (0.0, 1e-10, 1e-8, 1e-6, 1e-4, 1e-2)


class Reference:
    """GP arithmetic on ``device`` in ``dtype`` (float64 is the reference,
    float32 the control)."""

    def __init__(self, model: dict, device, dtype=torch.float64):
        self.model = model
        self.device = torch.device(device)
        self.dtype = dtype
        self.noise = float(model["noise"])
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def t(self, a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64),
                               device=self.device).to(self.dtype)

    # ------------------------------------------------------------ algebra

    @staticmethod
    def standardize(y):
        """Mean and population standard deviation (1 where it is 0)."""
        y = np.asarray(y, dtype=np.float64)
        std = float(np.std(y))
        return float(np.mean(y)), (std if std > 0.0 else 1.0)

    def cross(self, a, b, ls, amp, chunk=2048):
        """amp exp(-|a - b|^2_ls / 2), exact differences, rows in chunks."""
        a, b = a / ls, b / ls
        out = []
        for i in range(0, a.shape[0], chunk):
            diff = a[i:i + chunk, None, :] - b[None, :, :]
            out.append(amp * torch.exp(-0.5 * torch.sum(diff * diff, -1)))
        return torch.cat(out)

    def factor(self, x, ls, amp, rungs=JITTER):
        """Lower Cholesky factor of K(x, x) + noise I (with the first rung
        of relative jitter at which it factors)."""
        k = self.cross(x, x, ls, amp)
        eye = torch.eye(x.shape[0], dtype=self.dtype, device=self.device)
        k = k + self.noise * eye
        for rung in rungs:
            L, info = torch.linalg.cholesky_ex(k + rung * amp * eye)
            if int(info) == 0:
                return L
        raise np.linalg.LinAlgError("reference: Gram matrix not positive "
                                    "definite at any jitter")

    def _hyper(self, log_params, d):
        lp = self.t(log_params)
        return torch.exp(lp[:d]), torch.exp(lp[d])

    # ------------------------------------------------------------- model

    def log_prior(self, ls, amp, d):
        """Log hyperprior (a tensor, differentiable in ls): DSLP
        LogNormal(sqrt2 + log(d)/2, sqrt3) or uniform on the lengthscales,
        uniform on the amplitude."""
        m = self.model
        lo, hi = m["kernel_variance_bounds"]
        a = float(amp.detach())
        lp = -math.log(hi - lo) if lo <= a <= hi else -math.inf
        if m.get("lengthscale_prior") == "DSLP":
            loc, s = math.sqrt(2.0) + 0.5 * math.log(d), math.sqrt(3.0)
            lx = torch.log(ls)
            return lp + torch.sum(
                -lx - math.log(s) - 0.5 * LOG_2PI
                - 0.5 * ((lx - loc) / s) ** 2)
        lo, hi = m["lengthscale_bounds"]
        inside = bool(torch.all((ls >= lo) & (ls <= hi)))
        return lp + (-d * math.log(hi - lo) if inside else -math.inf) \
            + 0.0 * torch.sum(ls)

    def _objective(self, xt, ys, lp, rungs=JITTER):
        """The objective as a tensor of the log hyperparameters ``lp``."""
        d = xt.shape[1]
        ls, amp = torch.exp(lp[:d]), torch.exp(lp[d])
        L = self.factor(xt, ls, amp, rungs)
        v = torch.linalg.solve_triangular(L, ys[:, None], upper=False)[:, 0]
        mll = (-0.5 * torch.dot(v, v)
               - torch.sum(torch.log(torch.diagonal(L)))
               - 0.5 * xt.shape[0] * LOG_2PI)
        return -(mll + self.log_prior(ls, amp, d))

    def _standardized(self, x, y):
        mu, sd = self.standardize(y)
        return self.t(x), self.t((np.asarray(y) - mu) / sd)

    def neg_mll(self, x, y, log_params):
        """Negative (log marginal likelihood + log hyperprior) of the rows
        (x, y) at the log hyperparameters [log ls (d), log amp]."""
        xt, ys = self._standardized(x, y)
        return float(self._objective(xt, ys, self.t(log_params)))

    def gradient(self, x, y, log_params, rungs=(0.0,)):
        """The objective's gradient in the log hyperparameters, by autograd;
        None where the Gram matrix factors at none of ``rungs`` of jitter
        (by default none: the objective with jitter is the jitter's, not the
        model's)."""
        xt, ys = self._standardized(x, y)
        lp = self.t(log_params).requires_grad_(True)
        try:
            with torch.enable_grad():
                f = self._objective(xt, ys, lp, rungs)
                (g,) = torch.autograd.grad(f, lp)
        except np.linalg.LinAlgError:
            return None
        g = g.double().cpu().numpy()
        return g if np.all(np.isfinite(g)) else None

    def mean(self, x, y, log_params, q, chunk=16384):
        """Posterior mean of the rows (x, y) at the points q, on the
        targets' scale."""
        d = x.shape[1]
        ls, amp = self._hyper(log_params, d)
        mu, sd = self.standardize(y)
        ys = self.t((np.asarray(y) - mu) / sd)
        xt = self.t(x)
        L = self.factor(xt, ls, amp)
        alpha = torch.cholesky_solve(ys[:, None], L)[:, 0]
        qt = self.t(q)
        out = [self.cross(qt[i:i + chunk], xt, ls, amp) @ alpha
               for i in range(0, qt.shape[0], chunk)]
        m = torch.cat(out) if out else torch.zeros(0, dtype=self.dtype,
                                                  device=self.device)
        return (m * sd + mu).double().cpu().numpy()

    def wip_candidates(self, z, sd, log_params, pool):
        """WIPStd after the rows ``z`` and one more, for each point of the
        pool as that one: the mean over the pool of the posterior standard
        deviation (noisy, floored), times ``sd``. The selection's candidates
        are the pool's points."""
        ls, amp = self._hyper(log_params, z.shape[1])
        zt, pt = self.t(z), self.t(pool)
        L = self.factor(zt, ls, amp)
        v = torch.linalg.solve_triangular(L, self.cross(zt, pt, ls, amp),
                                          upper=False)
        var = amp + self.noise - torch.sum(v * v, 0)
        cov = self.cross(pt, pt, ls, amp) - v.T @ v
        after = var[None, :] - cov * cov / torch.clamp(var, min=VAR_FLOOR)[:, None]
        vals = torch.mean(torch.sqrt(torch.clamp(after, min=VAR_FLOOR)), 1)
        return (vals * sd).double().cpu().numpy()

    def wip_steps(self, x, y, log_params, picks, fused):
        """The rows and the targets' standard deviation that each pick of a
        greedy batch is chosen after: the rows and the earlier picks (fused
        selection), or the rows and the earlier picks with the posterior
        mean as their targets (selection by hallucination)."""
        picks = np.atleast_2d(np.asarray(picks, dtype=np.float64))
        if fused:
            _, sd = self.standardize(y)
            return [(np.vstack([x, picks[:k]]), sd)
                    for k in range(picks.shape[0])]
        xs, ys, out = np.asarray(x, np.float64), np.asarray(y, np.float64), []
        for k in range(picks.shape[0]):
            out.append((xs, self.standardize(ys)[1]))
            mu_k = self.mean(xs, ys, log_params, picks[k:k + 1])[0]
            xs, ys = np.vstack([xs, picks[k:k + 1]]), np.append(ys, mu_k)
        return out

    def wipstd(self, x, y, log_params, picks, mc_sets):
        """WIPStd of each point of a greedy batch: for pick k the mean over
        its pool of the posterior standard deviation (noisy, floored) after
        the rows and picks 1..k are observed, times the targets' standard
        deviation. One pool for the batch is the fused selection (targets'
        scale from the rows); one pool per pick is the selection by
        hallucination (each pick joins the rows with the posterior mean
        there as its target, which moves the targets' scale)."""
        d = x.shape[1]
        ls, amp = self._hyper(log_params, d)
        picks = np.atleast_2d(np.asarray(picks, dtype=np.float64))
        out = []
        if len(mc_sets) == 1:
            _, sd = self.standardize(y)
            z = self.t(np.vstack([x, picks]))
            L = self.factor(z, ls, amp)
            v = torch.linalg.solve_triangular(
                L, self.cross(z, self.t(mc_sets[0]), ls, amp), upper=False)
            cum = torch.cumsum(v * v, dim=0)
            n = x.shape[0]
            for k in range(picks.shape[0]):
                var = torch.clamp(amp + self.noise - cum[n + k], min=VAR_FLOOR)
                out.append(float(torch.mean(torch.sqrt(var))) * sd)
            return np.asarray(out)
        xs, ys = np.asarray(x, dtype=np.float64), np.asarray(y, np.float64)
        for k in range(picks.shape[0]):
            _, sd = self.standardize(ys)
            z = self.t(np.vstack([xs, picks[k:k + 1]]))
            L = self.factor(z, ls, amp)
            v = torch.linalg.solve_triangular(
                L, self.cross(z, self.t(mc_sets[k]), ls, amp), upper=False)
            var = torch.clamp(amp + self.noise - torch.sum(v * v, 0),
                              min=VAR_FLOOR)
            out.append(float(torch.mean(torch.sqrt(var))) * sd)
            mu_k = self.mean(xs, ys, log_params, picks[k:k + 1])[0]
            xs, ys = np.vstack([xs, picks[k:k + 1]]), np.append(ys, mu_k)
        return np.asarray(out)


# ------------------------------------------------------------ nested sampling

def ns_ledger(n_points, nlive, kill_frac, logvol0):
    """Log prior volumes of a static nested-sampling run's points: kill
    batches of K = round(nlive kill_frac) whose i-th point shrinks the volume
    by 1 / (nlive - i), then the final live set, ascending, splitting what is
    left uniformly."""
    k = max(1, int(round(nlive * kill_frac)))
    n_dead = n_points - nlive
    if n_dead < 0 or n_dead % k:
        raise ValueError(f"{n_points} points are not whole kill batches of "
                         f"{k} and {nlive} live points")
    hs = np.cumsum(1.0 / (nlive - np.arange(k)))
    batches = n_dead // k
    dead = (logvol0 - hs[-1] * np.arange(batches)[:, None]
            - hs[None, :]).reshape(-1)
    end = logvol0 - hs[-1] * batches
    frac = (nlive - np.arange(1, nlive + 1)) / nlive
    return np.concatenate([dead, end + np.log(np.clip(frac, 1e-300, None))])


def trapezoid_logz(logl, logvol, lv_start):
    """log of sum_i (L_i + L_{i-1}) / 2 (X_{i-1} - X_i), X_{-1} = e^lv_start,
    L_{-1} = 0."""
    logl = np.asarray(logl, dtype=np.float64)
    lv_prev = np.concatenate([[lv_start], logvol[:-1]])
    logdx = lv_prev + np.log1p(-np.exp(np.minimum(logvol - lv_prev, -1e-300)))
    l_prev = np.concatenate([[-np.inf], logl[:-1]])
    terms = np.logaddexp(logl, l_prev) + logdx + np.log(0.5)
    top = np.max(terms)
    return float(top + np.log(np.sum(np.exp(terms - top))))
