"""Diagnostic plotting suite.

Copied from bobe_tpu/utils/plot.py (numpy and matplotlib; no jax): evidence
evolution, lengthscales, kernel variance, best log-likelihood, acquisition
values, timing breakdown, convergence deltas, successive KL, parameter
evolution, a summary dashboard, and a final-samples triangle plot, read from
a ``BOBEResults`` and, for the training-point overlay, a GP of either
package (torch tensors are brought to the host). matplotlib is imported
lazily, so the port runs where it is not installed (such as a card's host,
where the plots are not made); getdist is optional (the triangle plot falls
back to a plain matplotlib corner plot when it is absent).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .log import get_logger

log = get_logger("plot")


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_final_samples(results_manager, gp=None, filename: Optional[str] = None,
                       show_training_points: bool = True):
    """Triangle plot of the posterior samples (+ GP training points).

    Uses getdist when available, else a matplotlib
    corner fallback.
    """
    plt = _plt()
    rm = results_manager
    if rm.final_samples is None or not len(rm.final_samples):
        log.warning("No final samples to plot")
        return None
    names = rm.param_names
    d = len(names)
    samples, weights = rm.final_samples, rm.final_weights

    axes2d = None  # (d, d) lower-triangle axes for the training-point overlay
    try:
        from getdist import plots

        mcs = rm.get_mcsamples()
        g = plots.get_subplot_plotter(subplot_size=2.0)
        g.triangle_plot([mcs], filled=True)
        fig = g.fig
        axes2d = np.asarray(g.subplots, dtype=object)  # None above diagonal
    except ImportError:
        fig, axes = plt.subplots(d, d, figsize=(2.2 * d, 2.2 * d))
        axes = np.atleast_2d(axes)
        for i in range(d):
            for j in range(d):
                ax = axes[i, j]
                if j > i:
                    ax.axis("off")
                    continue
                if i == j:
                    ax.hist(samples[:, i], bins=40, weights=weights,
                            density=True, color="#4477AA")
                else:
                    ax.hist2d(samples[:, j], samples[:, i], bins=50,
                              weights=weights, cmap="Blues")
                if i == d - 1:
                    ax.set_xlabel(names[j])
                if j == 0:
                    ax.set_ylabel(names[i])
        fig.tight_layout()
        axes2d = axes

    if (show_training_points and gp is not None
            and rm.param_bounds is not None and axes2d is not None):
        # overlay the GP training points on every off-diagonal panel
        from .core import scale_from_unit

        train_x = gp.train_x
        if hasattr(train_x, "detach"):  # a torch tensor, maybe on the card
            train_x = train_x.detach().cpu().numpy()
        pts = scale_from_unit(np.asarray(train_x), rm.param_bounds)
        for i in range(d):
            for j in range(i):
                ax = axes2d[i][j]
                if ax is not None:
                    ax.scatter(pts[:, j], pts[:, i], s=4, c="red", alpha=0.6,
                               zorder=10)

    if filename:
        fig.savefig(filename, bbox_inches="tight", dpi=120)
        plt.close(fig)
    return fig




class BOBESummaryPlotter:
    """Per-diagnostic plots from a BOBEResults instance."""

    def __init__(self, results_manager, save_dir: Optional[str] = None):
        self.rm = results_manager
        self.save_dir = save_dir or results_manager.save_dir

    def _finish(self, fig, name, save):
        plt = _plt()
        if save:
            path = os.path.join(self.save_dir,
                                f"{self.rm.output_file}_{name}.png")
            fig.savefig(path, bbox_inches="tight", dpi=120)
            plt.close(fig)
            return path
        return fig

    def plot_evidence_evolution(self, save=True):
        plt = _plt()
        ev = self.rm.logz_evolution
        if not ev:
            return None
        fig, ax = plt.subplots(figsize=(7, 4.5))
        it = [e["iteration"] for e in ev]
        mean = np.array([e["mean"] for e in ev])
        up = np.array([e["upper"] for e in ev])
        lo = np.array([e["lower"] for e in ev])
        ax.plot(it, mean, "-o", ms=3, label="logZ")
        ax.fill_between(it, lo, up, alpha=0.3, label="GP bounds")
        ax.set_xlabel("Iteration")
        ax.set_ylabel("logZ")
        ax.legend()
        return self._finish(fig, "evidence", save)

    def plot_lengthscales(self, save=True):
        plt = _plt()
        hist = self.rm.gp_hyperparams_history
        if not hist:
            return None
        fig, ax = plt.subplots(figsize=(7, 4.5))
        its = [h["iteration"] for h in hist]
        ls = np.array([h["lengthscales"] for h in hist])
        for j in range(ls.shape[1]):
            name = (self.rm.param_names[j]
                    if j < len(self.rm.param_names) else f"x_{j}")
            ax.plot(its, ls[:, j], label=name)
        ax.set_yscale("log")
        ax.set_xlabel("Iteration")
        ax.set_ylabel("Lengthscale")
        ax.legend(fontsize=7)
        return self._finish(fig, "lengthscales", save)

    def plot_kernel_variance(self, save=True):
        plt = _plt()
        hist = self.rm.gp_hyperparams_history
        if not hist:
            return None
        fig, ax = plt.subplots(figsize=(7, 4.5))
        ax.plot([h["iteration"] for h in hist],
                [h["kernel_variance"] for h in hist], "-o", ms=3)
        ax.set_yscale("log")
        ax.set_xlabel("Iteration")
        ax.set_ylabel("Kernel variance")
        return self._finish(fig, "kernel_variance", save)

    def plot_best_loglike(self, save=True):
        plt = _plt()
        if not self.rm.best_loglike_values:
            return None
        fig, ax = plt.subplots(figsize=(7, 4.5))
        ax.plot(self.rm.best_loglike_iterations, self.rm.best_loglike_values,
                "-o", ms=3)
        ax.set_xlabel("Iteration")
        ax.set_ylabel("Best log-likelihood")
        return self._finish(fig, "best_loglike", save)

    def plot_acquisition(self, save=True):
        plt = _plt()
        acq = self.rm.get_acquisition_data()
        if not acq["values"]:
            return None
        fig, ax = plt.subplots(figsize=(7, 4.5))
        ax.plot(acq["iterations"], acq["values"], "-o", ms=3)
        ax.set_yscale("log")
        ax.set_xlabel("Iteration")
        ax.set_ylabel("Acquisition value")
        return self._finish(fig, "acquisition", save)

    def plot_timing_breakdown(self, save=True):
        plt = _plt()
        t = self.rm.get_timing_summary()
        phases = {k: v for k, v in t["phase_times"].items() if v > 0}
        if not phases:
            return None
        fig, ax = plt.subplots(figsize=(7, 4.5))
        ax.barh(list(phases.keys()), list(phases.values()), color="#4477AA")
        ax.set_xlabel("Wall time (s)")
        return self._finish(fig, "timing", save)

    def plot_convergence(self, save=True):
        plt = _plt()
        hist = self.rm.convergence_history
        if not hist:
            return None
        fig, ax = plt.subplots(figsize=(7, 4.5))
        ax.plot([c.iteration for c in hist], [c.delta for c in hist], "-o",
                ms=3, label="delta")
        ax.axhline(hist[-1].threshold, ls="--", c="k", label="threshold")
        ax.set_yscale("log")
        ax.set_xlabel("Iteration")
        ax.set_ylabel("(upper - lower)/2")
        ax.legend()
        return self._finish(fig, "convergence", save)

    def plot_kl_divergence(self, save=True):
        plt = _plt()
        if not self.rm.kl_history:
            return None
        fig, ax = plt.subplots(figsize=(7, 4.5))
        ax.plot([k["iteration"] for k in self.rm.kl_history],
                [k.get("symmetric", np.nan) for k in self.rm.kl_history],
                "-o", ms=3)
        ax.set_yscale("log")
        ax.set_xlabel("Iteration")
        ax.set_ylabel("Successive KL (symmetric)")
        return self._finish(fig, "kl", save)

    def plot_parameter_evolution(self, save=True):
        plt = _plt()
        if self.rm.final_samples is None:
            return None
        d = self.rm.final_samples.shape[1]
        fig, axes = plt.subplots(d, 1, figsize=(7, 1.6 * d), sharex=True)
        axes = np.atleast_1d(axes)
        for j in range(d):
            axes[j].plot(self.rm.final_samples[:, j], lw=0.3)
            axes[j].set_ylabel(self.rm.param_names[j]
                               if j < len(self.rm.param_names) else f"x_{j}")
        axes[-1].set_xlabel("Sample index")
        return self._finish(fig, "params", save)

    def plot_dashboard(self, save=True):
        plt = _plt()
        fig, axes = plt.subplots(2, 3, figsize=(16, 9))
        # evidence
        ev = self.rm.logz_evolution
        if ev:
            it = [e["iteration"] for e in ev]
            axes[0, 0].plot(it, [e["mean"] for e in ev], "-o", ms=3)
            axes[0, 0].fill_between(it, [e["lower"] for e in ev],
                                    [e["upper"] for e in ev], alpha=0.3)
        axes[0, 0].set_title("logZ evolution")
        if self.rm.best_loglike_values:
            axes[0, 1].plot(self.rm.best_loglike_iterations,
                            self.rm.best_loglike_values, "-o", ms=3)
        axes[0, 1].set_title("Best loglike")
        acq = self.rm.get_acquisition_data()
        if acq["values"]:
            axes[0, 2].semilogy(acq["iterations"], acq["values"], "-o", ms=3)
        axes[0, 2].set_title("Acquisition")
        hist = self.rm.gp_hyperparams_history
        if hist:
            ls = np.array([h["lengthscales"] for h in hist])
            for j in range(ls.shape[1]):
                axes[1, 0].semilogy([h["iteration"] for h in hist], ls[:, j])
        axes[1, 0].set_title("Lengthscales")
        t = self.rm.get_timing_summary()
        phases = {k: v for k, v in t["phase_times"].items() if v > 0}
        if phases:
            axes[1, 1].barh(list(phases.keys()), list(phases.values()))
        axes[1, 1].set_title("Timing")
        conv = self.rm.convergence_history
        if conv:
            axes[1, 2].semilogy([c.iteration for c in conv],
                                [c.delta for c in conv], "-o", ms=3)
        axes[1, 2].set_title("Convergence delta")
        fig.suptitle(f"{self.rm.likelihood_name} — "
                     f"{'converged' if self.rm.converged else 'not converged'}")
        fig.tight_layout()
        return self._finish(fig, "dashboard", save)

    def plot_stats_panel(self, save=True):
        """Key run statistics as a text panel."""
        plt = _plt()
        rm = self.rm
        lines = [f"Likelihood: {rm.likelihood_name}",
                 f"Dimensions: {len(rm.param_names)}D"]
        gp_info = getattr(rm, "gp_info", {}) or {}
        gp_size = gp_info.get("gp_training_set_size", "N/A")
        lines.append(f"GP size: {gp_size}")
        if gp_info.get("classifier_used"):
            lines.append(f"Classifier: {gp_info.get('classifier_type', '?')}")
            total = gp_info.get("classifier_training_set_size", "N/A")
        else:
            lines.append("Classifier: No")
            total = gp_size
        lines.append(f"Total evaluations: {total}")
        logz = getattr(rm, "final_logz", None) or {}
        mean = logz.get("mean")
        if mean is not None and np.isfinite(mean):
            err = logz.get("std")
            if err is None and "upper" in logz and "lower" in logz:
                err = (logz["upper"] - logz["lower"]) / 2.0
            lines.append(f"log Z = {mean:.4f}"
                         + (f" ± {err:.4f}" if err is not None else ""))
        t = self.rm.get_timing_summary()
        total_rt = t.get("total_runtime", 0.0)
        if total_rt > 0:
            rt = (f"{total_rt / 3600:.2f} h" if total_rt > 3600
                  else f"{total_rt:.1f} s")
            lines.append(f"Runtime: {rt}")
        lines.append(f"Converged: {'Yes' if rm.converged else 'No'}")
        lines.append(f"Termination: {rm.termination_reason}")
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.text(0.08, 0.95, "\n".join(lines), transform=ax.transAxes,
                fontsize=11, verticalalignment="top", family="monospace",
                bbox=dict(boxstyle="round,pad=0.4", facecolor="#EAF2FA"))
        ax.axis("off")
        ax.set_title("Run summary")
        return self._finish(fig, "stats", save)

    def save_all_plots(self):
        out = []
        for fn in (self.plot_evidence_evolution, self.plot_lengthscales,
                   self.plot_kernel_variance, self.plot_best_loglike,
                   self.plot_acquisition, self.plot_timing_breakdown,
                   self.plot_convergence, self.plot_kl_divergence,
                   self.plot_parameter_evolution, self.plot_stats_panel,
                   self.plot_dashboard):
            try:
                p = fn(save=True)
                if p:
                    out.append(p)
            except Exception as e:  # pragma: no cover
                log.warning(f"plot {fn.__name__} failed: {e}")
        log.info(f"Saved {len(out)} diagnostic plots to {self.save_dir}")
        return out


def create_summary_plots(results_manager, gp=None, save_dir=None):
    """Convenience: all diagnostics + final triangle."""
    plotter = BOBESummaryPlotter(results_manager, save_dir=save_dir)
    paths = plotter.save_all_plots()
    try:
        fname = os.path.join(plotter.save_dir,
                             f"{results_manager.output_file}_samples.png")
        p = plot_final_samples(results_manager, gp=gp, filename=fname)
        if p is not None:
            paths.append(fname)
    except Exception as e:  # pragma: no cover
        log.warning(f"triangle plot failed: {e}")
    return paths
