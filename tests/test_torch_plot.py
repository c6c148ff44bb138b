"""The port's plotting suite (bobe_tpu_torch.utils.plot, a copy of the JAX
package's, Agg backend) on the CPU: every diagnostic writes a file, the
triangle plot overlays the training points of a port GP (torch tensors),
and the summary writes all plots. The same populated results go through the
JAX package's plotter, which writes the same set of files."""
import os

import numpy as np
import pytest
import torch

matplotlib = pytest.importorskip("matplotlib")

from bobe_tpu.utils import plot as jplot  # noqa: E402
from bobe_tpu_torch.models.gp import GP  # noqa: E402
from bobe_tpu_torch.utils import plot as tplot  # noqa: E402
from bobe_tpu_torch.utils.results import BOBEResults  # noqa: E402


@pytest.fixture()
def populated_rm(tmp_path):
    rm = BOBEResults(output_file="plotrun", save_dir=str(tmp_path),
                     param_names=["a", "b"], param_labels=["a", "b"],
                     param_bounds=np.array([[0, 1], [0, 1]]).T,
                     likelihood_name="plot_test")
    for i in range(1, 6):
        rm.update_acquisition(i, 1.0 / i, "WIPStd")
        rm.update_gp_hyperparams(i, [0.5 / i, 0.2 * i], 1.0 + i)
        rm.update_best_loglike(i, -10.0 / i)
        rm.update_convergence(i, {"mean": -1.0 - 0.1 / i, "upper": -1.0,
                                  "lower": -1.2, "var": 0.01, "std": 0.1},
                              i >= 4, 0.1)
        rm.update_kl_divergences(i, {"forward": 0.1 / i, "reverse": 0.2 / i,
                                     "symmetric": 0.15 / i})
    rng = np.random.default_rng(0)
    rm.final_samples = rng.uniform(size=(100, 2))
    rm.final_weights = np.ones(100)
    rm.final_loglikes = rng.normal(size=100)
    rm.start_timing("GP Training")
    rm.end_timing("GP Training")
    return rm


def test_every_plot_writes_a_file_as_the_jax_packages_do(populated_rm):
    paths = tplot.BOBESummaryPlotter(populated_rm).save_all_plots()
    assert len(paths) == 11, paths
    for p in paths:
        assert os.path.exists(p) and os.path.getsize(p) > 0
    names = sorted(os.path.basename(p) for p in paths)
    want = sorted(os.path.basename(p) for p in
                  jplot.BOBESummaryPlotter(populated_rm).save_all_plots())
    assert names == want


def test_stats_panel_and_summary(populated_rm):
    populated_rm.converged = True
    populated_rm.termination_reason = "LogZ converged"
    populated_rm.final_logz = {"mean": -3.2, "upper": -3.1, "lower": -3.3}
    populated_rm.gp_info = {"gp_training_set_size": 42,
                            "classifier_used": False}
    p = tplot.BOBESummaryPlotter(populated_rm).plot_stats_panel(save=True)
    assert p and os.path.exists(p)
    out = tplot.create_summary_plots(populated_rm)
    assert len(out) >= 11 and all(os.path.exists(q) for q in out)


def test_triangle_plot_overlays_a_port_gps_training_points(populated_rm,
                                                           tmp_path):
    x = np.random.default_rng(1).uniform(size=(20, 2))
    gp = GP(train_x=x, train_y=-np.sum(x ** 2, axis=1), device="cpu")
    assert isinstance(gp.train_x, torch.Tensor)
    fn = os.path.join(str(tmp_path), "tri.png")
    fig = tplot.plot_final_samples(populated_rm, gp=gp, filename=fn,
                                   show_training_points=True)
    assert os.path.exists(fn)
    n_overlay = sum(
        1 for ax in fig.axes for coll in ax.collections
        if getattr(coll, "get_offsets", None) is not None
        and len(coll.get_offsets()) == 20)
    assert n_overlay >= 1
    import matplotlib.pyplot as plt

    plt.close(fig)
