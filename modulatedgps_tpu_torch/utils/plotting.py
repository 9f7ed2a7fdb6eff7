"""Figure builders reproducing the reference demo panels.

A copy of modulatedgps_tpu/utils/plotting.py:21-203 (importing that one
imports jax).  The figure builders take numpy arrays.  The SVGP helpers
take a port SVGP (on any device) and, for draws, a ``torch.Generator`` on
its device in place of a JAX key.  matplotlib is imported when a figure is
built, with the Agg backend (files, no display).

Four-panel layout parity (reference demos/demo_tf2.py:77-110):
  [0,0] mixture sample scatter over the test inputs + train data
  [0,1] ELBO vs iteration
  [1,0] softmax assignment probabilities
  [1,1] per-expert predictive bands (mean ± 2 std)
Plus the SVGP diagnostic helpers (reference utils/plotting_utils.py:7-36).
"""
from __future__ import annotations

import numpy as np

__all__ = ["four_panel_figure", "two_figure_2d", "plot_kernel_samples",
           "plot_kernel_prediction", "plot_kernel", "pyplot"]

_TAB = ["tab:blue", "tab:orange", "tab:green", "tab:red", "tab:purple",
        "tab:brown", "tab:pink", "tab:gray", "tab:olive", "tab:cyan"]


def pyplot():
    """matplotlib.pyplot on the Agg backend."""
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib import pyplot
    return pyplot


def four_panel_figure(Xtrain, Ytrain, Xplot, samples_y, samples_f,
                      iters, elbos, assign_X, assign_probs,
                      pred_X, fmean, fvar, K: int):
    """Build the canonical 4-panel demo figure; returns the matplotlib fig.

    samples_y/samples_f: [S, Nplot, 1]; fmean/fvar: [Nplot, K];
    assign_probs: [N, K].
    """
    plt = pyplot()

    S = samples_y.shape[0]
    f, ax = plt.subplots(2, 2, figsize=(14, 8))

    Xt = np.tile(Xplot[:, :1], (S, 1))
    ax[0, 0].scatter(Xt.ravel(), np.reshape(samples_y, (-1,)), marker="+",
                     alpha=0.01, color="tab:red")
    ax[0, 0].scatter(Xt.ravel(), np.reshape(samples_f, (-1,)), marker="+",
                     alpha=0.01, color="tab:blue")
    ax[0, 0].scatter(Xtrain[:, 0], Ytrain, marker="x", color="black", alpha=0.1)
    ax[0, 0].set_title("Many GPs")
    ax[0, 0].set_xlabel("x")
    ax[0, 0].set_ylabel("y")
    ax[0, 0].set_ylim(1.2 * float(np.min(Ytrain)), 1.2 * float(np.max(Ytrain)))
    ax[0, 0].grid()

    ax[0, 1].plot(iters, elbos, "o-", ms=8, alpha=0.5)
    ax[0, 1].set_xlabel("Iterations")
    ax[0, 1].set_ylabel("ELBO")
    ax[0, 1].grid()

    ax[1, 0].plot(assign_X[:, 0], assign_probs, "o")
    ax[1, 0].set_xlabel("x")
    ax[1, 0].set_ylabel("softmax(assignment)")
    ax[1, 0].grid()

    lb = fmean - 2.0 * np.sqrt(fvar)
    ub = fmean + 2.0 * np.sqrt(fvar)
    for i in range(K):
        c = _TAB[i % len(_TAB)]
        ax[1, 1].plot(pred_X[:, 0], fmean[:, i], "-", alpha=1.0, color=c)
        ax[1, 1].fill_between(pred_X[:, 0], lb[:, i], ub[:, i], alpha=0.3, color=c)
    ax[1, 1].scatter(Xtrain[:, 0], Ytrain, marker="x", color="black", alpha=0.5)
    ax[1, 1].set_xlabel("x")
    ax[1, 1].set_ylabel("Pred. of GP experts")
    ax[1, 1].grid()

    f.tight_layout()
    return f


def two_figure_2d(Xtrain, Ytrain, Xplot, samples_y, samples_f, iters, elbos,
                  assign_probs_plot, fmean_plot, slices, K: int,
                  axis_labels=("x1", "x2")):
    """The reference's shared 2-D demo layout — returns (fig_3d, fig).

    Panel parity with reference demos/demo_tf2_2d.py:77-178 and the two
    dedicated John Doe figures (demos/demo_john_doe.py:82-184,
    demo_john_doe_multi_class.py:84-186):

    fig_3d, 2x2 3-D: [0] raw train data; [1] mixture y- (red) and f- (blue)
    samples over Xplot + train scatter; [2] per-expert assignment
    probabilities; [3] per-expert predictive means.
    fig, 2x3 flat: [0] ELBO; [1,2] assignment softmax along each axis with
    the other coordinate held constant; [3,4] per-expert predictive bands
    (mean +/- 2 std) along the same slices + train scatter.

    samples_y/samples_f: [S, Nplot, 1] or None (skip the sample panel);
    slices: two tuples (Xs [L,2], coord_index, const_value,
    assign [L,K], fmean [L,K], fvar [L,K]).
    """
    plt = pyplot()

    la, lb_ = axis_labels
    fig_3d = plt.figure(figsize=(14, 8))
    ax3 = [fig_3d.add_subplot(2, 2, i, projection="3d") for i in range(1, 5)]

    def label3(a):
        a.set_xlabel(la)
        a.set_ylabel(lb_)
        a.set_zlabel("y")
        a.grid()

    ax3[0].scatter(Xtrain[:, 0], Xtrain[:, 1], Ytrain[:, 0], s=1)
    ax3[0].set_title("Raw Data")
    label3(ax3[0])

    if samples_y is not None:
        S = samples_y.shape[0]
        Xt = np.tile(Xplot, (S, 1))
        ax3[1].scatter(Xt[:, 0], Xt[:, 1], np.reshape(samples_y, (-1,)),
                       marker="+", alpha=0.01, color="tab:red")
        ax3[1].scatter(Xt[:, 0], Xt[:, 1], np.reshape(samples_f, (-1,)),
                       marker="+", alpha=0.01, color="tab:blue")
    ax3[1].scatter(Xtrain[:, 0], Xtrain[:, 1], Ytrain[:, 0], marker="x",
                   color="black", alpha=0.1)
    ax3[1].set_title("Mixture of GPs")
    ax3[1].set_zlim(1.2 * float(np.min(Ytrain)), 1.2 * float(np.max(Ytrain)))
    label3(ax3[1])

    for i in range(K):
        c = _TAB[i % len(_TAB)]
        ax3[2].scatter(Xplot[:, 0], Xplot[:, 1], assign_probs_plot[:, i],
                       color=c, s=1)
        ax3[3].scatter(Xplot[:, 0], Xplot[:, 1], fmean_plot[:, i],
                       color=c, s=1)
    ax3[2].set_title("Assignment Plot")
    label3(ax3[2])
    ax3[3].set_title("Prediction Plot")
    label3(ax3[3])
    fig_3d.tight_layout()

    fig = plt.figure(figsize=(14, 8))
    ax = [fig.add_subplot(2, 3, i) for i in range(1, 6)]
    ax[0].plot(iters, elbos, "o-", ms=8, alpha=0.5)
    ax[0].set_xlabel("Iterations")
    ax[0].set_ylabel("ELBO")
    ax[0].grid()

    for i, (Xs, ci, const, a_probs, fm, fv) in enumerate(slices):
        other = lb_ if ci == 0 else la
        title = f"{other} Constant Value = {const}"
        ax[1 + i].plot(Xs[:, ci], a_probs, "o", markersize=1)
        ax[1 + i].set_title(title)
        ax[1 + i].set_xlabel(la if ci == 0 else lb_)
        ax[1 + i].set_ylabel("softmax(assignment)")
        ax[1 + i].grid()

        order = np.argsort(Xs[:, ci])
        xs = Xs[order, ci]
        fm_s, fv_s = fm[order], fv[order]
        lo_b, up_b = fm_s - 2 * np.sqrt(fv_s), fm_s + 2 * np.sqrt(fv_s)
        for k in range(K):
            c = _TAB[k % len(_TAB)]
            ax[3 + i].plot(xs, fm_s[:, k], "-", alpha=1.0, color=c)
            ax[3 + i].fill_between(xs, lo_b[:, k], up_b[:, k], alpha=0.3,
                                   color=c)
        ax[3 + i].scatter(Xtrain[:, ci], Ytrain[:, 0], marker="x",
                          color="black", alpha=0.5)
        ax[3 + i].set_title(title)
        ax[3 + i].set_xlabel(la if ci == 0 else lb_)
        ax[3 + i].set_ylabel("Pred. of GP experts")
        ax[3 + i].grid()
    fig.tight_layout()
    return fig_3d, fig


def _grid(svgp, lo, hi, n):
    import torch
    Xplot = np.linspace(lo, hi, n)[:, None]
    Z = svgp.Z.value
    return Xplot, torch.as_tensor(Xplot, dtype=Z.dtype, device=Z.device)


def plot_kernel_samples(ax, svgp, generator, lo=-6.0, hi=6.0, n: int = 100,
                        n_samples: int = 3) -> None:
    """SVGP posterior function draws (reference utils/plotting_utils.py:7-13):
    joint draws over the grid (gpflow's ``predict_f_samples`` default,
    full_cov=True), so the traces are smooth correlated functions."""
    import torch
    Xplot, Xt = _grid(svgp, lo, hi, n)
    with torch.no_grad():
        fs = svgp.predict_f_samples(generator, Xt, n_samples)
    ax.plot(Xplot, fs.cpu().numpy()[:, :, 0].T)
    ax.set_title("Example $f$s")


def plot_kernel(svgp, generator) -> None:
    """Two-panel sample/prediction figure (reference
    utils/plotting_utils.py:33-37)."""
    plt = pyplot()
    _, (samples_ax, prediction_ax) = plt.subplots(nrows=1, ncols=2)
    plot_kernel_samples(samples_ax, svgp, generator)
    plot_kernel_prediction(prediction_ax, svgp)


def plot_kernel_prediction(ax, svgp, lo=-6.0, hi=6.0, n: int = 100) -> None:
    """Mean ± 1.96 std bands (reference utils/plotting_utils.py:16-31)."""
    import torch
    Xplot, Xt = _grid(svgp, lo, hi, n)
    with torch.no_grad():
        f_mean, f_var = svgp.predict_f(Xt)
    f_mean, f_var = f_mean.cpu().numpy(), f_var.cpu().numpy()
    f_lower = f_mean - 1.96 * np.sqrt(f_var)
    f_upper = f_mean + 1.96 * np.sqrt(f_var)
    lines = ax.plot(Xplot, f_mean, "-")
    for i, line in enumerate(lines):
        color = line.get_color()
        ax.fill_between(Xplot[:, 0], f_lower[:, i], f_upper[:, i],
                        color=color, alpha=0.1)
    ax.set_title("Example data fit")
