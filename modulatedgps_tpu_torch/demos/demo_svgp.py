"""Plain SVGP regression sanity demo.

Mirrors demos/demo_svgp.py (the analog of the reference's dependency check
demos/from_online/demo_SVGP.py): 300 points of sin(x) plus noise, an SVGP
with a SquaredExponential kernel on M=25 k-means inducing points and a
Gaussian likelihood, trained by ``run_adam`` on the minibatch ELBO.

    python -m modulatedgps_tpu_torch.demos.demo_svgp [--platform cpu]
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from modulatedgps_tpu_torch.demos._common import (bootstrap, demo_argparser,
                                                  save_figure)


class SVGPRegression(nn.Module):
    """E_q[log p(y|f)] - KL / N: the minimal SVGP ELBO, per data point."""

    def __init__(self, svgp, likelihood, num_data: int):
        super().__init__()
        self.svgp = svgp
        self.likelihood = likelihood
        self.num_data = num_data

    def training_loss(self, generator, X, Y):
        fmu, fvar = self.svgp.predict_f(X)
        ve = self.likelihood.variational_expectations(fmu, fvar, Y)
        scale = self.num_data / X.shape[0]
        return -(ve.sum() * scale - self.svgp.prior_kl()) / self.num_data


def main(argv=None) -> dict:
    """Run the demo; returns the model, the ELBO history and the RMSE."""
    args = demo_argparser(dict(iters=500, K=1)).parse_args(argv)
    device, dtype = bootstrap(args.platform, debug_nans=args.debug_nans)

    from modulatedgps_tpu_torch import (SVGP, Gaussian, SquaredExponential,
                                        run_adam)
    from modulatedgps_tpu_torch.data import minibatch_iterator
    from modulatedgps_tpu_torch.utils import kmeans_centers

    rng = np.random.default_rng(args.seed)
    N = 300
    X = rng.uniform(-5, 5, (N, 1))
    Y = np.sin(X) + 0.2 * rng.standard_normal((N, 1))

    on = dict(dtype=dtype, device=device)
    kern = SquaredExponential.create(1.0, 1.0, **on)
    Z = kmeans_centers(X, args.num_inducing, seed=0)
    svgp = SVGP.create(kern, Z, num_latent_gps=1, whiten=True, **on)
    model = SVGPRegression(svgp, Gaussian.create(variance=0.1, **on), N)

    def tensor(x):
        return torch.as_tensor(x, **on)

    batches = ((tensor(x), tensor(y)) for x, y in
               minibatch_iterator(X, Y, args.batch, seed=args.seed))
    _, iters, elbos = run_adam(
        model, args.iters, batches, args.lr,
        generator=torch.Generator(device=device).manual_seed(args.seed))

    Xp = np.linspace(-6, 6, 200)[:, None]
    with torch.no_grad():
        fmu, fvar = (t.cpu().numpy() for t in model.svgp.predict_f(tensor(Xp)))
        fit = model.svgp.predict_f(tensor(X))[0].cpu().numpy()
    rmse = float(np.sqrt(np.mean((fit - np.sin(X)) ** 2)))
    print(f"RMSE vs true sin: {rmse:.4f}")

    if not args.no_plot:
        from modulatedgps_tpu_torch.utils.plotting import pyplot
        plt = pyplot()
        fig, ax = plt.subplots(1, 2, figsize=(12, 4))
        ax[0].scatter(X, Y, marker="x", alpha=0.4, color="black")
        ax[0].plot(Xp, fmu[:, 0], "-")
        ax[0].fill_between(Xp[:, 0], fmu[:, 0] - 1.96 * np.sqrt(fvar[:, 0]),
                           fmu[:, 0] + 1.96 * np.sqrt(fvar[:, 0]), alpha=0.3)
        ax[0].set_title("SVGP fit")
        ax[1].plot(iters, elbos, "o-", alpha=0.5)
        ax[1].set_title("ELBO")
        save_figure(fig, args.out, "demo_svgp.png")
    return {"model": model, "iters": iters, "elbos": elbos, "rmse": rmse}


if __name__ == "__main__":
    main()
