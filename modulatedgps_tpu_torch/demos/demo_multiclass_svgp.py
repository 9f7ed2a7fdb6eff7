"""Plain SVGP 3-class classification sanity demo.

Mirrors demos/demo_multiclass_svgp.py (the analog of the reference's
demos/from_online/demo_multiclass_lik.py): C=3 latent functions drawn from
a SquaredExponential(1, 0.1) prior at N=100 points, labels their argmax;
an SVGP with a Matern32 + White(0.01) sum kernel, a RobustMax MultiClass
likelihood and a diagonal q_sqrt, the inducing inputs Z = X[::5] and the
White variance frozen, trained full-batch by scipy's L-BFGS.

    python -m modulatedgps_tpu_torch.demos.demo_multiclass_svgp [--platform cpu]
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from modulatedgps_tpu_torch.demos._common import (bootstrap, demo_argparser,
                                                  save_figure)


class SVGPClassifier(nn.Module):
    """The full-batch SVGP ELBO, sum of E_q[log p(y|f)] minus the KL."""

    def __init__(self, svgp, likelihood, num_data: int):
        super().__init__()
        self.svgp = svgp
        self.likelihood = likelihood
        self.num_data = num_data

    def elbo(self, X, Y):
        fmu, fvar = self.svgp.predict_f(X)
        ve = self.likelihood.variational_expectations(fmu, fvar, Y)
        return ve.sum() - self.svgp.prior_kl()


def main(argv=None) -> dict:
    """Run the demo; returns the model, scipy's result, the final ELBO and
    the training accuracy."""
    args = demo_argparser(dict(iters=1000, K=3)).parse_args(argv)
    device, dtype = bootstrap(args.platform, debug_nans=args.debug_nans)

    from modulatedgps_tpu_torch import (SVGP, Matern32, MultiClass, RobustMax,
                                        Sum, White, print_summary, run_scipy,
                                        set_trainable)

    C, N = args.K, 100
    rng = np.random.default_rng(args.seed)
    X = rng.random((N, 1))
    # A latent prior draw under SE(variance 1, lengthscale 0.1), on the host
    # in float64; labels are the argmax over C.
    Kxx = np.exp(-0.5 * ((X - X.T) / 0.1) ** 2) + np.eye(N) * 1e-6
    f = rng.multivariate_normal(np.zeros(N), Kxx, size=C).T          # [N, C]
    Y = np.argmax(f, axis=1).astype(np.float64)[:, None]

    on = dict(dtype=dtype, device=device)
    kernel = Sum([Matern32.create(1.0, 1.0, **on), White.create(0.01, **on)])
    set_trainable(kernel.kernels[1].variance, False)   # demo_multiclass_lik.py:128
    svgp = SVGP.create(kernel, X[::5].copy(), num_latent_gps=C, whiten=True,
                       q_diag=True, **on)
    set_trainable(svgp.Z, False)                       # demo_multiclass_lik.py:129
    model = SVGPClassifier(svgp, MultiClass.create(C, RobustMax(C)), N)
    Xt, Yt = torch.as_tensor(X, **on), torch.as_tensor(Y, **on)
    print_summary(model)
    model, result = run_scipy(model, lambda m, X_, Y_: -m.elbo(X_, Y_),
                              data=(Xt, Yt), maxiter=args.iters, verbose=True)
    print_summary(model)

    with torch.no_grad():
        elbo = float(model.elbo(Xt, Yt))
        fmu = model.svgp.predict_f(Xt)[0].cpu().numpy()
    acc = float(np.mean(np.argmax(fmu, axis=1) == Y.ravel()))
    print(f"final ELBO: {elbo:.4f}  train acc: {acc:.3f} "
          f"(L-BFGS nit={result.nit})")

    if not args.no_plot:
        from modulatedgps_tpu_torch.utils.plotting import pyplot
        plt = pyplot()
        xx = np.linspace(X.min(), X.max(), 200)[:, None]
        with torch.no_grad():
            mu, var = model.svgp.predict_f(torch.as_tensor(xx, **on))
            p, _ = model.likelihood.predict_mean_and_var(mu, var)
        mu, var, p = (t.cpu().numpy() for t in (mu, var, p))
        colors = ["#1f77b4", "#ff7f0e", "#2ca02c", "#d62728"]
        fig, (a1, a2) = plt.subplots(2, 1, sharex=True, figsize=(10, 7))
        for c in range(C):
            col = colors[c % len(colors)]
            a1.plot(xx, mu[:, c], color=col, lw=2, label=str(c))
            a1.plot(xx, mu[:, c] + 2 * np.sqrt(var[:, c]), "--", color=col)
            a1.plot(xx, mu[:, c] - 2 * np.sqrt(var[:, c]), "--", color=col)
            a2.plot(xx, p[:, c], "-", color=col, lw=2)
            a2.plot(X[Y.ravel() == c], np.zeros(np.sum(Y.ravel() == c)) - 0.05,
                    ".", color=col)
        a1.set_title("posterior latents")
        a1.legend()
        a2.set_title("predicted class probabilities")
        a2.set_ylim(-0.12, 1.1)
        save_figure(fig, args.out, "demo_multiclass_svgp.png")
    return {"model": model, "result": result, "elbo": elbo, "accuracy": acc}


if __name__ == "__main__":
    main()
