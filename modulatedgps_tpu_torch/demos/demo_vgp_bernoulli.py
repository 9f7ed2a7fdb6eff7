"""VGP + Bernoulli classification sanity demo.

Mirrors demos/demo_vgp_bernoulli.py: a 7-point binary dataset, a VGP with
a SquaredExponential kernel and a Bernoulli (probit) likelihood, trained
full-batch with scipy's L-BFGS, then a 3-panel figure (latent f with its
95% band, the predictive mean, the data).

    python -m modulatedgps_tpu_torch.demos.demo_vgp_bernoulli [--platform cpu]
"""
from __future__ import annotations

import numpy as np

from modulatedgps_tpu_torch.demos._common import (bootstrap, demo_argparser,
                                                  save_figure)


def main(argv=None) -> dict:
    """Run the demo; returns the final ELBO, scipy's result and the
    unrounded predictions at the training inputs."""
    args = demo_argparser(dict(iters=2000)).parse_args(argv)
    device, dtype = bootstrap(args.platform, debug_nans=args.debug_nans)

    import torch
    from modulatedgps_tpu_torch import (Bernoulli, SquaredExponential, VGP,
                                        print_summary, run_scipy)

    # Same 7-point dataset as the reference demo.
    X = np.array([2.0, 4, 7, 9, 17, 19, 21])[:, None]
    Y = np.array([1.0, 1, 1, 1, 0, 0, 0])[:, None]

    model = VGP.create(SquaredExponential.create(1.0, 1.0, dtype=dtype,
                                                 device=device),
                       Bernoulli(), X, Y, num_latent_gps=1, dtype=dtype,
                       device=device)
    print_summary(model)
    model, result = run_scipy(model, maxiter=args.iters, verbose=True)
    print_summary(model)
    with torch.no_grad():
        elbo = float(model.elbo())
        print(f"final ELBO: {elbo:.6f} "
              f"(L-BFGS nit={result.nit}, converged={result.success})")
        Xt = torch.as_tensor(X, dtype=dtype, device=device)
        fmean, fvar = model.predict_f(Xt)
        ymean, _ = model.predict_y(Xt)
    fmean, fvar, ymean = (a.cpu().numpy().ravel() for a in (fmean, fvar, ymean))
    print("p(y=1|x):", np.round(ymean, 3))

    if not args.no_plot:
        import matplotlib
        matplotlib.use("Agg")
        from matplotlib import pyplot as plt
        fig, (ax1, ax2, ax3) = plt.subplots(3, 1, sharex=True, figsize=(8, 8))
        x = X.ravel()
        ax1.plot(x, fmean, marker="x", color="black")
        ax1.fill_between(x, fmean - 1.96 * np.sqrt(fvar),
                         fmean + 1.96 * np.sqrt(fvar), color="C0", alpha=0.2)
        ax1.set_ylabel("f(x)")
        ax2.plot(x, ymean, marker="x", color="blue")
        ax2.set_ylabel("p(y=1)")
        ax3.scatter(x, Y.ravel(), marker="x", color="red", s=45)
        ax3.set_ylabel("Y")
        ax3.set_xlabel("X")
        save_figure(fig, args.out, "demo_vgp_bernoulli.png")
    return {"elbo": elbo, "result": result, "fmean": fmean, "fvar": fvar,
            "p": ymean}


if __name__ == "__main__":
    main()
