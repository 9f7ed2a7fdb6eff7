"""1-D multimodal mixture-of-GPs regression (the flagship demo).

Mirrors demos/demo_multimodal_1d.py (the reference's demos/demo_tf2.py):
N=1500 three-branch multimodal data, K=3 experts, M=25 k-means inducing
points (seeds 0 and 1), S=25 samples, minibatch 500, Adam lr 5e-3, 2000
iterations, a Gaussian(D=K) likelihood, SquaredExponential kernels (0.5,
0.5) for prediction and (0.1, 1.0) for assignment.  Its predictions come
from the trained model itself, and it reports the assignment's entropy.

    python -m modulatedgps_tpu_torch.demos.demo_multimodal_1d [--platform cpu]
"""
from __future__ import annotations

import numpy as np

from modulatedgps_tpu_torch.data import load_toy_multimodal_data
from modulatedgps_tpu_torch.demos._common import (bootstrap, demo_argparser,
                                                  predict_in_batches,
                                                  save_figure)
from modulatedgps_tpu_torch.demos._runner import DemoConfig, build, train

CONFIG = DemoConfig(
    name="demo_multimodal_1d",
    load_data=load_toy_multimodal_data,
    K=3, iters=2000,
    pred_kernel=(0.5, 0.5), assign_kernel=(0.1, 1.0),
)


def main(argv=None):
    """Run the demo; returns (model, iters, elbos)."""
    args = demo_argparser(dict(iters=CONFIG.iters, K=CONFIG.K)).parse_args(argv)
    device, dtype = bootstrap(args.platform, debug_nans=args.debug_nans)

    import torch

    from modulatedgps_tpu_torch import print_summary
    from modulatedgps_tpu_torch.training import restore_model

    model, (N, Xtrain, Ytrain, Xtest) = build(CONFIG, args, device, dtype)
    if args.resume:
        restore_model(args.resume, model)
    print_summary(model)
    iters, elbos = train(model, args, Xtrain, Ytrain, device, dtype)
    print_summary(model)

    def on(x):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    S = args.predict_samples
    with torch.no_grad():
        samples_y, samples_f = predict_in_batches(
            lambda xb: model.predict_samples(gen, on(xb), S=S), Xtest)
        assign_probs = model.predict_assign(on(Xtrain)).cpu().numpy()
        fmean, fvar = (t.mean(0).cpu().numpy()
                       for t in model.predict_y(on(Xtest)))

    # elbos is empty when a resumed --checkpoint-every run is already at or
    # past --iters (no new steps).
    final = f"{elbos[-1]:.4f}" if elbos else "(resumed; no new steps)"
    entropy = -np.mean(np.sum(assign_probs * np.log(assign_probs + 1e-12), -1))
    print(f"final ELBO {final}; assign entropy {entropy:.3f}")

    if not args.no_plot:
        from modulatedgps_tpu_torch.utils.plotting import four_panel_figure
        fig = four_panel_figure(Xtrain, Ytrain, Xtest, samples_y, samples_f,
                                iters, elbos, Xtrain, assign_probs, Xtest,
                                fmean, fvar, args.K)
        save_figure(fig, args.out, "demo_multimodal_1d.png")
    return model, iters, elbos


if __name__ == "__main__":
    main()
