"""Generic SMGP / SMGPModified demo runner.

Mirrors demos/_runner.py:18-167: each demo family is the same pipeline
with other data, kernels, likelihood and model variant; this runner owns
the pipeline, the demo files own the configuration.  k-means inducing
points (seeds 0 and 1), an SMGP (Gaussian experts) or an SMGPModified
(MultiClass or Gaussian experts, a Gaussian likelihood on the assignment
layer), ``run_adam`` with ``--checkpoint`` / ``--checkpoint-every`` /
``--resume`` / ``--metrics``, then serving through ``precompute_smgp``
(``predict_samples``, ``predict_assign`` and ``predict_y`` in batches)
and the 1-D four-panel figure or the 2-D two-figure set.

``--resume`` takes a file of this package or of the JAX package (a model
or a TrainState), told apart by the JAX one's ``leaf_0`` key.  The run's
noise is a ``torch.Generator`` seeded ``--seed`` on the model's device
(JAX's threefry key cannot be continued), so a run matches the JAX demo's
in distribution, not draw for draw.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from modulatedgps_tpu_torch.demos._common import (bootstrap, demo_argparser,
                                                  predict_in_batches,
                                                  save_figure)

__all__ = ["DemoConfig", "build", "train", "run"]


@dataclasses.dataclass
class DemoConfig:
    name: str
    load_data: Callable         # rng -> (N, Xtrain, Ytrain, Xtest[, attrs])
    K: int
    iters: int
    pred_kernel: tuple          # (variance, lengthscales)
    assign_kernel: tuple
    multiclass: bool = False    # MultiClass pred lik + SMGPModified
    modified: bool = False      # SMGPModified with Gaussian assign lik
    lik_variance: float = 0.5
    plot_1d: bool = True        # 4-panel 1-D figure (else 2-D 2-figure set)
    axis_labels: tuple = ("x1", "x2")   # 2-D axis names (John Doe: stumps)


def build(cfg: DemoConfig, args, device, dtype):
    """(model, (N, Xtrain, Ytrain, Xtest)): the data from ``--seed`` and the
    untrained model, as demos/_runner.py:46-72 builds them."""
    from modulatedgps_tpu_torch import (SMGP, SVGP, Gaussian, MultiClass,
                                        SMGPModified, SquaredExponential)
    from modulatedgps_tpu_torch.utils import kmeans_centers

    N, Xtrain, Ytrain, Xtest = cfg.load_data(np.random.default_rng(args.seed))[:4]
    K = args.K
    on = dict(dtype=dtype, device=device)
    pred_kernel = SquaredExponential.create(*cfg.pred_kernel, **on)
    assign_kernel = SquaredExponential.create(*cfg.assign_kernel, **on)
    Z = kmeans_centers(Xtrain, args.num_inducing, seed=0)
    Z_assign = kmeans_centers(Xtrain, args.num_inducing, seed=1)
    assign_lik = Gaussian.create(variance=cfg.lik_variance, D=K, **on)
    if cfg.multiclass:
        lik = MultiClass.create(K)
    else:
        lik = Gaussian.create(variance=cfg.lik_variance, D=K, **on)
    pred_layer = SVGP.create(pred_kernel, Z, num_latent_gps=K, whiten=True,
                             **on)
    assign_layer = SVGP.create(assign_kernel, Z_assign, num_latent_gps=K,
                               whiten=True, **on)
    if cfg.multiclass or cfg.modified:
        model = SMGPModified(lik, pred_layer, assign_layer,
                             assign_likelihood=assign_lik, K=K,
                             num_samples=args.num_samples, num_data=N)
    else:
        model = SMGP(lik, pred_layer, assign_layer, K=K,
                     num_samples=args.num_samples, num_data=N)
    return model, (N, Xtrain, Ytrain, Xtest)


def train(model, args, Xtrain, Ytrain, device, dtype, metrics=None):
    """``run_adam`` over the seeded minibatch stream (batches moved to the
    model's device); returns (iters, elbos).  ``--checkpoint`` with
    ``--checkpoint-every`` saves and resumes the full train state; without
    it the trained model alone is saved at the end."""
    import torch

    from modulatedgps_tpu_torch import run_adam
    from modulatedgps_tpu_torch.data import minibatch_iterator
    from modulatedgps_tpu_torch.training import save_model

    batches = ((torch.tensor(x, dtype=dtype, device=device),
                torch.tensor(y, dtype=dtype, device=device))
               for x, y in minibatch_iterator(Xtrain, Ytrain, args.batch,
                                              seed=args.seed))
    _, iters, elbos = run_adam(
        model, args.iters, batches, args.lr,
        generator=torch.Generator(device=device).manual_seed(args.seed),
        callback=(lambda i, e, s: metrics.log(i, elbo=e)) if metrics else None,
        checkpoint_path=args.checkpoint,
        checkpoint_every=args.checkpoint_every,
        resume=bool(args.checkpoint and args.checkpoint_every))
    if args.checkpoint and not args.checkpoint_every:
        save_model(args.checkpoint, model)
    return iters, elbos


def run(cfg: DemoConfig, argv=None):
    """The demo's command line; returns (model, iters, elbos)."""
    args = demo_argparser(dict(iters=cfg.iters, K=cfg.K)).parse_args(argv)
    device, dtype = bootstrap(args.platform, debug_nans=args.debug_nans)

    import torch

    from modulatedgps_tpu_torch import precompute_smgp, print_summary
    from modulatedgps_tpu_torch.training import restore_model
    from modulatedgps_tpu_torch.utils import MetricsLogger

    model, (N, Xtrain, Ytrain, Xtest) = build(cfg, args, device, dtype)
    if args.resume:
        restore_model(args.resume, model)
    print_summary(model)
    metrics = MetricsLogger(args.metrics, verbose=False) if args.metrics \
        else None
    iters, elbos = train(model, args, Xtrain, Ytrain, device, dtype, metrics)
    if metrics:
        metrics.close()
    print_summary(model)

    def on(x):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    # Serving: both layers' X-independent algebra is folded into cached
    # tensors once (models/posterior.py); each batch is K(X, Z) and
    # products.  Mixture draws for every config, as the reference's
    # multiclass demos plot them too.
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    S = args.predict_samples
    with torch.no_grad():
        serving = precompute_smgp(model)
        samples_y, samples_f = predict_in_batches(
            lambda xb: serving.predict_samples(gen, on(xb), S=S), Xtest)
        assign_probs = predict_in_batches(
            lambda xb: serving.predict_assign(on(xb)), Xtrain)
        fmean, fvar = predict_in_batches(
            lambda xb: serving.predict_y(on(xb)), Xtest)
        fmean_, fvar_ = fmean.mean(0), fvar.mean(0)

        if elbos:
            print(f"final ELBO {elbos[-1]:.4f}")
        else:
            # A resumed run already at or past --iters: no new steps and no
            # history; report the restored model's training loss.
            loss = model.training_loss(
                torch.Generator(device=device).manual_seed(args.seed),
                on(Xtrain[:args.batch]), on(Ytrain[:args.batch]))
            print(f"no new steps (resumed past --iters); restored ELBO "
                  f"{-float(loss):.4f}")

        if not args.no_plot:
            from modulatedgps_tpu_torch.utils.plotting import (
                four_panel_figure, two_figure_2d)
            if cfg.plot_1d:
                fig = four_panel_figure(Xtrain, Ytrain, Xtest, samples_y,
                                        samples_f, iters, elbos, Xtrain,
                                        assign_probs, Xtest, fmean_, fvar_,
                                        args.K)
                save_figure(fig, args.out, f"{cfg.name}.png")
            else:
                assign_plot = predict_in_batches(
                    lambda xb: serving.predict_assign(on(xb)), Xtest)
                c0, c1 = -0.25, 0.75   # stumpsX/x1 and stumpsY/x2 constants
                line = np.linspace(Xtrain.min(0), Xtrain.max(0), 200)
                slice_X = [np.c_[line[:, 0], np.full(200, c1)],
                           np.c_[np.full(200, c0), line[:, 1]]]
                slices = []
                for i, Xs in enumerate(slice_X):
                    a = serving.predict_assign(on(Xs)).cpu().numpy()
                    fm, fv = (t.mean(0).cpu().numpy()
                              for t in serving.predict_y(on(Xs)))
                    slices.append((Xs, i, c1 if i == 0 else c0, a, fm, fv))
                fig_3d, fig2 = two_figure_2d(
                    Xtrain, Ytrain, Xtest, samples_y, samples_f, iters, elbos,
                    assign_plot, fmean_, slices, args.K,
                    axis_labels=cfg.axis_labels)
                save_figure(fig_3d, args.out, f"{cfg.name}_1.png")
                save_figure(fig2, args.out, f"{cfg.name}_2.png")
    return model, iters, elbos
