"""John Doe cricket dataset: binary boundary classification.

Mirrors demos/demo_john_doe_multiclass.py: the boundary target ({0, 1}
-> 0, {4, 6} -> 1), K=2, MultiClass prediction and Gaussian assignment
likelihoods, 2000 iterations.

    python -m modulatedgps_tpu_torch.demos.demo_john_doe_multiclass [--platform cpu]
"""
from modulatedgps_tpu_torch.data import load_john_doe
from modulatedgps_tpu_torch.demos._runner import DemoConfig, run

CONFIG = DemoConfig(
    name="demo_john_doe_multiclass",
    load_data=lambda rng: load_john_doe(rng=rng),
    K=2, iters=2000,
    pred_kernel=(0.1, 1.0), assign_kernel=(0.1, 1.0),
    multiclass=True, plot_1d=False,
    axis_labels=("StumpsX", "StumpsY"),
)


def main(argv=None):
    """Run the demo; returns (model, iters, elbos)."""
    return run(CONFIG, argv)


if __name__ == "__main__":
    main()
