"""John Doe cricket dataset: batterRuns regression by a mixture of GPs.

Mirrors demos/demo_john_doe.py: 557 filtered seam / right-arm deliveries,
features (stumpsX, stumpsY), target batterRuns in {0, 1, 4, 6}, K=4,
10000 iterations, Gaussian(D=K).

    python -m modulatedgps_tpu_torch.demos.demo_john_doe [--platform cpu]
"""
from modulatedgps_tpu_torch.data import load_john_doe_runs
from modulatedgps_tpu_torch.demos._runner import DemoConfig, run

CONFIG = DemoConfig(
    name="demo_john_doe",
    load_data=lambda rng: load_john_doe_runs(rng=rng),
    K=4, iters=10000,
    pred_kernel=(0.5, 0.5), assign_kernel=(0.1, 1.0),
    plot_1d=False, axis_labels=("StumpsX", "StumpsY"),
)


def main(argv=None):
    """Run the demo; returns (model, iters, elbos)."""
    return run(CONFIG, argv)


if __name__ == "__main__":
    main()
