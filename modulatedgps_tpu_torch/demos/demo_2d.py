"""2-D two-sheet regression.

Mirrors demos/demo_2d.py (the reference's demos/demo_tf2_2d.py): two
radial sheets offset by 10, K=3, Gaussian(D=K), 2000 iterations.

    python -m modulatedgps_tpu_torch.demos.demo_2d [--platform cpu]
"""
from modulatedgps_tpu_torch.data import load_toy_2d_data
from modulatedgps_tpu_torch.demos._runner import DemoConfig, run

CONFIG = DemoConfig(
    name="demo_2d",
    load_data=load_toy_2d_data,
    K=3, iters=2000,
    pred_kernel=(0.5, 0.5), assign_kernel=(0.1, 1.0),
    plot_1d=False,
)


def main(argv=None):
    """Run the demo; returns (model, iters, elbos)."""
    return run(CONFIG, argv)


if __name__ == "__main__":
    main()
