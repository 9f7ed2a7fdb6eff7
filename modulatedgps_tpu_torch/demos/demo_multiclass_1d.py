"""1-D classification with outliers: MultiClass (RobustMax) experts.

Mirrors demos/demo_multiclass_1d.py (the reference's
demos/demo_tf2_modified_multiclass.py): step data with 10% flips, K=2,
MultiClass prediction and Gaussian assignment likelihoods, 2000
iterations, kernels (0.1, 1.0) / (0.1, 1.0).

    python -m modulatedgps_tpu_torch.demos.demo_multiclass_1d [--platform cpu]
"""
from modulatedgps_tpu_torch.data import load_toy_data_categorical
from modulatedgps_tpu_torch.demos._runner import DemoConfig, run

CONFIG = DemoConfig(
    name="demo_multiclass_1d",
    load_data=load_toy_data_categorical,
    K=2, iters=2000,
    pred_kernel=(0.1, 1.0), assign_kernel=(0.1, 1.0),
    multiclass=True,
)


def main(argv=None):
    """Run the demo; returns (model, iters, elbos)."""
    return run(CONFIG, argv)


if __name__ == "__main__":
    main()
