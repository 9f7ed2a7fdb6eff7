"""1-D multimodal data with SMGPModified (separate assignment likelihood).

Mirrors demos/demo_multimodal_1d_modified.py (the reference's
demos/demo_tf2_modified.py): the flagship's data, 4000 iterations,
Gaussian prediction and assignment likelihoods.

    python -m modulatedgps_tpu_torch.demos.demo_multimodal_1d_modified [--platform cpu]
"""
from modulatedgps_tpu_torch.data import load_toy_multimodal_data
from modulatedgps_tpu_torch.demos._runner import DemoConfig, run

CONFIG = DemoConfig(
    name="demo_multimodal_1d_modified",
    load_data=load_toy_multimodal_data,
    K=3, iters=4000,
    pred_kernel=(0.5, 0.5), assign_kernel=(0.1, 1.0),
    modified=True,
)


def main(argv=None):
    """Run the demo; returns (model, iters, elbos)."""
    return run(CONFIG, argv)


if __name__ == "__main__":
    main()
