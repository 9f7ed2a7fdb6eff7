"""Command-line demos of the port, one per demo of demos/ with the same
flags (``python -m modulatedgps_tpu_torch.demos.demo_vgp_bernoulli``)."""
