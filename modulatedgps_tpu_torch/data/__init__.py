"""The data loaders: a copy of modulatedgps_tpu/data/ (numpy, the csv
module and ctypes only: the JAX package's copy reads the John Doe CSV with
pandas and splits it with scikit-learn), kept here because importing that
copy imports jax (modulatedgps_tpu/__init__.py)."""
from .datasets import (
    load_toy_multimodal_data,
    load_toy_data_categorical,
    load_toy_data_assoc,
    load_toy_2d_data,
    load_toy_2d_data_categorical,
    load_john_doe_runs,
    load_john_doe,
)
from .loader import minibatch_iterator

__all__ = [
    "load_toy_multimodal_data",
    "load_toy_data_categorical",
    "load_toy_data_assoc",
    "load_toy_2d_data",
    "load_toy_2d_data_categorical",
    "load_john_doe_runs",
    "load_john_doe",
    "minibatch_iterator",
]
