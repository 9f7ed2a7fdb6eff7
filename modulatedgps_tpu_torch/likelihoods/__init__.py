from .base import Likelihood
from .gaussian import Gaussian

__all__ = ["Likelihood", "Gaussian"]
