from .base import Likelihood
from .bernoulli import Bernoulli
from .gaussian import Gaussian
from .multiclass import MultiClass, RobustMax

__all__ = ["Likelihood", "Bernoulli", "Gaussian", "MultiClass", "RobustMax"]
