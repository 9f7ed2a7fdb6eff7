from .posterior import PrecomputedPosterior, precompute_posterior, precompute_smgp
from .smgp import SGP, SMGP
from .svgp import SVGP

__all__ = ["PrecomputedPosterior", "SGP", "SMGP", "SVGP",
           "precompute_posterior", "precompute_smgp"]
