from .posterior import PrecomputedPosterior, precompute_posterior, precompute_smgp
from .smgp import SGP, SMGP, SMGPModified
from .svgp import SVGP

__all__ = ["PrecomputedPosterior", "SGP", "SMGP", "SMGPModified", "SVGP",
           "precompute_posterior", "precompute_smgp"]
