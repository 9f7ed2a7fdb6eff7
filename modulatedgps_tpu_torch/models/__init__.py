from .posterior import PrecomputedPosterior, precompute_posterior, precompute_smgp
from .smgp import SGP, SMGP, SMGPModified
from .svgp import SVGP
from .vgp import VGP

__all__ = ["PrecomputedPosterior", "SGP", "SMGP", "SMGPModified", "SVGP", "VGP",
           "precompute_posterior", "precompute_smgp"]
