"""The plain reference of smgpmod_multiclass_k8_m4096: the SMGPModified
with MultiClass (RobustMax) experts and a Gaussian likelihood on the
assignment latents (demo_tf2_modified_multiclass.py's model).

    loss = -( mean_n[ logsumexp_S( sum_k VE_a,k W - log S )
                      + logsumexp_S( sum_k VE_y W - log S ) ]
              - (KL_pred + KL_assign) / num_data )

VE_a is the Gaussian's expectation of the labels (as numbers) under the
assignment marginals, VE_y RobustMax's under the prediction marginals.
"""
from __future__ import annotations

import math

import torch

from torchbench.reference import _plain


def loss(p, cfg, X, Y, z, u, prec):
    low = "pred_q_sqrt" in cfg["bf16_terms"]
    fmu, fvar = _plain.marginals(p, "pred_layer", X, cfg, prec, low=low)
    amu, avar = _plain.marginals(p, "assign_layer", X, cfg, prec)
    W = _plain.assignment_weights(amu, avar, z, u, cfg)
    logS = math.log(z.shape[0])
    s2 = _plain.softplus(p["assign_likelihood.variance.raw"])
    ve_a = _plain.gaussian_ve(s2, amu, avar, Y)
    ve_y = _plain.robustmax_ve(cfg["likelihood"], fmu, fvar, Y)
    data = (torch.logsumexp((ve_a[None] * W).sum(2) - logS, dim=0)
            + torch.logsumexp((ve_y[None] * W).sum(2) - logS, dim=0))
    kl = _plain.whitened_kl(p, "pred_layer") + _plain.whitened_kl(p, "assign_layer")
    return -(data.mean() - kl / cfg["num_data"])
