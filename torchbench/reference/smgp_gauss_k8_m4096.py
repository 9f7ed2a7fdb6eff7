"""The plain reference of smgp_gauss_k8_m4096: the SMGP with Gaussian
experts (demo_tf2.py's model), whitened SE layers.

    loss = -( mean_n[ logsumexp_S( sum_k VE_k(n) W_snk ) - log S ]
              - (KL_pred + KL_assign) / num_data )

with W the Gumbel-softmax weights of the assignment layer; served: the
prediction layer's predictive moments, softmax of the assignment means,
and the mixture's log-density.
"""
from __future__ import annotations

import math

import torch

from torchbench.reference import _plain



def loss(p, cfg, X, Y, z, u, prec):
    fmu, fvar = _plain.marginals(p, "pred_layer", X, cfg, prec)
    amu, avar = _plain.marginals(p, "assign_layer", X, cfg, prec)
    W = _plain.assignment_weights(amu, avar, z, u, cfg)
    s2 = _plain.softplus(p["likelihood.variance.raw"])
    ve = _plain.gaussian_ve(s2, fmu, fvar, Y)
    data = torch.logsumexp((ve[None] * W).sum(2), dim=0) - math.log(z.shape[0])
    kl = _plain.whitened_kl(p, "pred_layer") + _plain.whitened_kl(p, "assign_layer")
    return -(data.mean() - kl / cfg["num_data"])


def predict(p, cfg, X, Y, prec):
    low = "served_q_sqrt" in cfg["bf16_terms"]
    fmu, fvar = _plain.marginals(p, "pred_layer", X, cfg, prec, low=low)
    amu, _ = _plain.marginals(p, "assign_layer", X, cfg, prec, low=low)
    s2 = _plain.softplus(p["likelihood.variance.raw"])
    pi = torch.softmax(amu, dim=-1)
    log_pk = _plain.gaussian_log_density(s2, fmu, fvar, Y)
    return {"mean": fmu, "var": fvar + s2, "assign": pi,
            "density": torch.logsumexp(torch.log(pi + 1e-12) + log_pk, dim=-1)}
