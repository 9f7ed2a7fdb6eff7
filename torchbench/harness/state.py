"""The model's state and the seeds of a run, made on the device.

The state is a perturbed, trained-like one (at the whitened init, q_mu = 0
and q_sqrt = I, the q_sqrt variance term cancels):

    Z      ~ Z_scale N(0, 1)                      [M, D]
    q_mu   ~ q_mu_scale N(0, 1)                   [M, K]
    q_sqrt = I + perturbation tril N(0, 1), with a positive diagonal,
                                                  [K, M, M]

per layer, the kernels' and likelihoods' hyperparameters at the
configuration's values.  It is drawn in float32 (the type it is served in)
by a few large calls of a torch.Generator on the device, and keyed by the
port's parameter names, which are the JAX pytree paths.  The reference
draws the same state and casts it.
"""
from __future__ import annotations

import math

import torch

# Streams of one seed: each part of a run draws from its own generator.
NOISE, STATE, DATA, REQUESTS, SAMPLE = 0, 1, 2, 3, 4


def stream_seed(seed: int, stream: int) -> int:
    """A generator seed for one stream of a run's seed (any int >= 0)."""
    return (int(seed) * 1_000_003 + stream) % (2 ** 63)


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, stream))


def softplus_inv(value: float) -> float:
    """The raw value of a positive parameter (softplus's inverse)."""
    return value + math.log(-math.expm1(-value))


def _layers(cfg: dict):
    return (("pred_layer", cfg["pred_kernel"]),
            ("assign_layer", cfg["assign_kernel"]))


def make_state(cfg: dict, seed: int, device) -> dict:
    """{raw parameter name: float32 tensor on ``device``} from the seed."""
    g = generator(seed, STATE, device)
    M, K, D = cfg["M"], cfg["K"], cfg["D"]
    st = cfg["state"]
    f32 = dict(dtype=torch.float32, device=device)
    out = {}
    for name, kern in _layers(cfg):
        Z = torch.randn((M, D), generator=g, **f32).mul_(st["Z_scale"])
        q_mu = torch.randn((M, K), generator=g, **f32).mul_(st["q_mu_scale"])
        q_sqrt = torch.randn((K, M, M), generator=g, **f32)
        q_sqrt.mul_(st["q_sqrt_perturbation"]).tril_()
        diag = q_sqrt.diagonal(dim1=-2, dim2=-1)
        diag.add_(1.0).abs_()
        out.update({
            f"{name}.kernel.variance.raw":
                torch.tensor(softplus_inv(kern["variance"]), **f32),
            f"{name}.kernel.lengthscales.raw":
                torch.tensor(softplus_inv(kern["lengthscales"]), **f32),
            f"{name}.Z.raw": Z,
            f"{name}.q_mu.raw": q_mu,
            f"{name}.q_sqrt.raw": q_sqrt,
        })
    for key in ("likelihood", "assign_likelihood"):
        lik = cfg.get(key)
        if lik and lik["kind"] == "Gaussian":
            shape = (1, K) if lik.get("per_expert") else ()
            out[f"{key}.variance.raw"] = torch.full(
                shape, softplus_inv(lik["variance"]), **f32)
    return out


def build_model(cfg: dict, state: dict, device, dtype=torch.float32):
    """The port's model, built with its own constructors and filled with
    ``state``; every raw leaf must be in ``state`` and nothing else."""
    import modulatedgps_tpu_torch as pt
    M, K, D = cfg["M"], cfg["K"], cfg["D"]
    on = dict(dtype=dtype, device=device)

    def kernel(spec):
        if spec["kind"] != "SquaredExponential":
            raise ValueError(f"kernel {spec['kind']} is not built here")
        return pt.SquaredExponential.create(spec["variance"],
                                            spec["lengthscales"], **on)

    def layer(spec):
        return pt.SVGP.create(kernel(spec), torch.zeros((M, D), **on), K,
                              whiten=cfg["whiten"], jitter=cfg["jitter"], **on)

    def likelihood(spec):
        if spec["kind"] == "Gaussian":
            return pt.Gaussian.create(spec["variance"],
                                      D=K if spec.get("per_expert") else None,
                                      **on)
        if spec["kind"] == "MultiClass":
            invlink = pt.RobustMax(spec["num_classes"], spec["epsilon"])
            return pt.MultiClass.create(spec["num_classes"], invlink,
                                        spec["gauss_hermite_points"])
        raise ValueError(f"likelihood {spec['kind']} is not built here")

    common = dict(K=K, num_samples=cfg["S"], num_data=cfg["num_data"],
                  temperature=cfg["temperature"])
    pred, assign = layer(cfg["pred_kernel"]), layer(cfg["assign_kernel"])
    if cfg["model"] == "SMGP":
        model = pt.SMGP(likelihood(cfg["likelihood"]), pred, assign, **common)
    elif cfg["model"] == "SMGPModified":
        model = pt.SMGPModified(
            likelihood(cfg["likelihood"]), pred, assign,
            assign_likelihood=likelihood(cfg["assign_likelihood"]), **common)
    else:
        raise ValueError(f"model {cfg['model']} is not built here")
    params = dict(model.named_parameters())
    if set(params) != set(state):
        raise ValueError(f"state and model differ: "
                         f"{sorted(set(params) ^ set(state))}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(state[name])
    return model
