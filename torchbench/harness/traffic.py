"""The one generator of every traffic mix: ``traffic/<mix>.json`` holds
only parameters.

Inputs are X ~ U(x_range)^D.  Targets follow the configuration's
likelihood: a Gaussian one gets a mixture of K smooth branches, each point
on a branch drawn uniformly,

    y = amplitude sin(w_b . x + phi_b) + noise_std N(0, 1),
    w_b ~ frequency N(0, I_D), phi_b ~ U(0, 2 pi);

a MultiClass one gets labels, the argmax over classes of x W +
noise_std N(0, 1) with W ~ weight_scale N(0, 1) [D, K] (chip_smoke.py's
class_labels).  All of it is drawn on the device from the seed.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .state import DATA, REQUESTS, SAMPLE, generator


def _targets(mix: dict, cfg: dict, X: torch.Tensor, g: torch.Generator):
    n, D = X.shape
    K = cfg["K"]
    on = dict(dtype=torch.float32, device=X.device)
    if cfg["likelihood"]["kind"] == "MultiClass":
        c = mix["classes"]
        W = torch.randn((D, K), generator=g, **on) * c["weight_scale"]
        noisy = X @ W + c["noise_std"] * torch.randn((n, K), generator=g, **on)
        return noisy.argmax(dim=1, keepdim=True).to(torch.float32)
    r = mix["regression"]
    w = torch.randn((K, D), generator=g, **on) * r["frequency"]
    phi = torch.rand((K,), generator=g, **on) * (2 * math.pi)
    branch = torch.randint(0, K, (n,), generator=g, device=X.device)
    f = torch.sin((X * w[branch]).sum(-1) + phi[branch]) * r["amplitude"]
    return (f + r["noise_std"] * torch.randn((n,), generator=g, **on))[:, None]


def _inputs(mix: dict, cfg: dict, n: int, g: torch.Generator, device):
    lo, hi = mix["x_range"]
    X = torch.rand((n, cfg["D"]), generator=g, dtype=torch.float32,
                   device=device)
    return X.mul_(hi - lo).add_(lo)


def train_data(mix: dict, cfg: dict, seed: int, device):
    """(X [N, D], Y [N, 1]) as float64 numpy arrays on the host, drawn on
    the device: the arrays a user hands minibatch_iterator."""
    g = generator(seed, DATA, device)
    X = _inputs(mix, cfg, mix["num_points"], g, device)
    Y = _targets(mix, cfg, X, g)
    return (X.double().cpu().numpy(), Y.double().cpu().numpy())


@dataclasses.dataclass
class Pool:
    """A closed loop's requests: ``count`` requests of ``size`` points,
    request i the (i mod count)-th; ``checked`` the indices compared."""
    X: torch.Tensor
    Y: torch.Tensor
    size: int
    count: int
    checked: set

    def request(self, i: int):
        a = (i % self.count) * self.size
        return self.X[a:a + self.size], self.Y[a:a + self.size]


def request_pool(mix: dict, cfg: dict, seed: int, device) -> Pool:
    """``pool_requests`` requests of ``size`` points each, every seed the
    same work; the check compares ``check.sample`` of them drawn from the
    seed (every run serves the whole pool)."""
    size, count = mix["size"], mix["pool_requests"]
    g = generator(seed, REQUESTS, device)
    X = _inputs(mix, cfg, size * count, g, device)
    Y = _targets(mix, cfg, X, g)
    pick = generator(seed, SAMPLE, device)
    checked = torch.randperm(count, generator=pick, device=device)
    return Pool(X, Y, size, count, set(checked[:mix["check"]["sample"]]
                                       .tolist()))
