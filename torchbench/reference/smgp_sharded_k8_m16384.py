"""The plain reference of smgp_sharded_k8_m16384: the SMGP of
smgp_gauss_k8_m4096's reference (Gaussian experts, whitened SE layers),

    loss = -( mean_n[ logsumexp_S( sum_k VE_k(n) W_snk ) - log S ]
              - (KL_pred + KL_assign) / num_data ),

with its gradients and Adam, at a size no one card holds in float64: a
q_sqrt is 17 GB a layer, and Adam's moments and the change norms need four
such copies.  So the ranks of the cell share the work.  Rank r of P holds
the columns [r M / P, (r + 1) M / P) of each layer's q_sqrt and everything
else whole, and computes the same readings as the others.  Each departure
from a one-shot forward and backward:

- The q_sqrt term |A^T tril(S_k)|^2, summed over the columns of S_k, is a
  sum over column blocks: each rank adds its block's part for every point
  and expert, and one all-reduce over the ranks completes it.  So are the
  KL's sum of tril(S)^2 and its log-diagonal.  A = chol(Kmm)^-1 Kmn and
  everything that follows from the layers' marginals are computed whole on
  every rank.
- The q_sqrt term is taken expert by expert and twice: once without
  autograd for its value, and once more, after the loss's backward has
  given the gradient of the marginals, with autograd for the pullback to
  that expert's block and to A.  The KL's sums of a block go with it.
- A's gradient is then the loss's own part, the same on every rank, plus
  the q_sqrt terms' parts, summed over the ranks by an all-reduce, and is
  pulled back through the factor and the solve.
- Kernel matrices are built in blocks of rows by differences, each block
  recomputed in the backward (torch.utils.checkpoint).
- Adam runs one expert's block at a time.

Nothing here is the program's: torch.linalg's Cholesky and triangular
solve, dense matmuls and torch.distributed's all_reduce.  TF32 is off for
the reference (``_plain.Precision``).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from torchbench.reference import _plain

LAYERS = ("pred_layer", "assign_layer")
ROWS = 1024          # rows of a kernel matrix built at a time


def _kernel(A, B, variance, lengthscale):
    """_plain.se_kernel(A, B, ...) built ROWS rows at a time."""
    return torch.cat([checkpoint(_plain.se_kernel, A[i:i + ROWS], B,
                                 variance, lengthscale, use_reentrant=False)
                      for i in range(0, A.shape[0], ROWS)])


def _variance(p: dict, layer: str):
    return _plain.softplus(p[f"{layer}.kernel.variance.raw"])


def _solve(p: dict, layer: str, X, cfg: dict):
    """A = chol(Kmm + jitter I)^-1 Kmn, with a graph of its own."""
    var = _variance(p, layer)
    ls = _plain.softplus(p[f"{layer}.kernel.lengthscales.raw"])
    Z = p[f"{layer}.Z.raw"]
    Kmm = _kernel(Z, Z, var, ls)
    Kmm.diagonal().add_(cfg["jitter"])
    L = torch.linalg.cholesky(Kmm)
    del Kmm
    return torch.linalg.solve_triangular(L, _kernel(Z, X, var, ls),
                                         upper=False)


def _lower(S_k, col0: int):
    """S_k [M, w] holding global columns col0.. with the entries above the
    global diagonal set to 0."""
    M, w = S_k.shape
    rows = torch.arange(M, device=S_k.device)[:, None]
    cols = col0 + torch.arange(w, device=S_k.device)[None, :]
    return S_k * (rows >= cols).to(S_k.dtype)


def _diag(S_k, col0: int):
    """The entries of S_k on the global diagonal: [w]."""
    w = S_k.shape[1]
    return S_k[col0 + torch.arange(w, device=S_k.device),
               torch.arange(w, device=S_k.device)]


def _block_terms(S_k, A, col0: int):
    """This block's parts of the q_sqrt term [N], of sum tril(S)^2 and of
    sum log|diag S|."""
    T = _lower(S_k, col0)
    quad = (A.T @ T).square().sum(1)
    return quad, T.square().sum(), _diag(S_k, col0).abs().log().sum()


def _summed(t, group):
    """``t`` summed over the ranks (a contiguous copy where it is not)."""
    t = t.contiguous()
    dist.all_reduce(t, group=group)
    return t


def _step(p: dict, cfg: dict, X, Y, z, u, group):
    """(loss, gradients) of one step; a q_sqrt's gradient is this rank's
    column block, every other leaf's is whole."""
    K, M = cfg["K"], cfg["M"]
    col0 = dist.get_rank(group) * p["pred_layer.q_sqrt.raw"].shape[-1]
    r = {k: t.detach().requires_grad_(True) for k, t in p.items()
         if not k.endswith("q_sqrt.raw")}
    graphs, marg, sums = {}, {}, {}
    for layer in LAYERS:
        A = graphs[layer] = _solve(r, layer, X, cfg)
        Ad = A.detach().requires_grad_(True)
        with torch.no_grad():
            parts = [_block_terms(p[f"{layer}.q_sqrt.raw"][k], Ad, col0)
                     for k in range(K)]
            quad = _summed(torch.stack([q for q, _, _ in parts], 1), group)
            kl = _summed(torch.stack([torch.stack([t for _, t, _ in parts]),
                                      torch.stack([d for _, _, d in parts])]),
                         group)
        quad.requires_grad_(True)
        kl.requires_grad_(True)
        fmean = Ad.T @ r[f"{layer}.q_mu.raw"]
        fvar = ((_variance(r, layer) - Ad.square().sum(0))[:, None]
                + quad).clamp_min(1e-12)
        marg[layer] = (fmean, fvar)
        sums[layer] = (Ad, quad, kl)
    (fmu, fvar), (amu, avar) = marg["pred_layer"], marg["assign_layer"]
    W = _plain.assignment_weights(amu, avar, z, u, cfg)
    s2 = _plain.softplus(r["likelihood.variance.raw"])
    ve = _plain.gaussian_ve(s2, fmu, fvar, Y)
    data = torch.logsumexp((ve[None] * W).sum(2), dim=0) - math.log(z.shape[0])
    kl_total = 0.0
    for layer in LAYERS:
        q_mu, kl = r[f"{layer}.q_mu.raw"], sums[layer][2]
        kl_total = kl_total + 0.5 * (q_mu.square().sum() - M * K
                                     - 2.0 * kl[1].sum() + kl[0].sum())
    loss = -(data.mean() - kl_total / cfg["num_data"])
    loss.backward()
    grads = {}
    for layer in LAYERS:
        Ad, quad, kl = sums[layer]
        direct = Ad.grad.clone()
        Ad.grad = None
        S = p[f"{layer}.q_sqrt.raw"]
        gS = torch.empty_like(S)
        for k in range(K):
            S_k = S[k].detach().requires_grad_(True)
            q, t, d = _block_terms(S_k, Ad, col0)
            ((q * quad.grad[:, k]).sum() + t * kl.grad[0, k]
             + d * kl.grad[1, k]).backward()
            gS[k] = S_k.grad
        grads[f"{layer}.q_sqrt.raw"] = gS
        graphs[layer].backward(direct + _summed(Ad.grad, group))
    grads.update({k: t.grad for k, t in r.items()})
    return float(loss.detach()), grads


def _adam(p, grads, m, v, lr, t):
    """_plain.adam_ over every leaf, a q_sqrt one expert at a time."""
    for k in p:
        parts = (range(p[k].shape[0]) if k.endswith("q_sqrt.raw")
                 else [...])
        for i in parts:
            _plain.adam_(*({k: d[k][i]} for d in (p, grads, m, v)), lr, t)


def _norms(tensors: dict, group) -> dict:
    """Every leaf's norm, a q_sqrt's over the column blocks of all ranks."""
    sq = {k: t.double().square().sum() for k, t in tensors.items()}
    blocks = [k for k in sq if k.endswith("q_sqrt.raw")]
    summed = _summed(torch.stack([sq[k] for k in blocks]), group)
    sq.update(zip(blocks, summed))
    return {k: math.sqrt(float(s)) for k, s in sq.items()}


def train_readings(cfg: dict, blocks: dict, batches: list, noise_seed: int,
                   steps: int, prec: _plain.Precision, group=None) -> dict:
    """_plain.train_readings' numbers (each step's loss, every leaf's
    gradient norm at step 1 and change norm after the last step) from
    ``blocks`` (this rank's column block of each q_sqrt, every other leaf
    whole) and the global batches, on every rank of ``group``."""
    with prec, torch.enable_grad():
        # The start is the given leaves themselves: the reference's copies
        # of them move, and a float32 value is exact in float64.
        start = blocks
        p = {k: t.detach().to(prec.dtype, copy=True) for k, t in start.items()}
        m = {k: torch.zeros_like(t) for k, t in p.items()}
        v = {k: torch.zeros_like(t) for k, t in p.items()}
        device = next(iter(p.values())).device
        gen = torch.Generator(device=device).manual_seed(noise_seed)
        losses, grad_norms = [], {}
        for t in range(steps):
            X, Y = (b.to(prec.dtype) for b in batches[t])
            z, u = _plain.noise(gen, cfg, X.shape[0], prec.dtype)
            loss, grads = _step(p, cfg, X, Y, z, u, group)
            if t == 0:
                grad_norms = _norms(grads, group)
            losses.append(loss)
            with torch.no_grad():
                _adam(p, grads, m, v, cfg["lr"], t + 1)
            del grads
        with torch.no_grad():
            change = _norms({k: p[k] - start[k] for k in p}, group)
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
