"""The operations and bytes a configuration's step or request needs, from
its shapes alone: the model's work, not an implementation's.

- Each product counts once, with a lower-triangular operand as its
  triangle: A^T tril(S_k) is K N M(M+1)/2 multiply-adds, not three bf16
  passes and not a padded square.  A multiply-add is 2 FLOPs.
- Marginals count once, not once per sample; nothing recomputed counts
  (predict_density's second pass over the layers is the served marginals
  again).  A request's outputs need the prediction layer's marginals and
  the assignment layer's mean alone: no output reads that layer's
  variance.
- A training step is three times its forward work (the backward's two
  products per forward product), plus Adam.
- Bytes count the step's or request's true inputs and outputs once each,
  at the narrowest precision their class allows: the parameters read and
  written, the gradients once, Adam's moments read and written, the batch;
  for a request the served caches (the prediction layer's factor inverse in
  float32 and S in bf16, triangles only; Z and q_mu of both layers), the
  inputs and the outputs.  Intermediates do not
  count.
"""
from __future__ import annotations

F32, BF16 = 4, 2


def kernel_entry_flops(D: int) -> int:
    """One SE kernel entry: D scaled differences squared and summed, the
    exponential and the variance."""
    return 3 * D + 2


def layer_forward_flops(M: int, K: int, D: int, N: int) -> float:
    """A whitened SVGP layer's marginals at N points, and its KL."""
    tri = M * (M + 1) // 2
    return (kernel_entry_flops(D) * (tri + M * N)    # Kmm's triangle, Kmn
            + M ** 3 / 3                              # chol(Kmm)
            + M * (M + 1) * N                         # A = L^-1 Kmn
            + 2 * M * N                               # |A|^2
            + 2 * M * N * K                           # A^T q_mu
            + K * N * M * (M + 1)                     # A^T tril(S_k)
            + 2 * K * N * M                           # |A^T tril(S_k)|^2
            + 2 * K * tri + 2 * M * K)                # the KL's sums


def layer_served_flops(M: int, K: int, D: int, n: int) -> float:
    """A cached layer's marginals at n points (no factor, no solve)."""
    return (layer_mean_flops(M, K, D, n) + M * (M + 1) * n + 2 * M * n
            + K * n * M * (M + 1) + 2 * K * n * M)


def layer_mean_flops(M: int, K: int, D: int, n: int) -> float:
    """A cached layer's mean alone at n points: K(Z, X) and K(Z, X)^T q_mu
    (the whitened alpha)."""
    return kernel_entry_flops(D) * M * n + 2 * M * n * K


def likelihood_flops(spec: dict, K: int, n: int) -> float:
    """One expectation (or predictive density) per point and expert."""
    if spec["kind"] == "Gaussian":
        return 8 * n * K
    if spec["kind"] == "MultiClass":
        return 22 * n * K * spec["gauss_hermite_points"]
    raise ValueError(spec["kind"])


def layer_params(M: int, K: int, D: int) -> int:
    return K * M * (M + 1) // 2 + M * K + M * D + 2


def likelihood_params(spec: dict | None, K: int) -> int:
    if spec and spec["kind"] == "Gaussian":
        return K if spec.get("per_expert") else 1
    return 0


def train_step(cfg: dict, batch: int) -> dict:
    M, K, D, S = cfg["M"], cfg["K"], cfg["D"], cfg["S"]
    liks = [cfg["likelihood"]] + ([cfg["assign_likelihood"]]
                                  if cfg.get("assign_likelihood") else [])
    forward = (2 * layer_forward_flops(M, K, D, batch)
               + sum(likelihood_flops(s, K, batch) for s in liks)
               + len(liks) * (12 * S * batch * K + 4 * S * batch))
    params = 2 * layer_params(M, K, D) + sum(likelihood_params(s, K)
                                             for s in liks)
    return {"flops": 3 * forward + 12 * params,
            # p read + written, the gradient, m and v read + written
            "bytes": params * F32 * 7 + batch * (D + 1) * F32}


def request(cfg: dict, n: int) -> dict:
    M, K, D = cfg["M"], cfg["K"], cfg["D"]
    lik = cfg["likelihood"]
    served = layer_served_flops(M, K, D, n) + layer_mean_flops(M, K, D, n)
    if lik["kind"] == "MultiClass":        # predict_y: one quadrature a class
        served += K * likelihood_flops(lik, K, n)
    else:
        served += likelihood_flops(lik, K, n)
    served += 4 * n * K + 12 * n * K        # softmax, mixture density
    tri = M * (M + 1) // 2
    cache = tri * F32 + K * tri * BF16 + 2 * (M * D * F32 + M * K * F32)
    return {"flops": served,
            "bytes": cache + n * (D + 1) * F32 + n * (3 * K + 1) * F32}
