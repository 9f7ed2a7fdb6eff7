"""The data-parallel and expert-sharded train step and an explicit-collective
ELBO.

Mirrors modulatedgps_tpu/parallel/sharded.py:33-96.  Every rank draws the
noise of the full batch from the same generator state and keeps its own
rows, so a sharded ELBO equals the single-device one up to the order of
the sum over N.

``make_parallel_train_step`` returns the port's step, ``step(model,
generator, X_local, Y_local) -> loss`` (the global loss), for a model
placed by ``replicate_state`` or ``expert_shard_state`` with the optimizer
built after the placement.  Each rank takes the backward of its share of
the loss (collectives.py): the data fit of its rows over N, and the KL over
the ranks that hold it.  The replicated step then runs exactly one
collective: one all-reduce over "data" of a flat buffer holding every
gradient and the loss share.  The expert-sharded step gathers the local
experts' marginals over "expert" before the Gumbel-softmax and the
likelihood, sums the gradients of the sharded leaves over "data" and those
of the replicated leaves (Z, the kernel hyperparameters) over both axes.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.func import functional_call

from .collectives import all_gather, psum
from .mesh import axis_group, expert_dim, expert_sharded

__all__ = ["make_parallel_train_step", "data_parallel_elbo",
           "data_parallel_elbo_from_noise"]


def _local_rows(z, g, index, n_local):
    rows = slice(index * n_local, (index + 1) * n_local)
    return z[:, rows], g[:, rows]


def _full_noise(model, generator, n_total, dtype):
    return model.draw_noise(generator, n_total, model.num_samples, dtype)


def data_parallel_elbo(model, generator: torch.Generator, X_local, Y_local,
                       mesh: DeviceMesh) -> torch.Tensor:
    """The SMGP ELBO of the global batch (the same on every rank), with
    the batch sharded over "data" and the model replicated: each rank's
    conditionals, expectations and S-sample logsumexp on its rows, one
    ``psum`` of the data-fit sum, the KL on the replicated state.  Its
    backward follows the sum over ranks (collectives.py): take the backward
    of ``share(elbo, group)`` on each rank."""
    n_total = X_local.shape[0] * axis_group(mesh, "data")[2]
    z, g = _full_noise(model, generator, n_total, X_local.dtype)
    return data_parallel_elbo_from_noise(model, X_local, Y_local, z, g, mesh)


def data_parallel_elbo_from_noise(model, X_local, Y_local, z, g,
                                  mesh: DeviceMesh) -> torch.Tensor:
    """data_parallel_elbo with the full batch's noise z, g [S, N, K] given
    (this rank keeps its rows)."""
    group, index, size = axis_group(mesh, "data")
    n_local = X_local.shape[0]
    n_total = n_local * size
    if z.shape[1] != n_total:
        raise ValueError(f"noise for {z.shape[1]} points, the sharded batch "
                         f"holds {n_total}")
    z, g = _local_rows(z, g, index, n_local)
    e = model.E_log_p_Y_from_noise(X_local, Y_local, z, g)       # [N_local]
    fit = psum(e.sum(), group) / n_total
    kl = model.pred_layer.prior_kl() + model.assign_layer.prior_kl()
    return fit - kl / model.num_data


class _DataFit(nn.Module):
    """E_log_p_from_marginals as a forward, for functional_call."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, *args):
        return self.model.E_log_p_from_marginals(*args)


def _expert_data_fit(model, X, Y, z, g, group):
    """Data fit per point [N_local] from this rank's experts: the local
    marginals [N_local, K / E] of both layers and the likelihood's
    per-expert leaves gathered over "expert", then the Gumbel-softmax and
    the expectations over all K."""
    marginals = [all_gather(t, group, dim=-1)
                 for layer in (model.pred_layer, model.assign_layer)
                 for t in model._marginals(layer, X)]
    fmu, fvar, amu, avar = marginals
    gathered = {f"model.{name}": all_gather(p, group, dim=dim)
                for name, p in model.named_parameters()
                if name.split(".")[0] == "likelihood"
                and (dim := expert_dim(name, p.ndim)) is not None}
    return functional_call(_DataFit(model), gathered,
                           (fmu, fvar, amu, avar, z, g, Y))


def make_parallel_train_step(optimizer, mesh: DeviceMesh, *, K: int,
                             shard_experts: bool = False,
                             shard_inducing: bool = False):
    """step(model, generator, X_local, Y_local) -> the global loss.

    ``optimizer`` is the port's Adam over the placed model: replicated
    (``replicate_state``), with its experts sharded over "expert"
    (``shard_experts``, ``expert_shard_state``; replication where K is not
    a multiple of the expert axis), or, with ``shard_inducing``, its
    inducing state sharded over "data" (inducing.py's step).  X_local and
    Y_local are this rank's rows (``shard_batch``); the generator is seeded
    alike on every rank."""
    if shard_inducing:
        if shard_experts:
            raise ValueError("shard_experts and shard_inducing shard q_sqrt "
                             "on different axes — pick one")
        from .inducing import make_inducing_sharded_train_step
        return make_inducing_sharded_train_step(optimizer, mesh)

    experts = shard_experts and expert_sharded(mesh, K)
    data, d_index, d_size = axis_group(mesh, "data")
    expert, _, e_size = axis_group(mesh, "expert")
    params = optimizer.params
    sharded = [experts and expert_dim(n, p.ndim) is not None
               for n, p in zip(optimizer.names, params)]
    # The flat buffer: the replicated leaves' gradients and the loss share
    # (reduced over both axes), then the sharded leaves' ("data" only).
    replicated = [p for p, s in zip(params, sharded) if not s]
    local = [p for p, s in zip(params, sharded) if s]
    head = sum(p.numel() for p in replicated) + 1

    def step(model, generator, X_local, Y_local):
        if experts and model.pred_layer.q_mu.raw.shape[-1] != K // e_size:
            raise ValueError("shard_experts: place the model with "
                             "expert_shard_state before building the step")
        optimizer.zero_grad()
        n_local = X_local.shape[0]
        n_total = n_local * d_size
        z, g = _local_rows(*_full_noise(model, generator, n_total,
                                        X_local.dtype), d_index, n_local)
        if experts:
            e = _expert_data_fit(model, X_local, Y_local, z, g, expert)
            fit = e.mean() * (n_local / n_total) / e_size
        else:
            e = model.E_log_p_Y_from_noise(X_local, Y_local, z, g)
            fit = e.mean() * (n_local / n_total)
        kl = model.pred_layer.prior_kl() + model.assign_layer.prior_kl()
        loss = -(fit - kl / model.num_data / d_size)
        loss.backward()
        flat = torch.cat([*(_grad(p) for p in replicated),
                          loss.detach().reshape(1),
                          *(_grad(p) for p in local)])
        dist.all_reduce(flat, group=data)
        if experts:
            dist.all_reduce(flat[:head], group=expert)
        at = 0
        for p in replicated + [None] + local:
            if p is None:
                at += 1                                 # the loss
                continue
            p.grad = flat[at:at + p.numel()].view_as(p)
            at += p.numel()
        optimizer.step()
        return flat[head - 1].clone()

    return step


def _grad(p: torch.Tensor) -> torch.Tensor:
    return (p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
