"""Multi-rank training on torch.distributed: the port of
modulatedgps_tpu/parallel/.

Each rank is a process holding one device; the mesh is a
``torch.distributed.DeviceMesh`` with axes ("data", "expert"); NCCL on
CUDA devices, gloo on the CPU.  Data-parallel and expert-sharded training
(sharded.py, mesh.py), the distributed blocked Cholesky and solve
(blocked.py), inducing-sharded training (inducing.py) and process-group
start-up (multihost.py), on the differentiable collectives of
collectives.py, whose docstring states the gradient convention.
"""
from .blocked import distributed_cholesky, distributed_solve_lower
from .inducing import (ShardedSVGP, inducing_gather_state, inducing_shard_state,
                       inducing_sharded_elbo, inducing_sharded_elbo_from_noise,
                       inducing_sharded_predict_f,
                       make_inducing_sharded_train_step)
from .mesh import expert_shard_state, make_mesh, replicate_state, shard_batch
from .multihost import global_mesh, initialize_multihost, is_coordinator
from .sharded import (data_parallel_elbo, data_parallel_elbo_from_noise,
                      make_parallel_train_step)

__all__ = [
    "make_mesh", "shard_batch", "replicate_state", "expert_shard_state",
    "make_parallel_train_step", "data_parallel_elbo",
    "distributed_cholesky", "distributed_solve_lower",
    "inducing_shard_state", "inducing_sharded_elbo",
    "inducing_sharded_predict_f", "make_inducing_sharded_train_step",
    "data_parallel_elbo_from_noise", "inducing_sharded_elbo_from_noise",
    "inducing_gather_state", "ShardedSVGP", "initialize_multihost",
    "global_mesh", "is_coordinator",
]
