"""Multi-process start-up: the process group and the global mesh.

Mirrors modulatedgps_tpu/parallel/multihost.py:33-72 on torch.distributed.
A multi-process job is started by torchrun (``torchrun --nproc-per-node=N
script.py``), which sets RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT,
LOCAL_RANK and TORCHELASTIC_RUN_ID; each process calls
``initialize_multihost()`` and then ``global_mesh()``.  A single process
with none of those variables is the degenerate case: ``initialize_multihost``
does nothing, and ``mesh.make_mesh`` starts a group of one.

The backend follows the device the caller names: NCCL for ``"cuda"`` (the
default; each process takes the card LOCAL_RANK names), gloo for
``"cpu"``.  A CUDA request without a card raises; nothing falls back to
gloo or to the CPU.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

__all__ = ["initialize_multihost", "global_mesh", "is_coordinator",
           "backend_for"]

# Variables torchrun sets in every process of a job.
_MULTIPROC_ENV_MARKERS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "LOCAL_RANK",
                          "TORCHELASTIC_RUN_ID")


def backend_for(device) -> str:
    """"nccl" for a CUDA device, "gloo" for the CPU; RuntimeError for a CUDA
    device when torch sees no card."""
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' needs an NVIDIA card and torch "
                               "sees none; pass device='cpu' for gloo")
        return "nccl"
    if kind == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for device {device!r}")


def check_backend(device) -> str:
    """backend_for(device), and ValueError if a process group already runs
    another backend."""
    backend = backend_for(device)
    if dist.is_initialized() and dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, "
                         f"device {device!r} needs {backend}")
    return backend


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         force: bool = False, device="cuda") -> None:
    """Start the default process group when running multi-process.

    With no arguments a multi-process job is detected from torchrun's
    variables and the group starts from them (``env://``).
    ``coordinator_address`` is ``host:port`` (TCP) or a URL such as
    ``file:///path/to/store``; ``num_processes`` and ``process_id`` are the
    world size and this process's rank (default: WORLD_SIZE and RANK).
    ``force=True`` starts the group without any marker.  On CUDA the process
    first takes the card LOCAL_RANK names (default: its rank modulo the
    cards).  A single process with nothing set is a no-op, and so is a
    second call.
    """
    if dist.is_initialized():
        check_backend(device)
        return
    env_multiproc = any(v in os.environ for v in _MULTIPROC_ENV_MARKERS)
    if coordinator_address is None and num_processes is None \
            and not env_multiproc and not force:
        return
    backend = backend_for(device)
    rank = int(os.environ.get("RANK", 0)) if process_id is None else process_id
    world = (int(os.environ.get("WORLD_SIZE", 1)) if num_processes is None
             else num_processes)
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)


def start_single_process(device) -> None:
    """A process group of one on an in-process store, where none runs yet
    (the single-process case of make_mesh)."""
    backend = check_backend(device)
    if not dist.is_initialized():
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


def global_mesh(num_expert: int = 1, device="cuda"):
    """The ("data", "expert") mesh over every process of the job."""
    from .mesh import make_mesh
    return make_mesh(num_expert=num_expert, device=device)


def is_coordinator() -> bool:
    """True on rank 0, and in a process with no group."""
    return not dist.is_initialized() or dist.get_rank() == 0
