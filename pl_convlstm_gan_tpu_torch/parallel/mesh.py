"""The process group of data-parallel training and its helpers.

Counterpart of the JAX package's ``parallel/mesh.py``. JAX runs one process
per host over a mesh of its devices; PyTorch runs one process (a rank) per
GPU, launched by ``torchrun``, in one process group. The 1-D data mesh is
that group: ``mesh.data_axis`` is its size (0: the world size, as JAX's 0
is every device). A rank cannot sit out the collectives of a step, so a
``data_axis`` that is neither 0 nor the world size is refused.

- ``maybe_init_distributed`` joins the process group when the environment
  names one: torchrun's ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` (with
  ``MASTER_PORT`` and ``LOCAL_RANK``), or the JAX package's
  ``COORDINATOR_ADDRESS`` (host:port) / ``NUM_PROCESSES`` / ``PROCESS_ID``;
  without them it does nothing. The backend is NCCL for CUDA and gloo for
  the CPU, unless ``backend`` says otherwise; on CUDA each rank takes
  ``cuda:LOCAL_RANK``.
- ``data_group(config, device)`` is the group a trainer's steps reduce
  over (None for one process): it joins the group the environment names
  when nobody has yet, then checks ``mesh.data_axis`` and the batch.
- ``broadcast_module`` makes a module's parameters and buffers rank 0's in
  one broadcast: the replicated initial state.
- ``rank_and_world`` / ``is_primary`` / ``print0`` / ``barrier``: rank 0
  alone prints and writes checkpoints, histories and outputs
  (``utils/metrics_log.is_primary_host`` of the JAX package).

Usage:
    torchrun --nproc_per_node 8 -m pl_convlstm_gan_tpu_torch --config dp_v5e16
    torchrun --nproc_per_node 2 -m pl_convlstm_gan_tpu_torch \\
        --config ci_smoke_seq --device cpu
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist


def _env_group() -> Optional[Tuple[str, int, int, int]]:
    """(init_method, world, rank, local rank) that the environment names, or
    None."""
    env = os.environ
    if env.get("RANK") and env.get("WORLD_SIZE") and env.get("MASTER_ADDR"):
        return ("env://", int(env["WORLD_SIZE"]), int(env["RANK"]),
                int(env.get("LOCAL_RANK", 0)))
    addr = env.get("COORDINATOR_ADDRESS")
    if addr and env.get("NUM_PROCESSES") and env.get("PROCESS_ID"):
        return (f"tcp://{addr}", int(env["NUM_PROCESSES"]),
                int(env["PROCESS_ID"]), int(env.get("LOCAL_RANK", 0)))
    return None


def maybe_init_distributed(device=None, backend: Optional[str] = None) -> bool:
    """Join the process group the environment names (see the module
    docstring); a no-op without one, or when already joined. ``device``
    is the run's device (None: the GPU; "cpu" picks gloo); ``backend``
    overrides the choice (gloo also carries CUDA tensors, which lets two
    ranks share one GPU, where NCCL refuses). Call it before anything
    touches the device. Returns whether a process group is up."""
    if dist.is_initialized():
        return True
    found = _env_group()
    if found is None:
        return False
    init_method, world, rank, local_rank = found
    on_cpu = device is not None and torch.device(device).type == "cpu"
    backend = backend or ("gloo" if on_cpu else "nccl")
    if not on_cpu:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the port trains on the GPU; "
                               "pass --device cpu to train on the CPU (gloo)")
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)
    return True


def rank_and_world() -> Tuple[int, int]:
    """(rank, world size) of the process group; (0, 1) without one."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def is_primary() -> bool:
    """Whether this process writes the run's files: rank 0, or the only
    process."""
    return rank_and_world()[0] == 0


def print0(*args, **kwargs) -> None:
    """``print`` on rank 0 alone (the only process without a group)."""
    if is_primary():
        print(*args, **kwargs)


def barrier() -> None:
    """Wait for every rank (nothing to wait for without a group)."""
    if dist.is_initialized():
        dist.barrier()


def data_group(config, device=None):
    """The process group the data-parallel steps of ``config`` reduce over,
    or None for one process. Joins the group the environment names first
    (``maybe_init_distributed(device)``), so that a trainer built under
    torchrun without the CLI trains data-parallel too, and never as one of
    N independent runs. Refuses a ``mesh.data_axis`` that is neither 0 nor
    the world size, and a batch the ranks cannot split evenly."""
    n = config.mesh.data_axis
    if not maybe_init_distributed(device):
        if n > 1:
            raise ValueError(
                f"mesh.data_axis {n} needs {n} ranks: launch with torchrun "
                f"--nproc_per_node {n} (one process per GPU)")
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0 and visible > 1:
            print(f"Warning: mesh.data_axis 0 (every rank) in a single "
                  f"process: training on one of {visible} visible GPUs; "
                  f"launch with torchrun --nproc_per_node {visible} to train "
                  f"on all of them")
        return None
    world = dist.get_world_size()
    if n not in (0, world):
        raise ValueError(
            f"mesh.data_axis {n} does not match the {world} ranks of the "
            f"process group: every rank runs the data-parallel step (a rank "
            f"cannot sit out its collectives); set it to 0 or {world}")
    bs = config.training.batch_size
    if bs % world:
        raise ValueError(f"batch_size {bs} (the global batch) is not "
                         f"divisible by the {world} ranks")
    return dist.group.WORLD


def broadcast_module(module: torch.nn.Module, group=None) -> None:
    """Make ``module``'s parameters and buffers those of the group's rank 0
    (nothing without a group), in one broadcast of one flat buffer per
    dtype."""
    if group is None:
        return
    tensors = [*module.parameters(), *module.buffers()]
    src = dist.get_global_rank(group, 0)
    for dtype in sorted({t.dtype for t in tensors}, key=str):
        same = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.detach().reshape(-1) for t in same])
        dist.broadcast(flat, src=src, group=group)
        with torch.no_grad():
            for t, f in zip(same, flat.split([t.numel() for t in same])):
                t.copy_(f.view_as(t))
