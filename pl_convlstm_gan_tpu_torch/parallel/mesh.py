"""The process groups of parallel training and their helpers.

Counterpart of the JAX package's ``parallel/mesh.py``. JAX runs one process
per host over a mesh of its devices; PyTorch runs one process (a rank) per
GPU, launched by ``torchrun``, in one process group. The 1-D data mesh is
that group: ``mesh.data_axis`` is its size (0: the world size, as JAX's 0
is every device). A rank cannot sit out the collectives of a step, so a
``data_axis`` that is neither 0 nor the world size is refused.

The 2-D (data, model) mesh of tensor parallelism (``mesh.model_axis`` m >
1) cuts the world model-minor, as ``make_mesh_2d`` reshapes the devices:
rank r sits at data index r // m and model index r % m. Its model group
(the m ranks of one data index) shards every ConvLSTM cell's channels
(``tensor_parallel.py``); its data group (the d = world / m ranks of one
model index) averages the gradients of equal shards. ``mesh.data_axis`` is
then d (0: world / m); an m that does not divide the world is refused (the
rest of the ranks would sit idle), and so is a data axis other than 0 or d.

- ``maybe_init_distributed`` joins the process group when the environment
  names one: torchrun's ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` (with
  ``MASTER_PORT`` and ``LOCAL_RANK``), or the JAX package's
  ``COORDINATOR_ADDRESS`` (host:port) / ``NUM_PROCESSES`` / ``PROCESS_ID``;
  without them it does nothing. The backend is NCCL for CUDA and gloo for
  the CPU, unless ``backend`` says otherwise; on CUDA each rank takes
  ``cuda:LOCAL_RANK``.
- ``train_group(config, device)`` is what a trainer's steps take: None for
  one process, else ``MeshGroups(data, model, every)`` (data parallelism
  alone: the world, None, the world). It joins the group the environment
  names when nobody has yet, then checks ``mesh.data_axis`` and the batch.
  Every rank creates every group, in one order (``dist.new_group`` is
  collective). ``as_groups`` takes a step's ``group`` (None, a process
  group, or ``MeshGroups``) to ``MeshGroups``.
- ``broadcast_module`` makes a module's parameters and buffers rank 0's in
  one broadcast: the replicated initial state (under tensor parallelism the
  shards over the data group).
- ``rank_and_world`` / ``mesh_position`` / ``is_primary`` / ``print0`` /
  ``barrier``: rank 0 alone prints and writes checkpoints, histories and
  outputs (``utils/metrics_log.is_primary_host`` of the JAX package).

Usage:
    torchrun --nproc_per_node 8 -m pl_convlstm_gan_tpu_torch --config dp_v5e16
    torchrun --nproc_per_node 2 -m pl_convlstm_gan_tpu_torch \\
        --config ci_smoke_seq --device cpu
    torchrun --nproc_per_node 2 -m pl_convlstm_gan_tpu_torch \\
        --config tp_nowcast_128
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional, Tuple

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


class MeshPosition(NamedTuple):
    """A rank's place in the model-minor (data, model) layout."""
    data_index: int
    data_count: int
    model_index: int
    model_count: int


def mesh_position(model_axis: int = 1) -> MeshPosition:
    """This rank's data and model index and the counts of each, for a model
    axis of m = ``model_axis`` ranks: rank r at (r // m, r % m); (0, 1, 0,
    1) for one process."""
    rank, world = rank_and_world()
    m = model_axis
    return MeshPosition(rank // m, world // m, rank % m, m)


class MeshGroups(NamedTuple):
    """The groups of a parallel step: ``data`` (the ranks of this model
    index, over which the shards' gradients, the loss decision and the
    metrics are reduced; None with one data replica), ``model`` (the ranks
    of this data index, which shard the cells; None without tensor
    parallelism) and ``every`` (all ranks of the layout, over which the
    gradients of replicated parameters are averaged). Data parallelism
    alone is (world, None, world)."""
    data: Optional[object]
    model: Optional[object]
    every: Optional[object]


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


def _world_for(config, device) -> Optional[int]:
    """The world size after joining the group the environment names (None
    without one, after refusing a mesh that needs ranks)."""
    d, m = config.mesh.data_axis, config.mesh.model_axis
    if maybe_init_distributed(device):
        return dist.get_world_size()
    if m > 1:
        raise ValueError(
            f"mesh.model_axis {m} (tensor parallelism) needs {m * max(d, 1)} "
            f"ranks: launch with torchrun --nproc_per_node "
            f"{m * max(d, 1)} (one process per GPU)")
    if d > 1:
        raise ValueError(
            f"mesh.data_axis {d} needs {d} ranks: launch with torchrun "
            f"--nproc_per_node {d} (one process per GPU)")
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if d == 0 and visible > 1:
        print(f"Warning: mesh.data_axis 0 (every rank) in a single "
              f"process: training on one of {visible} visible GPUs; "
              f"launch with torchrun --nproc_per_node {visible} to train "
              f"on all of them")
    return None


def _data_count(config, world: int) -> int:
    """The data axis of ``config`` at ``world`` ranks, after the refusals
    of the module docstring (and a global batch the replicas cannot split
    evenly)."""
    n, m = config.mesh.data_axis, config.mesh.model_axis
    if world % m:
        raise ValueError(
            f"mesh.model_axis {m} does not divide the {world} ranks of the "
            f"process group: {world % m} would sit idle (a rank cannot sit "
            f"out the collectives); launch a multiple of {m} ranks")
    d = world // m
    if n not in (0, d):
        what = ("does not match the" if m == 1 else
                f"times mesh.model_axis {m} does not match the")
        raise ValueError(
            f"mesh.data_axis {n} {what} {world} ranks of the process group: "
            f"every rank runs the step (a rank cannot sit out its "
            f"collectives); set it to 0 or {d}")
    bs = config.training.batch_size
    if bs % d:
        raise ValueError(f"batch_size {bs} (the global batch) is not "
                         f"divisible by the {d} ranks" if m == 1 else
                         f"batch_size {bs} (the global batch) is not "
                         f"divisible by the {d} data replicas")
    return d


def train_group(config, device=None) -> Optional["MeshGroups"]:
    """The groups a trainer's steps take as ``group``: None for one process,
    else ``MeshGroups``. Joins the group the environment names first
    (``maybe_init_distributed(device)``), so that a trainer built under
    torchrun without the CLI trains in parallel too, and never as one of N
    independent runs. Refuses what the module docstring says (and a batch
    the data replicas cannot split evenly). Data parallelism alone is
    ``MeshGroups(WORLD, None, WORLD)``; under tensor parallelism every rank
    creates the m data groups (when d > 1), then the d model groups, in
    that order."""
    world = _world_for(config, device)
    if world is None:
        return None
    d, m = _data_count(config, world), config.mesh.model_axis
    every = dist.group.WORLD
    if m == 1:
        return MeshGroups(every, None, every)
    rank = dist.get_rank()
    data = None
    if d > 1:
        data = [dist.new_group([r * m + j for r in range(d)])
                for j in range(m)][rank % m]
    model = [dist.new_group(list(range(r * m, (r + 1) * m)))
             for r in range(d)][rank // m]
    return MeshGroups(data, model, every)


def as_groups(group) -> "MeshGroups":
    """A step's ``group`` as ``MeshGroups``: None (one process) as no group
    at all, a process group (data parallelism over it) as ``MeshGroups(
    group, None, group)``, ``MeshGroups`` as it is."""
    if isinstance(group, MeshGroups):
        return group
    return MeshGroups(group, None, group)


def _broadcast(tensors, group) -> None:
    src = dist.get_global_rank(group, 0)
    for dtype in sorted({t.dtype for t in tensors}, key=str):
        same = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.detach().reshape(-1) for t in same])
        dist.broadcast(flat, src=src, group=group)
        with torch.no_grad():
            for t, f in zip(same, flat.split([t.numel() for t in same])):
                t.copy_(f.view_as(t))


def broadcast_module(module: torch.nn.Module, group=None) -> None:
    """Make ``module``'s parameters and buffers those of rank 0 (nothing
    without a group), in one broadcast of one flat buffer per dtype: the
    replicated ones from rank 0 of every rank, the shards (``tp_sharded``
    parameters) from rank 0 of the data group (nothing to do with one data
    replica). ``group`` is a step's (``as_groups``)."""
    g = as_groups(group)
    tensors = [*module.parameters(), *module.buffers()]
    for shard, grp in ((True, g.data), (False, g.every)):
        part = [t for t in tensors if getattr(t, "tp_sharded", False) == shard]
        if part and grp is not None:
            _broadcast(part, grp)
