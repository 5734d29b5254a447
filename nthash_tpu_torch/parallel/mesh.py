"""Process groups and device meshes over ``torch.distributed``.

Counterpart of ``nthash_tpu/parallel/mesh.py``. The framework has two
parallel axes:
- "reads": data parallelism over independent reads (``parallel/dp.py``);
- "seq": sequence parallelism over position for genome-scale sequences
  (``parallel/sp.py``).

The JAX package drives every device of a host from one process and names
mesh axes on a ``jax.sharding.Mesh``. Here one process owns one GPU, a
``torch.distributed`` process group joins the processes, and a
one-dimensional ``DeviceMesh`` over that group stands in for the JAX mesh.
Each function of ``dp``/``sp`` takes this process's part of the data and
returns this process's part of the result; the sketch and the Bloom filter
come back merged on every rank.

The backend follows the device: NCCL for CUDA, gloo for the CPU. A caller
may name the backend (gloo over CUDA tensors runs several ranks on one
card); NCCL is never replaced by gloo without the caller asking. Every
collective here is an all-reduce or an all-gather, which both backends take
on CUDA and CPU tensors alike; gloo's point-to-point send and receive do not
take CUDA tensors.

One difference from the JAX package: ``device_mesh(n)`` there may take the
first n devices of the process, but a process here cannot form a mesh of
devices that other processes own, so a mesh spans the whole group and any
other ``n_devices`` than the world size raises.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

READS_AXIS = "reads"
SEQ_AXIS = "seq"


def world_size() -> int:
    """Processes in the default group, or 1 when there is no group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank_device(device="cuda", rank: int | None = None) -> torch.device:
    """This process's device: a CUDA device without an index becomes the
    one of ``LOCAL_RANK`` (set by launchers such as torchrun), else of the
    rank, modulo the GPUs the process sees."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("no CUDA device is visible to this process")
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % count)


def initialize_distributed(device="cuda", **kwargs) -> None:
    """Join this process to the default process group
    (``dist.init_process_group(**kwargs)``): the rendezvous comes from
    ``kwargs`` (``init_method``, ``store``, ``rank``, ``world_size``) or
    from the launcher's environment (``env://``).

    The backend follows ``device`` unless ``kwargs`` names one: "nccl" for
    CUDA, "gloo" for the CPU. NCCL missing from this build raises; it is
    never replaced by gloo. On CUDA the rank's device (:func:`rank_device`)
    becomes the current device.

    Idempotent: a second call does nothing. Real initialization failures
    propagate (swallowing them would quietly run a multi-GPU job as one
    process).
    """
    if dist.is_initialized():
        return
    device = torch.device(device)
    backend = kwargs.pop("backend", None) or (
        "nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("the nccl backend is not available in this build "
                           "of PyTorch")
    if device.type == "cuda":
        device = rank_device(device, kwargs.get(
            "rank", int(os.environ.get("RANK", 0))))
        torch.cuda.set_device(device)
        if backend == "nccl":
            kwargs.setdefault("device_id", device)
    dist.init_process_group(backend, **kwargs)


def device_mesh(n_devices: int | None = None, axis: str = READS_AXIS,
                device_type: str | None = None) -> DeviceMesh:
    """1-D mesh named ``axis`` over the whole default group.

    ``n_devices``: None means the world size (1 when no group exists);
    any other value than the world size raises ValueError. With no group,
    a one-process group is formed first on an in-memory store (no
    address, no port). ``device_type`` defaults to "cuda".
    """
    device_type = device_type or "cuda"
    n = world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(
            f"n_devices={n_devices}: a mesh spans the whole process group "
            f"({n} process(es), one device each); start one process per "
            "device and call initialize_distributed")
    if not dist.is_initialized():
        initialize_distributed(device_type, store=dist.HashStore(), rank=0,
                               world_size=1)
    return init_device_mesh(device_type, (n,), mesh_dim_names=(axis,))


def group_of(mesh_or_group) -> dist.ProcessGroup:
    """The process group of a 1-D ``DeviceMesh``, or the group itself."""
    if isinstance(mesh_or_group, DeviceMesh):
        return mesh_or_group.get_group()
    return mesh_or_group


def size_and_rank(mesh_or_group) -> tuple[int, int]:
    """(ranks in the mesh or group, this process's rank in it)."""
    group = group_of(mesh_or_group)
    return dist.get_world_size(group), dist.get_rank(group)


def all_reduce_sum(tensor: torch.Tensor, mesh_or_group) -> torch.Tensor:
    """Sum ``tensor`` over the group in place (integers wrap, as ``psum``
    does) and return it."""
    dist.all_reduce(tensor, group=group_of(mesh_or_group))
    return tensor


def all_gather(tensor: torch.Tensor, mesh_or_group) -> torch.Tensor:
    """Every rank's ``tensor`` stacked in rank order: [ranks, *shape]."""
    group = group_of(mesh_or_group)
    out = tensor.new_empty((dist.get_world_size(group), *tensor.shape))
    dist.all_gather(list(out.unbind(0)), tensor.contiguous(), group=group)
    return out
