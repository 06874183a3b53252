"""Multi-process setup and the rule every data-parallel path keeps (port of
ctseg_tpu/parallel/distributed.py).

One process a device. `initialize` starts torch.distributed from torchrun's
environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) or from
explicit arguments; without either it is a documented no-op, as the JAX
`initialize` is on a plain single host:

    torchrun --nproc_per_node 4 -m ctseg_tpu_torch train --n_devices 4 ...

The backend is NCCL for CUDA devices. gloo is taken only when the caller
asks for it or the devices are CPUs (the tests). A backend that is not
available raises; nothing falls back to the CPU.

The invariant (the JAX package gets it from pjit, which computes every batch
reduction over the global batch): the update every rank applies equals the
single-process update on the global batch, at the same parameters and the
same draws. So each rank's loss is its additive share of the global batch's
loss. The losses all-reduce their normalisers first (class counts and
`any_inf`, `n_valid`, sum(w_y), Focal's count, voxel counts; they carry no
gradient), and the ranks then SUM their gradients (`sum_gradients`). That
is not DistributedDataParallel: DDP averages gradients, and it would need
the loss scaled by the world size, or a comm hook that sums, to keep the
rule. One all_reduce of the flattened gradients after the backward is the
whole of it here; overlapping it with the backward, as DDP's buckets do, is
later work.
"""

import os
from typing import Optional

import torch
import torch.distributed as dist

from ctseg_tpu_torch.parallel.mesh import Mesh, make_mesh


def initialize(backend: Optional[str] = None,
               init_method: Optional[str] = None,
               rank: Optional[int] = None,
               world_size: Optional[int] = None,
               device="cuda") -> bool:
    """Start torch.distributed; returns whether a process group is up.

    Arguments given win over the environment. Without a world size from
    either, or with a world of one and no backend asked for, it does
    nothing and returns False. `backend` defaults to NCCL for a CUDA
    `device` (each rank then takes cuda:LOCAL_RANK) and to gloo for the
    CPU."""
    if dist.is_initialized():
        return True
    env = os.environ
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if world_size is None or (world_size <= 1 and backend is None):
        return False
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl":
        if not (torch.cuda.is_available() and dist.is_nccl_available()):
            raise RuntimeError("the NCCL backend needs CUDA devices and a "
                               "PyTorch built with NCCL")
        torch.cuda.set_device(local_device(device))
    elif backend == "gloo" and not dist.is_gloo_available():
        raise RuntimeError("the gloo backend is not available")
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank or 0, world_size=world_size)
    return True


def local_device(device="cuda") -> torch.device:
    """This rank's device: cuda:LOCAL_RANK for a bare "cuda" under torchrun,
    else `device` as given."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return device


def global_mesh() -> Mesh:
    """The 1-D mesh over every rank of every host."""
    return make_mesh()


def host_local_batch_to_global(batch, mesh: Mesh):
    """(batch, global rows): each rank passes its own rows of the global
    batch, all of one size; returns them as they are, with the global
    batch's size."""
    first = batch if torch.is_tensor(batch) else batch[0]
    rows = torch.tensor([first.shape[0]], device=first.device)
    sizes = [torch.zeros_like(rows) for _ in range(dist.get_world_size(
        mesh.data))]
    dist.all_gather(sizes, rows, group=mesh.data)
    sizes = [int(s) for s in sizes]
    if len(set(sizes)) != 1:
        raise ValueError(f"the ranks hold batches of unequal sizes {sizes}")
    return batch, sum(sizes)


def sum_gradients(params, group) -> None:
    """Sum every parameter's gradient over the ranks of `group`, in place:
    one all_reduce of their concatenation. A parameter without a gradient
    contributes zeros (every rank must send the same layout)."""
    params = [p for p in params if p.requires_grad]
    if not params:
        return
    flat = torch.cat([
        (p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
        for p in params])
    dist.all_reduce(flat, group=group)
    offset = 0
    for p in params:
        total = flat[offset:offset + p.numel()].view(p.shape)
        if p.grad is None:
            p.grad = total.clone()
        else:
            p.grad.copy_(total)  # keeps the gradient's memory format
        offset += p.numel()


def mesh_from_flags(n_devices: Optional[int] = None,
                    spatial_devices: int = 1, device="cuda"):
    """(mesh or None, this rank's device) for an entry point's
    --n_devices / --spatial_devices: starts torch.distributed from torchrun's
    environment (`initialize`). `n_devices`, where given, must be the world
    size; a world of one rank and no depth sharding is no mesh."""
    started = initialize(device=device)
    world = dist.get_world_size() if started else 1
    if n_devices is not None and n_devices != world:
        raise SystemExit(
            f"--n_devices {n_devices} in a world of {world} ranks: launch "
            f"with torchrun --nproc_per_node {n_devices}")
    if spatial_devices < 1 or world % spatial_devices:
        raise SystemExit(f"--spatial_devices {spatial_devices} does not "
                         f"divide the world of {world} ranks")
    if not started:
        return None, torch.device(device)
    from ctseg_tpu_torch.parallel.mesh import make_spatial_mesh

    mesh = (make_mesh(world) if spatial_devices == 1
            else make_spatial_mesh(world // spatial_devices, spatial_devices))
    return mesh, local_device(device)
