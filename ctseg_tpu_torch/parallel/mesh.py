"""Process-group meshes (port of ctseg_tpu/parallel/mesh.py).

A JAX mesh names axes of devices and pjit places the shards. Here every
device belongs to one process, a rank of torch.distributed, and a mesh is
the process groups its axes need:

  - 1-D 'data' mesh (`make_mesh`): data parallelism. Each rank holds its
    rows of every global batch (`batch_sharding`) and the same parameters
    (`replicated`), and sums its gradients with the other ranks'
    (parallel/distributed.py says how).
  - 2-D ('data', 'space') mesh (`make_spatial_mesh`): 3D volumes sharded
    over depth inside each data replica. 'space' is innermost, as in the
    JAX mesh: rank = data_index * n_space + space_index, so the ranks of one
    replica are adjacent and their halo exchanges take the nearest links.

torch.distributed must be initialised first (parallel/distributed.py::
initialize). Every rank builds the same meshes in the same order: making a
process group is collective.
"""

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a ('data'[, 'space']) mesh of processes.

    `world` spans every rank; `data` the ranks that hold the same depth slab
    of different rows (the whole world on a 1-D mesh); `space` the ranks of
    this rank's data replica, in depth order (None on a 1-D mesh), with
    `space_ranks` their global ranks."""

    shape: Dict[str, int]
    rank: int
    world: object
    data: object
    space: Optional[object] = None
    space_ranks: Tuple[int, ...] = ()

    @property
    def size(self) -> int:
        out = 1
        for n in self.shape.values():
            out *= n
        return out

    @property
    def n_space(self) -> int:
        return self.shape.get("space", 1)

    @property
    def data_index(self) -> int:
        return self.rank // self.n_space

    @property
    def space_index(self) -> int:
        return self.rank % self.n_space

    def data_parallel(self) -> "Mesh":
        """Every rank on the data axis: what a 2D trainer makes of a
        ('data', 'space') mesh (the JAX Trainer ignores 'space' in 2D)."""
        return Mesh({"data": self.size}, self.rank, self.world, self.world)


def _world() -> Tuple[int, int]:
    if not dist.is_initialized():
        raise RuntimeError(
            "torch.distributed is not initialised: call "
            "ctseg_tpu_torch.parallel.distributed.initialize() first")
    return dist.get_rank(), dist.get_world_size()


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """The 1-D 'data' mesh over every rank; `n_devices`, where given, must
    be the world size (one device a rank)."""
    rank, world = _world()
    if n_devices is not None and n_devices != world:
        raise ValueError(
            f"a mesh of {n_devices} devices asked for in a world of {world} "
            "ranks (one device a rank: launch that many processes)")
    return Mesh({"data": world}, rank, dist.group.WORLD, dist.group.WORLD)


def make_spatial_mesh(n_data: int, n_space: int) -> Mesh:
    """The ('data', 'space') mesh: batches over 'data', volume depth over
    'space', 'space' innermost."""
    rank, world = _world()
    if n_data * n_space != world:
        raise ValueError(
            f"a {n_data} x {n_space} mesh needs {n_data * n_space} ranks, the "
            f"world has {world}")
    mine = {}
    # new_group is collective: every rank makes every group, in one order.
    for d in range(n_data):
        ranks = list(range(d * n_space, (d + 1) * n_space))
        group = dist.new_group(ranks)
        if rank in ranks:
            mine["space"], mine["space_ranks"] = group, tuple(ranks)
    for s in range(n_space):
        ranks = list(range(s, world, n_space))
        group = dist.new_group(ranks)
        if rank in ranks:
            mine["data"] = group
    return Mesh({"data": n_data, "space": n_space}, rank, dist.group.WORLD,
                mine["data"], mine["space"], mine["space_ranks"])


def _rows(n: int, parts: int, index: int) -> slice:
    if n % parts:
        raise ValueError(f"a batch of {n} does not split into {parts} equal "
                         "shards")
    k = n // parts
    return slice(index * k, (index + 1) * k)


def batch_sharding(mesh: Mesh, batch):
    """This rank's rows of a global batch (a tensor, or a tuple of tensors
    with one leading batch dim): equal shares over 'data', in rank order."""
    index, parts = mesh.data_index, mesh.shape["data"]
    if torch.is_tensor(batch):
        return batch[_rows(batch.shape[0], parts, index)]
    return type(batch)(
        t if t is None else t[_rows(t.shape[0], parts, index)] for t in batch)


def depth_slab(mesh: Mesh, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """This rank's slab of `t` along `dim` over 'space' (all of it on a 1-D
    mesh)."""
    sl = _rows(t.shape[dim], mesh.n_space, mesh.space_index)
    return t.narrow(dim, sl.start, sl.stop - sl.start)


def replicated(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Every parameter and buffer of `module` made rank 0's, in place."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0, group=mesh.world)
    return module

