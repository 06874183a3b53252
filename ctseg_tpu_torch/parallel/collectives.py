"""Collectives with their gradients, the losses' global-batch reductions,
and the depth shard of a 3D activation.

  - `all_sum` sums a tensor that carries no gradient (a normaliser, a
    count) over a group; `all_sum_grad` is the same sum as an
    autograd.Function whose backward sums the cotangents over the group.
  - `all_gather_grad` concatenates the group's slabs along a dim; its
    backward sums the cotangents over the group and keeps this rank's slab.
  - `GlobalBatch` is what the losses and the Dice metric call where the
    JAX package reduces over its (global) batch: `rows` sums over the data
    ranks (per-sample quantities: class counts, n_valid), `voxels` over
    every rank (a sum over every voxel of the batch), `spatial` over the
    space ranks with gradients (a per-sample spatial sum of a depth-sharded
    volume), `spatial_counts` the same for integer counts. Counts that
    follow from shapes are the local ones times `n_data` and `n_space`:
    every rank holds as many rows and voxels. `LOCAL`, the default, is the
    single-process batch: every call is the identity.
  - `DepthShard` is one rank's slab of a depth-sharded 3D activation (N, C,
    H, W, D), D the innermost spatial axis: the halo exchange of a conv
    whose kernel spans depth, the gather of a level computed replicated and
    the slab's share of a replicated result (models/unet.py uses them).

The sums of a collective are taken in the backend's order, so a float sum
differs from the single-process one by round-off; counts are exact.
"""

from typing import Optional, Sequence

import torch
import torch.distributed as dist


def all_sum(t: torch.Tensor, group) -> torch.Tensor:
    """`t` summed over the ranks of `group` (no gradient; a new tensor)."""
    out = t.detach().clone()
    dist.all_reduce(out, group=group)
    return out


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_sum(t, group)

    @staticmethod
    def backward(ctx, g):
        return all_sum(g, ctx.group), None


def all_sum_grad(t: torch.Tensor, group) -> torch.Tensor:
    """`t` summed over `group`; each rank's loss then takes its share of a
    function of the sum, and the backward sums the cotangents."""
    return _AllSum.apply(t, group)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        ctx.index, ctx.size = dist.get_rank(group), t.shape[dim]
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, t, group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        total = all_sum(g.contiguous(), ctx.group)
        return total.narrow(ctx.dim, ctx.index * ctx.size, ctx.size), None, \
            None


def all_gather_grad(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's equal slabs of `t` concatenated along `dim`, in group
    rank order."""
    return _AllGather.apply(t, group, dim)


class GlobalBatch:
    """Reductions over the global batch for a rank's losses and metrics
    (the module's docstring). Without groups every method is the identity
    and `n_space` is 1."""

    def __init__(self, data=None, space=None):
        self.data, self.space = data, space
        self.n_data = 1 if data is None else dist.get_world_size(data)
        self.n_space = 1 if space is None else dist.get_world_size(space)

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.data is None else all_sum(t, self.data)

    def voxels(self, t: torch.Tensor) -> torch.Tensor:
        return self.rows(t) if self.space is None \
            else self.rows(all_sum(t, self.space))

    def spatial(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.space is None else all_sum_grad(t, self.space)

    def spatial_counts(self, t: torch.Tensor) -> torch.Tensor:
        """An integer count over the slab's voxels, summed over space."""
        return t if self.space is None else all_sum(t, self.space)

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every data rank's rows of `t` in global batch order (no
        gradient)."""
        if self.data is None:
            return t
        t = t.detach().contiguous()
        parts = [torch.empty_like(t) for _ in range(self.n_data)]
        dist.all_gather(parts, t, group=self.data)
        return torch.cat(parts)

    def local_rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global-batch tensor `t`."""
        if self.data is None:
            return t
        k = t.shape[0] // self.n_data
        index = dist.get_rank(self.data)
        return t[index * k:(index + 1) * k]


LOCAL = GlobalBatch()


class _Halo(torch.autograd.Function):
    """x's slab with `left` rows of the left neighbour's slab before it and
    `right` rows of the right neighbour's after it, along `dim`; zeros past
    the volume's ends. The backward sends each halo's cotangent back to the
    rank that owns those rows, which adds it."""

    @staticmethod
    def forward(ctx, x, dim, left, right, ranks, index):
        ctx.dim, ctx.left, ctx.right = dim, left, right
        ctx.ranks, ctx.index = ranks, index
        lo, hi = exchange_halo(x.narrow(dim, x.shape[dim] - left, left),
                           x.narrow(dim, 0, right), ranks, index)
        return torch.cat([t for t in (lo, x, hi) if t is not None], dim=dim)

    @staticmethod
    def backward(ctx, g):
        dim, left, right = ctx.dim, ctx.left, ctx.right
        m = g.shape[dim] - left - right
        gx = g.narrow(dim, left, m).clone()
        # The rows my left halo held are my left neighbour's last rows: its
        # cotangent goes back left, and my right neighbour's comes to my
        # last rows (and the same for the right halo).
        from_right, from_left = exchange_halo(
            g.narrow(dim, 0, left), g.narrow(dim, left + m, right),
            ctx.ranks, ctx.index, reverse=True)
        if from_right is not None and left:
            gx.narrow(dim, m - left, left).add_(from_right)
        if from_left is not None and right:
            gx.narrow(dim, 0, right).add_(from_left)
        return gx, None, None, None, None, None


def exchange_halo(to_right: torch.Tensor, to_left: torch.Tensor,
              ranks: Sequence[int], index: int, reverse: bool = False):
    """Point-to-point exchange between depth neighbours.

    Forward (reverse False): `to_right` (my last rows) goes to the right
    neighbour and `to_left` (my first rows) to the left one; returns (the
    left neighbour's last rows, the right neighbour's first rows), zeros
    where there is no neighbour. Reverse: `to_right` is the cotangent of my
    left halo and goes LEFT, `to_left` that of my right halo and goes
    RIGHT; returns (from the right neighbour, from the left neighbour),
    None where there is no neighbour. Empty halves are skipped."""
    n = len(ranks)
    left_peer = ranks[index - 1] if index > 0 else None
    right_peer = ranks[index + 1] if index < n - 1 else None
    if reverse:
        send_a, send_b = left_peer, right_peer
        recv_a, recv_b = right_peer, left_peer
    else:
        send_a, send_b = right_peer, left_peer
        recv_a, recv_b = left_peer, right_peer
    ops, out = [], [None, None]
    for slot, (payload, dst, src) in enumerate(
            ((to_right, send_a, recv_a), (to_left, send_b, recv_b))):
        if payload.numel() == 0:
            continue
        payload = payload.contiguous()
        if dst is not None:
            ops.append(dist.P2POp(dist.isend, payload, dst))
        if src is not None:
            buf = torch.empty_like(payload)
            ops.append(dist.P2POp(dist.irecv, buf, src))
            out[slot] = buf
        elif not reverse:
            out[slot] = torch.zeros_like(payload)
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out[0], out[1]


class DepthShard:
    """This rank's slab of depth-sharded 3D activations (N, C, H, W, D):
    `n` equal slabs along D over the process group `group`, whose global
    ranks `ranks` are in depth order; this rank's is `index`.

    A level of the UNet stays sharded while its depth d divides into n
    slabs of at least `min_depth` rows (models/unet.py, the JAX
    `_constrain_depth` rule); below that it is computed replicated from the
    gathered slabs and sliced back."""

    def __init__(self, group, ranks: Sequence[int], min_depth: int = 2):
        self.group, self.ranks = group, tuple(ranks)
        self.n = len(self.ranks)
        self.index = self.ranks.index(dist.get_rank())
        self.min_depth = min_depth

    def sharded(self, d: int) -> bool:
        """Whether a level of global depth d stays sharded."""
        return d % self.n == 0 and d // self.n >= self.min_depth

    def halo(self, x: torch.Tensor, left: int, right: int) -> torch.Tensor:
        return _Halo.apply(x, x.ndim - 1, left, right, self.ranks, self.index)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole depth from every slab (with gradients)."""
        return all_gather_grad(x, self.group, x.ndim - 1)

    def slab(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's slab of a replicated x."""
        m = x.shape[-1] // self.n
        return x.narrow(x.ndim - 1, self.index * m, m)

    def conv(self, fn, x, weight, bias, stride: Sequence[int],
             padding: Sequence[int], kernel: int) -> torch.Tensor:
        """A stride-s conv (k along D, zero padding p) of the sharded x, whose
        slab starts at a multiple of s: output row j of the slab reads input
        rows j*s - p .. j*s - p + k - 1, so p rows come from the left
        neighbour and (m_out - 1)*s - p + k - m_in from the right one
        (stride 1, k 3, p 1: one each; stride 2: one from the left; k 1:
        none). The conv then runs unpadded along D."""
        s, p, m_in = stride[-1], padding[-1], x.shape[-1]
        if m_in % s:
            raise ValueError(f"a slab of {m_in} rows under stride {s}")
        right = (m_in // s - 1) * s - p + kernel - m_in
        x = self.halo(x, p, right)
        return fn(x, weight, bias, tuple(stride), tuple(padding[:-1]) + (0,))

    def conv_transpose(self, fn, x, weight, bias, stride: Sequence[int],
                       padding: Sequence[int],
                       output_padding: Sequence[int],
                       kernel: int) -> torch.Tensor:
        """A transposed conv (output o reads input i with o = i*s - p + kk)
        of the sharded x: the slab's m_in*s output rows read input rows
        from ceil((p - k + 1)/s) before the slab to floor((p - 1)/s) after
        its last (k 3, s 2, p 1: one row from the right neighbour). It runs
        on the extended slab with the depth padding moved by the left halo,
        and the slab's rows are kept."""
        s, p, m_in = stride[-1], padding[-1], x.shape[-1]
        left, right = _transpose_halo(s, p, kernel)
        x = self.halo(x, left, right)
        pad = tuple(padding[:-1]) + (p + left * s,)
        y = fn(x, weight, bias, tuple(stride), pad, tuple(output_padding))
        return y.narrow(y.ndim - 1, 0, m_in * s)

    def conv_transpose_smallc(self, fn, x, weight, bias, stride: int,
                              kernel: int) -> torch.Tensor:
        """`conv_transpose` of a transposed conv routed to the shallow
        weight gradient, `fn` being ops/shallow_grad.py::
        conv_transpose_smallc (k 3, s 2, pad (k - 1) // 2): the same halo
        and forward, the slab's m_in*s rows kept by `fn`, so that its
        backward takes only their cotangent. Its dW and db are this slab's
        share of the whole volume's."""
        left, right = _transpose_halo(stride, (kernel - 1) // 2, kernel)
        if left:
            raise ValueError(f"k {kernel}, stride {stride}: a left halo, "
                             "which the routed transposed conv does not take")
        return fn(self.halo(x, 0, right), weight, bias, stride, kernel,
                  x.shape[-1] * stride)


def _transpose_halo(s: int, p: int, kernel: int):
    """(left, right): the rows a transposed conv's slab reads from its
    neighbours (`DepthShard.conv_transpose`)."""
    first = -(-(p - kernel + 1) // s)  # ceil((p - k + 1) / s)
    return max(0, -first), max(0, (p - 1) // s + 1)


def depth_shard(mesh, min_depth: int = 2) -> Optional[DepthShard]:
    """The DepthShard of a ('data', 'space') mesh, None without one."""
    if mesh is None or mesh.space is None or mesh.n_space == 1:
        return None
    return DepthShard(mesh.space, mesh.space_ranks, min_depth)
