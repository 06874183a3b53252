"""Exact Euclidean distance transform on the device (port of
ctseg_tpu/ops/edt.py).

The squared EDT is separable: exact 1D step counts along the last axis,
then one min-plus pass (ops/min_plus.py, K5 on the card) per remaining
axis. The order of operations is the JAX function's, so the result is equal
to it bit for bit: step counts with BIG where a row has no site, times the
last axis's spacing, squared and clamped at BIG, then the passes with each
axis's spacing as the scale.

The JAX functions take one map and are vmapped by their callers. Here the
batch is written out: leading dims are batch dims, the last `spatial_dims`
dims are the map, and every map of the batch goes through one kernel launch
per pass. The maps are data, not differentiable.

On a CUDA tensor the passes around the min-plus kernel are kernels too
(csrc/edt.cu), each with its plain PyTorch version here, which the CPU
takes:
  - `row_scan` / `label_scan`: the squared, scaled, clamped distance along
    the last axis, from a mask or straight from an integer label map (both
    signs of every class mask, without making the stack of booleans);
  - `signed_map`: sqrt, the signed combination, zero for an empty mask and
    the division by 255.
The `*_plain` compositions are the whole functions in torch operations
(over `min_plus`, so on the card only K5 is a kernel in them); chip_smoke.py
holds the kernel paths bit-equal to them there. `row_scan_lanes_model` and
`label_scan_lanes_model` are the scan kernel's own arithmetic (segments of
32 lanes x LANE_ELEMS elements, two warp scans, carries between segments)
in plain PyTorch, for the CPU tests.
"""

from typing import Optional, Tuple

import torch

from ctseg_tpu_torch.constants import NUM_CLASSES
from ctseg_tpu_torch.ops import _build
from ctseg_tpu_torch.ops.min_plus import BIG, min_plus

MAX_W = 24576  # the longest row the scan kernel takes (its kMaxW)
LANE_ELEMS = 8  # consecutive elements a lane of the scan kernel holds (kV)
SEGMENT = 32 * LANE_ELEMS  # elements a warp takes at once (kSeg)
_FAR = 1 << 30  # a site index beyond every row: no site on that side
_NO_SITE = 1 << 29  # a distance this long: the row has no site
_LABEL_CODES = {torch.uint8: 0, torch.int32: 1, torch.int64: 2}


def _scan_distance_1d(sites: torch.Tensor) -> torch.Tensor:
    """Distance in steps to the nearest True along the last axis, float32;
    BIG where a row has none. The reference scans a carry that starts at
    BIG (BIG + 1 rounds back to BIG in float32); the running maximum of the
    sites' indices gives the same integers."""
    w = sites.shape[-1]
    pos = torch.arange(w, dtype=torch.int32, device=sites.device)

    def one_way(s):
        last = torch.cummax(torch.where(s, pos, -1), dim=-1).values
        return torch.where(last >= 0, (pos - last).to(torch.float32), BIG)

    forward = one_way(sites)
    backward = one_way(sites.flip(-1)).flip(-1)
    return torch.minimum(forward, backward)


def row_scan_plain(mask: torch.Tensor,
                   scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of `row_scan`."""
    g = _scan_distance_1d(torch.logical_not(mask.bool()))
    if scale is not None:
        g = g * scale[:, None, None]
    return torch.clamp_max(g * g, BIG)


def row_scan_lanes_model(sites: torch.Tensor,
                         scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """d2 of `row_scan` from the sites (rows, W) bool (one scale per row, or
    None), as csrc/edt.cu's warp computes it: the row cut into segments of
    32 lanes x LANE_ELEMS elements; per lane its last and first site (clz
    and ffs of its bit word); the 5-step inclusive scans across the lanes
    (a running max up, a running min down), shifted by one lane for the
    exclusive sites; the carries between segments (the last site so far,
    and the first site after the segment from the right-to-left pass);
    running selects over the lane's own elements; d as a float from the
    mantissa of 2^23 + d; int32 throughout, as the kernel's."""
    rows, w = sites.shape
    segs = -(-w // SEGMENT)
    lanes = torch.zeros((rows, segs * SEGMENT), dtype=torch.bool)
    lanes[:, :w] = sites  # past the row's end: no site (the valid bits)
    lanes = lanes.reshape(rows, segs, 32, LANE_ELEMS)
    j = torch.arange(segs * SEGMENT, dtype=torch.int32).reshape(
        segs, 32, LANE_ELEMS)
    far = torch.tensor(_FAR, dtype=torch.int32)
    last = torch.where(lanes, j, -far).amax(-1)  # (rows, segs, 32)
    first = torch.where(lanes, j, far).amin(-1)
    for o in (1, 2, 4, 8, 16):  # __shfl_up_sync / __shfl_down_sync by o
        up, down = last.clone(), first.clone()
        up[..., o:] = torch.maximum(last[..., o:], last[..., :-o])
        down[..., :-o] = torch.minimum(first[..., :-o], first[..., o:])
        last, first = up, down
    # Carries: the last site before each segment (left to right), the first
    # after it (right to left: the segment's minimum, __reduce_min_sync).
    seg_last = last[..., 31].cummax(dim=1).values
    last_in = torch.cat([-far.expand(rows, 1), seg_last[:, :-1]], dim=1)
    seg_first = first[..., 0].flip(1).cummin(dim=1).values.flip(1)
    next_in = torch.cat([seg_first[:, 1:], far.expand(rows, 1)], dim=1)
    before = torch.cat([last_in[..., None], last[..., :31]], dim=-1)
    after = torch.cat([first[..., 1:], next_in[..., None]], dim=-1)
    before = torch.maximum(before, last_in[..., None])
    after = torch.minimum(after, next_in[..., None])
    # Within the lane: the running selects over its elements.
    before = torch.maximum(torch.where(lanes, j, -far).cummax(-1).values,
                           before[..., None])
    after = torch.minimum(
        torch.where(lanes, j, far).flip(-1).cummin(-1).values.flip(-1),
        after[..., None])
    d = torch.minimum(j - before, after - j)
    g = (d | 0x4B000000).view(torch.float32) - 8388608.0
    g = torch.where(d >= _NO_SITE, torch.tensor(BIG, dtype=torch.float32), g)
    if scale is not None:
        g = g * scale[:, None, None, None]
    return torch.clamp_max(g * g, BIG).reshape(rows, -1)[:, :w]


def label_scan_lanes_model(labels: torch.Tensor, n_classes: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`label_scan` as the kernel orders it: each source row read once, and
    for every class c its sites (label == c + 1) and the complement's
    within the row, each through `row_scan_lanes_model`; nonempty from the
    rows of the first kind that hold a site."""
    n, r, w = labels.shape
    c = n_classes - 1
    d2 = torch.empty((2, n, c, r, w), dtype=torch.float32)
    nonempty = torch.zeros((n, c), dtype=torch.bool)
    rows = labels.reshape(n * r, w)
    for k in range(c):
        pos = rows == k + 1
        d2[0, :, k] = row_scan_lanes_model(pos).reshape(n, r, w)
        d2[1, :, k] = row_scan_lanes_model(~pos).reshape(n, r, w)
        nonempty[:, k] = pos.reshape(n, -1).any(dim=1)
    return d2, nonempty


def _check_scan(t: torch.Tensor, scale: Optional[torch.Tensor], maps: int):
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    if not t.is_contiguous() or t.shape[-1] > MAX_W or t.numel() >= 2**40:
        raise ValueError(
            f"kernel wants a contiguous map with rows of at most {MAX_W}, "
            f"got {tuple(t.shape)} with strides {tuple(t.stride())}")
    if scale is not None and (
            scale.dtype != torch.float32 or scale.device != t.device
            or tuple(scale.shape) != (maps,) or not scale.is_contiguous()):
        raise TypeError(f"kernel wants a contiguous float32 scale ({maps},) "
                        f"on {t.device}, got {tuple(scale.shape)} "
                        f"{scale.dtype} on {scale.device}")


def row_scan(mask: torch.Tensor,
             scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(M, R, W) masks -> (M, R, W) float32: along the last axis, the
    distance in steps to the nearest zero of `mask` (BIG where a row has
    none), times scale[m] (M,) if given, squared and clamped at BIG. On
    CUDA, launches csrc/edt.cu's scan or raises."""
    if mask.ndim != 3:
        raise ValueError(f"want (M, R, W) masks, got {tuple(mask.shape)}")
    if mask.device.type == "cpu":
        return row_scan_plain(mask, scale)
    m, r, w = mask.shape
    mask = mask.bool().contiguous().view(torch.uint8)
    _check_scan(mask, scale, m)
    out = torch.empty(mask.shape, dtype=torch.float32, device=mask.device)
    if mask.numel() == 0:
        return out
    lib = _build.library()
    err = lib.ctseg_edt_row_scan(
        mask.data_ptr(), None if scale is None else scale.data_ptr(),
        out.data_ptr(), None, m, r, w, 1, 0, 0, mask.device.index,
        torch.cuda.current_stream(mask.device).cuda_stream)
    lib.check(err, "edt row scan")
    row_scan.launches += 1
    return out


def label_scan_plain(labels: torch.Tensor, n_classes: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `label_scan`."""
    classes = torch.arange(1, n_classes, device=labels.device)
    pos = labels[:, None] == classes[:, None, None]  # (N, C, R, W)
    stack = torch.stack([torch.logical_not(pos), pos])
    d2 = row_scan_plain(stack.flatten(0, 2)).reshape(stack.shape)
    return d2, torch.any(pos.flatten(2), dim=-1)


def label_scan(labels: torch.Tensor, n_classes: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, R, W) integer label maps -> (d2 (2, N, C, R, W) float32, nonempty
    (N, C)) for the C = n_classes - 1 masks labels == c + 1: d2[0] is
    `row_scan` of each mask's complement (the squared distance along the row
    to the nearest pixel of the class), d2[1] of the mask itself; nonempty
    says whether the class has a pixel (int32 on the card, bool on the CPU).
    On CUDA, launches csrc/edt.cu's scan or raises."""
    if labels.ndim != 3:
        raise ValueError(f"want (N, R, W) labels, got {tuple(labels.shape)}")
    if labels.device.type == "cpu":
        return label_scan_plain(labels, n_classes)
    if labels.dtype == torch.bool:
        labels = labels.view(torch.uint8)
    if labels.dtype not in _LABEL_CODES:
        raise TypeError(f"kernel takes bool, uint8, int32 or int64 labels, "
                        f"got {labels.dtype}")
    _check_scan(labels, None, 0)
    n, r, w = labels.shape
    c = n_classes - 1
    d2 = torch.empty((2, n, c, r, w), dtype=torch.float32,
                     device=labels.device)
    nonempty = torch.zeros((n, c), dtype=torch.int32, device=labels.device)
    if d2.numel() == 0:
        return d2, nonempty
    lib = _build.library()
    err = lib.ctseg_edt_row_scan(
        labels.data_ptr(), None, d2.data_ptr(), nonempty.data_ptr(), n, r, w,
        c, 1, _LABEL_CODES[labels.dtype], labels.device.index,
        torch.cuda.current_stream(labels.device).cuda_stream)
    lib.check(err, "edt label scan")
    row_scan.launches += 1
    return d2, nonempty


row_scan.launches = 0  # scan launches (masks and label maps) since the last reset


def signed_map_plain(d2: torch.Tensor, labels: torch.Tensor,
                     nonempty: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `signed_map`."""
    c = d2.shape[2]
    classes = torch.arange(1, c + 1, device=labels.device)
    pos = labels[:, None] == classes[:, None]  # (N, C, E)
    neg = torch.logical_not(pos)
    d_out, d_in = torch.sqrt(d2)
    result = d_out * neg - (d_in - 1.0) * pos
    # A true division on the card too: by a Python scalar torch's CUDA
    # kernel multiplies by the reciprocal, one rounding more.
    return torch.where(nonempty.bool()[:, :, None], result, 0.0) / torch.full(
        (), 255.0, device=d2.device)


def signed_map(d2: torch.Tensor, labels: torch.Tensor,
               nonempty: torch.Tensor) -> torch.Tensor:
    """Squared distances (2, N, C, E) (outside, inside), labels (N, E) and
    nonempty (N, C), as `label_scan` gives them -> (N, C, E) signed maps:
    (sqrt(d2[0]) * neg - (sqrt(d2[1]) - 1) * pos) / 255 with pos the mask
    labels == c + 1, zero where the mask is empty. On CUDA, launches
    csrc/edt.cu's elementwise kernel or raises."""
    if d2.device.type == "cpu":
        return signed_map_plain(d2, labels, nonempty)
    _, n, c, e = d2.shape
    if labels.dtype == torch.bool:
        labels = labels.view(torch.uint8)
    if d2.device.type != "cuda" or d2.dtype != torch.float32 \
            or labels.dtype not in _LABEL_CODES \
            or nonempty.dtype != torch.int32 \
            or tuple(labels.shape) != (n, e) or tuple(nonempty.shape) != (n, c) \
            or not (d2.is_contiguous() and labels.is_contiguous()
                    and nonempty.is_contiguous()) \
            or e >= 2**31 - 1024:
        raise TypeError(
            f"kernel wants contiguous float32 distances (2, N, C, E), labels "
            f"(N, E) and int32 flags (N, C) on the card, got "
            f"{tuple(d2.shape)} {d2.dtype}, {tuple(labels.shape)} "
            f"{labels.dtype}, {tuple(nonempty.shape)} {nonempty.dtype}")
    out = torch.empty((n, c, e), dtype=torch.float32, device=d2.device)
    if out.numel() == 0:
        return out
    lib = _build.library()
    err = lib.ctseg_edt_signed_map(
        d2.data_ptr(), labels.data_ptr(), nonempty.data_ptr(), out.data_ptr(),
        n * c, e, c, _LABEL_CODES[labels.dtype], d2.device.index,
        torch.cuda.current_stream(d2.device).cuda_stream)
    lib.check(err, "edt signed map")
    signed_map.launches += 1
    return out


signed_map.launches = 0  # signed-map launches since the last reset


def _min_plus_passes(d2: torch.Tensor, n_batch_dims: int, nd: int,
                     spacing: Optional[torch.Tensor]) -> torch.Tensor:
    """The min-plus pass along every spatial axis but the last of d2
    (*batch, *spatial); spacing (n_maps, nd) or None."""
    n_maps = d2.shape[:n_batch_dims].numel()
    for ax in range(nd - 1):
        p = n_batch_dims + ax
        k = d2.shape[p]
        before = d2.shape[n_batch_dims:p].numel()  # spatial dims ahead of ax
        if spacing is None:
            scale = torch.ones(n_maps * before, dtype=torch.float32,
                               device=d2.device)
        else:
            scale = spacing[:, ax].repeat_interleave(before).contiguous()
        d2 = min_plus(d2.reshape(n_maps * before, k, -1), scale).reshape(
            d2.shape)
    return d2


def _edt_squared(mask, spacing, spatial_dims, scan) -> torch.Tensor:
    """`edt_squared` with `scan` for the pass along the last axis."""
    if spacing is not None:
        spacing = torch.as_tensor(spacing, dtype=torch.float32,
                                  device=mask.device)
        nd = spacing.shape[-1]
        if spatial_dims not in (None, nd):
            raise ValueError(f"spacing of {nd} axes for {spatial_dims}D maps")
    else:
        nd = mask.ndim if spatial_dims is None else spatial_dims
    if not 1 <= nd <= mask.ndim:
        raise ValueError(f"{nd} spatial dims in a mask {tuple(mask.shape)}")
    batch = mask.shape[:mask.ndim - nd]
    n_maps = batch.numel()
    scale = None
    if spacing is not None:
        spacing = spacing.expand(*batch, nd).reshape(n_maps, nd)
        scale = spacing[:, -1].contiguous()
    rows = mask.shape[len(batch):-1].numel()
    d2 = scan(mask.reshape(n_maps, rows, mask.shape[-1]), scale)
    return _min_plus_passes(d2.reshape(mask.shape), len(batch), nd, spacing)


def edt_squared(mask: torch.Tensor, spacing=None,
                spatial_dims: Optional[int] = None) -> torch.Tensor:
    """Exact squared Euclidean distance to the nearest zero of `mask`.

    scipy.ndimage.distance_transform_edt(mask, sampling=spacing)**2 for each
    map: 0 on the zeros of the input, BIG for an all-ones map. `mask` is
    (*batch, *spatial); `spatial_dims` counts the map's dims (default: all
    of them, or the length of `spacing`). `spacing` is the voxel size per
    spatial axis: a sequence or a tensor (..., spatial_dims) whose leading
    dims broadcast against the batch dims, so every map may have its own.
    At unit spacing (None) the values are integer-valued floats.
    """
    return _edt_squared(mask, spacing, spatial_dims, row_scan)


def edt_squared_plain(mask: torch.Tensor, spacing=None,
                      spatial_dims: Optional[int] = None) -> torch.Tensor:
    """`edt_squared` with the scan in torch operations."""
    return _edt_squared(mask, spacing, spatial_dims, row_scan_plain)


def edt(mask: torch.Tensor, spacing=None,
        spatial_dims: Optional[int] = None) -> torch.Tensor:
    """Euclidean distance from each voxel to the nearest zero of `mask`
    (scipy.ndimage.distance_transform_edt semantics, `spacing` its
    `sampling=`); batched like `edt_squared`."""
    return torch.sqrt(edt_squared(mask, spacing, spatial_dims))


def _signed_maps(labels: torch.Tensor, n_classes: int, scan=label_scan,
                 signed=signed_map) -> torch.Tensor:
    """(N, *spatial) label maps -> (N, n_classes - 1, *spatial) signed maps
    of the masks labels == c + 1: the scan, the min-plus passes of both
    signs of every mask in one launch each, the signed arithmetic."""
    n, spatial = labels.shape[0], labels.shape[1:]
    labels = labels.contiguous()
    d2, nonempty = scan(
        labels.reshape(n, spatial[:-1].numel(), spatial[-1]), n_classes)
    d2 = _min_plus_passes(d2.reshape(2, n, n_classes - 1, *spatial), 3,
                          len(spatial), None)
    out = signed(d2.reshape(2, n, n_classes - 1, spatial.numel()),
                 labels.reshape(n, spatial.numel()), nonempty)
    return out.reshape(n, n_classes - 1, *spatial)


def _signed_distance_map(mask, spatial_dims, scan, signed) -> torch.Tensor:
    nd = mask.ndim if spatial_dims is None else spatial_dims
    if not 1 <= nd <= mask.ndim:
        raise ValueError(f"{nd} spatial dims in a mask {tuple(mask.shape)}")
    # A mask is a label map with one class.
    maps = mask.bool().reshape(-1, *mask.shape[mask.ndim - nd:])
    return _signed_maps(maps, 2, scan, signed).reshape(mask.shape)


def signed_distance_map_plain(mask: torch.Tensor,
                              spatial_dims: Optional[int] = None
                              ) -> torch.Tensor:
    """`signed_distance_map` with the scan and the signed arithmetic in
    torch operations."""
    return _signed_distance_map(mask, spatial_dims, label_scan_plain,
                                signed_map_plain)


def signed_distance_map(mask: torch.Tensor,
                        spatial_dims: Optional[int] = None) -> torch.Tensor:
    """Signed EDT of binary masks with the reference's convention:
    dist(~mask) * ~mask - (dist(mask) - 1) * mask, all divided by 255
    (capstone/data/utils.py:10-26); an empty mask gives zeros. `mask` is
    (*batch, *spatial); both transforms of every map share one launch."""
    return _signed_distance_map(mask, spatial_dims, label_scan, signed_map)


@torch.no_grad()
def signed_distance_maps_from_labels_plain(labels: torch.Tensor,
                                           n_classes: int = NUM_CLASSES
                                           ) -> torch.Tensor:
    """`signed_distance_maps_from_labels` with the scan and the signed
    arithmetic in torch operations."""
    return _signed_maps(labels, n_classes, label_scan_plain, signed_map_plain)


@torch.no_grad()
def signed_distance_maps_from_labels(labels: torch.Tensor,
                                     n_classes: int = NUM_CLASSES
                                     ) -> torch.Tensor:
    """(N, *spatial) label map -> (N, n_classes - 1, *spatial) signed
    distance maps, background excluded: channel-first, like the logits the
    Boundary loss multiplies them with. On the card the class masks are
    never made: the scan and the signed arithmetic read the label map."""
    return _signed_maps(labels, n_classes)
