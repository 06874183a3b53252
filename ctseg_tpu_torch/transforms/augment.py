"""Resizing and the train augmentations (port of
ctseg_tpu/transforms/augment.py): resize, random_crop, random_rotate90,
horizontal_flip, elastic_transform, grid_distortion and one_of.

`jax.image.resize(..., "linear")` is antialiased triangle-filter resampling
with half-pixel centres: F.interpolate(mode="bilinear", antialias=True,
align_corners=False) computes the same weights (equal to 1e-15 in float64,
for down- and upscaling alike). `jax.image.resize(..., "nearest")` is
F.interpolate's "nearest-exact"; plain "nearest" picks other pixels.

The random augmentations split drawing from applying. Each `draw_*` draws
per-sample parameters from an explicit torch.Generator, with the
distributions of the JAX calls: a uniform crop offset, k ~ U{0..3} applied
with p = 0.5, a W flip with p = 0.5 (augment.py:69-71, 82, 92-93); the
elastic warp's apply bit and its (3, 2) corner jitter in U(-alpha_affine,
alpha_affine) (:240, 252-254, 301); the grid distortion's apply bit and its
two step vectors in 1 + U(-limit, limit) (:316-318, 376, 389); one_of's
uniform choice (:396-397). The apply functions are plain torch, batched;
tests feed them the draws JAX makes.

The warps keep the reference's arithmetic, not its TPU layout. Both are two
1D passes, vertical then horizontal, each a gather of two taps with the hat
weights max(0, 1 - |c - k|) (order 1, the image) or of the tap at round(c)
(order 0, the label, rounded in each pass): the reference's interpolation
matmuls (augment.py:136-181, 337-358) hold the same weights and zeros
elsewhere. The elastic passes fold their coordinates by REFLECT_101, the
grid's clamp them. A sample a warp leaves alone gets the identity
coordinates, whose taps return it exactly, so a batch takes one pair of
passes whatever each sample drew (`one_of` included).

Images are batched channel-last (N, H, W, C) or (N, H, W), labels (N, H, W).
"""

from typing import NamedTuple, Optional, Tuple

import numpy as np

import torch
import torch.nn.functional as F


def resize(image: torch.Tensor, size: Tuple[int, int], method: str = "linear"):
    """Resize (N, H, W[, C]) to (N, size[0], size[1][, C])."""
    if method not in ("linear", "nearest"):
        raise ValueError(f"unknown resize method {method!r}")
    nhwc = image if image.ndim == 4 else image[..., None]
    nchw = nhwc.permute(0, 3, 1, 2)
    if method == "linear":
        out = F.interpolate(
            nchw, size=tuple(size), mode="bilinear", antialias=True,
            align_corners=False,
        )
    else:
        out = F.interpolate(nchw, size=tuple(size), mode="nearest-exact")
    out = out.permute(0, 2, 3, 1)
    return out if image.ndim == 4 else out[..., 0]


def resize_image_and_label(image, label, size):
    """Bilinear for the image, nearest for the label (Albumentations Resize)."""
    img = resize(image, size, "linear")
    lab = resize(label.to(torch.float32), size, "nearest").to(label.dtype)
    return img, lab


class Degree2Draws(NamedTuple):
    """Per-sample parameters of the degree-2 moves, each (N,) int32."""

    top: torch.Tensor   # crop row offset, in [0, H - S]
    left: torch.Tensor  # crop column offset, in [0, W - S]
    k: torch.Tensor     # quarter turns of rot90, in 0..3
    flip: torch.Tensor  # 1 to flip W after the rotation


def draw_degree2(generator: Optional[torch.Generator], n: int, h: int, w: int,
                 size: int, device=None) -> Degree2Draws:
    """Draw crop, rot90 and flip parameters for n slices of (h, w) cropped to
    (size, size), on the generator's device (or `device`)."""
    if h < size or w < size:
        raise ValueError(f"cannot crop ({h}, {w}) slices to {size}")
    device = generator.device if generator is not None else device
    kw = {"generator": generator, "device": device}
    i32 = torch.int32
    top = torch.randint(0, h - size + 1, (n,), dtype=i32, **kw)
    left = torch.randint(0, w - size + 1, (n,), dtype=i32, **kw)
    rotate = torch.rand((n,), **kw) < 0.5
    k = torch.where(rotate, torch.randint(0, 4, (n,), dtype=i32, **kw), 0)
    flip = (torch.rand((n,), **kw) < 0.5).to(i32)
    return Degree2Draws(top, left, k.to(i32), flip)


def crop(x: torch.Tensor, top: torch.Tensor, left: torch.Tensor, size: int):
    """x[n, top[n]:top[n]+size, left[n]:left[n]+size] for every n (A.RandomCrop)."""
    ar = torch.arange(size, device=x.device)
    rows = top.long()[:, None] + ar  # (N, S)
    cols = left.long()[:, None] + ar
    n = torch.arange(x.shape[0], device=x.device)[:, None, None]
    return x[n, rows[:, :, None], cols[:, None, :]]


def rotate90(x: torch.Tensor, k: torch.Tensor):
    """np.rot90(x[n], k[n], axes=(0, 1)) for every n (A.RandomRotate90)."""
    if x.shape[1] != x.shape[2]:
        raise ValueError("rot90 needs square inputs")
    mask_shape = (-1,) + (1,) * (x.ndim - 1)
    out = x
    for q in (1, 2, 3):
        sel = (k == q).reshape(mask_shape)
        out = torch.where(sel, torch.rot90(x, q, dims=(1, 2)), out)
    return out


def hflip(x: torch.Tensor, flip: torch.Tensor):
    """Flip the W axis of the samples whose `flip` is 1 (A.HorizontalFlip)."""
    sel = flip.bool().reshape((-1,) + (1,) * (x.ndim - 1))
    return torch.where(sel, torch.flip(x, dims=(2,)), x)


def apply_degree2(x: torch.Tensor, draws: Degree2Draws, size: int):
    """Crop, rot90, then flip: the order of pipelines._degree_2."""
    x = crop(x, draws.top, draws.left, size)
    return hflip(rotate90(x, draws.k), draws.flip)


def move_draws(draws, device):
    """Draws (a NamedTuple of tensors, possibly nested, or None) on
    `device`."""
    if draws is None or torch.is_tensor(draws):
        return None if draws is None else draws.to(device)
    return type(draws)(*(move_draws(d, device) for d in draws))


# ------------------------------------------------------------------ warps
def _reflect_101(coords: torch.Tensor, length: int) -> torch.Tensor:
    """Fold coordinates into [0, length - 1] by mirror reflection about the
    edge pixels' centres (cv2 BORDER_REFLECT_101, map_coordinates' "mirror").
    torch.remainder is floored, as jnp.mod is; torch.fmod is not."""
    if length == 1:
        return torch.zeros_like(coords)
    period = 2.0 * (length - 1.0)
    t = torch.remainder(coords, period)
    return torch.where(t > length - 1.0, period - t, t)


def _taps(coords: torch.Tensor, length: int):
    """The two order-1 taps of coordinates in [0, length - 1]: indices and
    the reference's hat weights max(0, 1 - |c - k|). The second index is
    clamped at length - 1, where its weight is 0."""
    k0 = torch.floor(coords)
    k1 = k0 + 1.0
    w0 = torch.clamp_min(1.0 - torch.abs(coords - k0), 0.0)
    w1 = torch.clamp_min(1.0 - torch.abs(coords - k1), 0.0)
    i1 = torch.clamp_max(k1, length - 1.0)
    return k0.long(), i1.long(), w0, w1


def _gather(x: torch.Tensor, index: torch.Tensor, dim: int) -> torch.Tensor:
    """x[n, index[n, i, j], j] (dim 1) or x[n, i, index[n, i, j]] (dim 2),
    over a trailing channel axis of x if it has one."""
    if x.ndim == 4:
        index = index[..., None].expand(index.shape + (x.shape[3],))
    return torch.gather(x, dim, index)


def shear_pass(x: torch.Tensor, coords: torch.Tensor, dim: int, order: int):
    """One 1D resampling pass along `dim` (1: rows, 2: columns):
    out[n, i, j] = x at the source coordinate coords[n, i, j] (in range)
    along that axis, the other index kept. Order 1 interpolates the two taps
    in float32; order 0 takes the tap at round(c) (half to even, as
    jnp.round) and keeps x's dtype."""
    length = x.shape[dim]
    if order == 0:
        return _gather(x, torch.round(coords).long(), dim)
    i0, i1, w0, w1 = _taps(coords, length)
    if x.ndim == 4:
        w0, w1 = w0[..., None], w1[..., None]
    x = x.to(torch.float32)
    return w0 * _gather(x, i0, dim) + w1 * _gather(x, i1, dim)


def two_pass_warp(image, label, coords_y, coords_x):
    """The vertical pass at coords_y (N, H, W), then the horizontal pass at
    coords_x (N, H, W): bilinear for the image, nearest for the label in
    each pass (augment.py:211-215, 58)."""
    img = shear_pass(shear_pass(image, coords_y, 1, 1), coords_x, 2, 1)
    lab = shear_pass(shear_pass(label, coords_y, 1, 0), coords_x, 2, 0)
    return img.to(image.dtype), lab


def _grid(n: int, h: int, w: int, device):
    """Each output pixel's row and column, (N, H, W) float32: the identity
    coordinates, whose taps return the input exactly."""
    ys = torch.arange(h, dtype=torch.float32, device=device)
    xs = torch.arange(w, dtype=torch.float32, device=device)
    return (ys[None, :, None].expand(n, h, w),
            xs[None, None, :].expand(n, h, w))


def _select(apply: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    return torch.where(apply.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)


# ------------------------------------------------------- elastic transform
class ElasticDraws(NamedTuple):
    """Per-sample draws of elastic_transform."""

    apply: torch.Tensor   # (N,) bool, p
    jitter: torch.Tensor  # (N, 3, 2) float32 in U(-alpha_affine, alpha_affine)
    # The general branch's displacement fields (N, H, W) in U(-1, 1); None
    # where alpha < sigma / 10 (the fast branch, the defaults) needs none.
    dx: Optional[torch.Tensor] = None
    dy: Optional[torch.Tensor] = None


def _fast_branch(alpha: float, sigma: float) -> bool:
    """The displacement field is sub-pixel: the warp is the affine alone
    (augment.py:233-237, 261)."""
    return alpha < sigma / 10.0


def draw_elastic(generator: Optional[torch.Generator], n: int, h: int,
                 w: int, alpha: float = 1.0, sigma: float = 50.0,
                 alpha_affine: float = 50.0, p: float = 0.5,
                 device=None) -> ElasticDraws:
    device = generator.device if generator is not None else device
    kw = {"generator": generator, "device": device}
    apply = torch.rand((n,), **kw) < p
    jitter = torch.rand((n, 3, 2), **kw) * (2.0 * alpha_affine) - alpha_affine
    if _fast_branch(alpha, sigma):
        return ElasticDraws(apply, jitter)
    dx = torch.rand((n, h, w), **kw) * 2.0 - 1.0
    dy = torch.rand((n, h, w), **kw) * 2.0 - 1.0
    return ElasticDraws(apply, jitter, dx, dy)


def _src_points(h: int, w: int) -> np.ndarray:
    """The anchor triangle (x, y) around the centre (augment.py:242-250)."""
    c = np.array([w // 2, h // 2], np.float64)
    s = min(h, w) // 3
    return np.stack([c + [s, s], c + [s, -s], c + [-s, s]])


def inverse_affine(jitter: torch.Tensor, h: int, w: int):
    """The inverse of the affine taking the anchor triangle to the anchors
    plus `jitter` (N, 3, 2), (x, y) order: (Ainv (N, 2, 2), b (N, 2)) with
    source = Ainv @ (p - b), float64. `_solve_affine` and `jnp.linalg.inv`
    of the reference (augment.py:102-107, 256-259) in closed form: the
    anchors' 3x3 system is a constant inverted on the host, and the 2x2
    inverse is the adjugate over the determinant, so nothing waits for the
    card and no error check synchronises."""
    src = _src_points(h, w)
    a_inv = np.linalg.inv(np.concatenate([src, np.ones((3, 1))], axis=1))
    # The anchors plus the jitter in float32, as the reference adds them;
    # the constants enter as Python numbers (no copy to the card).
    dst = [[(jitter[:, k, r] + float(src[k, r])).to(torch.float64)
            for r in range(2)] for k in range(3)]
    # M[r, c] = sum_k a_inv[c, k] dst[k][r]: three products, summed in order
    m = [[dst[0][r] * float(a_inv[c, 0]) + dst[1][r] * float(a_inv[c, 1])
          + dst[2][r] * float(a_inv[c, 2]) for c in range(3)]
         for r in range(2)]
    (a, b_), (c, d) = (m[0][0], m[0][1]), (m[1][0], m[1][1])
    det = a * d - b_ * c
    ainv = torch.stack([torch.stack([d / det, -b_ / det], -1),
                        torch.stack([-c / det, a / det], -1)], -2)
    return ainv, torch.stack([m[0][2], m[1][2]], -1)


def _shear_parameters(jitter: torch.Tensor, h: int, w: int):
    """(alpha, beta, ty, gamma, delta, tx), each (N,) float32, of the
    reference's shear decomposition of the inverse affine, (y, x) order
    (augment.py:262-273, 204-211): the vertical pass reads row
    alpha*y + beta*x + ty, the horizontal pass column gamma*x + delta*y + tx.
    Computed in float64, then rounded once."""
    ainv, b = inverse_affine(jitter, h, w)
    m00, m01 = ainv[:, 1, 1], ainv[:, 1, 0]
    m10, m11 = ainv[:, 0, 1], ainv[:, 0, 0]
    b0 = -(ainv[:, 1, 0] * b[:, 0] + ainv[:, 1, 1] * b[:, 1])
    b1 = -(ainv[:, 0, 0] * b[:, 0] + ainv[:, 0, 1] * b[:, 1])
    beta = m01 / m11
    params = (m00 - beta * m10, beta, b0 - beta * b1, m11, m10, b1)
    return tuple(v.to(torch.float32)[:, None, None] for v in params)


def shear_coords(params, apply: torch.Tensor, h: int, w: int):
    """The two passes' source coordinates (N, H, W) for the six shear
    parameters (each (N, 1, 1)), folded by REFLECT_101; the identity where
    a sample does not apply. The products and sums are the reference's, in
    its order."""
    ys, xs = _grid(apply.shape[0], h, w, apply.device)
    alpha, beta, ty, gamma, delta, tx = params
    cy = _reflect_101(alpha * ys + beta * xs + ty, h)
    cx = _reflect_101(gamma * xs + delta * ys + tx, w)
    return _select(apply, cy, ys), _select(apply, cx, xs)


def elastic_coords(draws: ElasticDraws, h: int, w: int):
    """The two passes' source coordinates of the elastic fast branch."""
    return shear_coords(_shear_parameters(draws.jitter, h, w), draws.apply,
                        h, w)


def _gaussian_blur_1d(x: torch.Tensor, sigma: float, dim: int) -> torch.Tensor:
    """Gaussian blur of (N, H, W) along dim 1 or 2, reflect padding (numpy's
    "reflect", no edge repeat), radius min(3 sigma, L - 1) (augment.py:110)."""
    length = x.shape[dim]
    radius = int(min(3 * sigma, length - 1))
    t = torch.arange(-radius, radius + 1, dtype=torch.float64, device=x.device)
    kernel = torch.exp(-0.5 * (t * (1.0 / sigma)) ** 2)
    kernel = (kernel / torch.sum(kernel)).to(x.dtype)
    rows = x.movedim(dim, -1)
    shape = rows.shape
    padded = F.pad(rows.reshape(-1, 1, shape[-1]), (radius, radius),
                   mode="reflect")
    out = F.conv1d(padded, kernel.flip(0)[None, None])
    return out.reshape(shape).movedim(-1, dim)


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    """lax.round's default rounding, exact: integer part plus a step away
    from zero where the fraction is at least one half."""
    r = torch.trunc(x)
    return r + torch.where(torch.abs(x - r) >= 0.5, torch.sign(x),
                           torch.zeros_like(x))


def _mirror_index(index: torch.Tensor, size: int) -> torch.Tensor:
    s = size - 1
    return torch.abs(torch.remainder(index + s, 2 * s) - s)


def map_coordinates(x: torch.Tensor, coord_y: torch.Tensor,
                    coord_x: torch.Tensor, order: int) -> torch.Tensor:
    """jax.scipy.ndimage.map_coordinates(x[n], [coord_y[n], coord_x[n]],
    order, mode="mirror") for every n; x (N, H, W) float, coordinates
    (N, H', W'). Order 1: the four corners' products summed in the JAX
    order; order 0: the nearest index, rounded half away from zero as JAX
    rounds (scipy's map_coordinates rounds half up, floor(c + 0.5), and so
    differs from both at exact negative halves)."""
    n, h, w = x.shape
    flat = x.reshape(n, h * w)

    def at(iy, ix):
        idx = (_mirror_index(iy, h) * w + _mirror_index(ix, w)).reshape(n, -1)
        return torch.gather(flat, 1, idx).reshape(coord_y.shape)

    if order == 0:
        return at(_round_half_away(coord_y).long(),
                  _round_half_away(coord_x).long())
    ly, lx = torch.floor(coord_y), torch.floor(coord_x)
    uy, ux = coord_y - ly, coord_x - lx
    wy, wx = (1 - uy, uy), (1 - ux, ux)
    iy, ix = ly.long(), lx.long()
    out = None
    for a in (0, 1):
        for b in (0, 1):
            term = (wy[a] * wx[b]) * at(iy + a, ix + b)
            out = term if out is None else out + term
    return out


def general_coords(draws: ElasticDraws, h: int, w: int, alpha: float,
                   sigma: float):
    """The general branch's 2D source coordinates (N, H, W), (y, x): the
    inverse affine plus the Gaussian-smoothed displacement field scaled by
    alpha (augment.py:275-287)."""
    ainv, b = inverse_affine(draws.jitter, h, w)
    ainv, b = ainv.to(torch.float32), b.to(torch.float32)
    ys, xs = _grid(draws.jitter.shape[0], h, w, draws.jitter.device)
    rx = xs - b[:, 0, None, None]
    ry = ys - b[:, 1, None, None]
    src_x = ainv[:, 0, 0, None, None] * rx + ainv[:, 0, 1, None, None] * ry
    src_y = ainv[:, 1, 0, None, None] * rx + ainv[:, 1, 1, None, None] * ry
    dx = _gaussian_blur_1d(_gaussian_blur_1d(draws.dx, sigma, 1), sigma, 2)
    dy = _gaussian_blur_1d(_gaussian_blur_1d(draws.dy, sigma, 1), sigma, 2)
    return src_y + dy * alpha, src_x + dx * alpha


def _elastic_general(image, label, draws: ElasticDraws, alpha: float,
                     sigma: float):
    """The general branch (alpha >= sigma / 10, reached by no default):
    resampled in 2D, bilinear for the image, nearest for the label, mode
    "mirror" (augment.py:289-298)."""
    h, w = label.shape[1:]
    coord_y, coord_x = general_coords(draws, h, w, alpha, sigma)
    img = image if image.ndim == 4 else image[..., None]
    img = torch.stack([map_coordinates(img[..., c].to(torch.float32),
                                       coord_y, coord_x, 1)
                       for c in range(img.shape[-1])], dim=-1)
    img = img if image.ndim == 4 else img[..., 0]
    lab = map_coordinates(label.to(torch.float32), coord_y, coord_x, 0)
    return img.to(image.dtype), lab.to(label.dtype)


def elastic_transform(image, label, draws: ElasticDraws, alpha: float = 1.0,
                      sigma: float = 50.0):
    """Elastic deformation (A.ElasticTransform at its defaults): a random
    affine from jittered corner points plus a Gaussian-smoothed random
    displacement field; bilinear for the image, nearest for the label.
    Where alpha < sigma / 10 the field is sub-pixel and skipped, and the
    affine is applied exactly by the two shear passes (the reference's fast
    branch); otherwise the general branch runs."""
    h, w = label.shape[1:]
    if _fast_branch(alpha, sigma):
        return two_pass_warp(image, label, *elastic_coords(draws, h, w))
    img, lab = _elastic_general(image, label, draws, alpha, sigma)
    return _select(draws.apply, img, image), _select(draws.apply, lab, label)


# --------------------------------------------------------- grid distortion
class GridDraws(NamedTuple):
    """Per-sample draws of grid_distortion."""

    apply: torch.Tensor    # (N,) bool, p
    steps_x: torch.Tensor  # (N, num_steps + 1) float32, 1 + U(-limit, limit)
    steps_y: torch.Tensor  # the same for the rows


def draw_grid(generator: Optional[torch.Generator], n: int,
              num_steps: int = 5, distort_limit: float = 0.3, p: float = 0.5,
              device=None) -> GridDraws:
    device = generator.device if generator is not None else device
    kw = {"generator": generator, "device": device}
    apply = torch.rand((n,), **kw) < p

    def steps():
        u = torch.rand((n, num_steps + 1), **kw)
        return 1.0 + (u * (2.0 * distort_limit) - distort_limit)

    return GridDraws(apply, steps(), steps())


def distortion_map(steps: torch.Tensor, length: int) -> torch.Tensor:
    """(N, num_steps + 1) step factors -> (N, length) source coordinates,
    Albumentations' piecewise-linear map (augment.py:308-342): cells of
    length // num_steps pixels, each an endpoint-inclusive linspace from
    the previous cell's end, the last partial cell forced to end at
    `length` (folding back when the stretch overshot it). The cells are a
    static Python loop; the batch is vectorised."""
    n, num_steps = steps.shape[0], steps.shape[1] - 1
    step = length // num_steps
    prev = torch.zeros((n,), dtype=torch.float32, device=steps.device)
    segments, start = [], 0
    for idx in range(num_steps + 1):
        if start >= length:
            break
        end = min(start + step, length)
        if end == length and start + step > length:
            cur = torch.full_like(prev, float(length))
        else:
            cur = prev + steps[:, idx] * float(step)
        count = end - start
        if count > 1:
            ramp = torch.arange(count, dtype=torch.float32,
                                device=steps.device)
            # a device divisor: CUDA divides by a Python number as a
            # multiplication by its reciprocal
            den = torch.full((), count - 1, dtype=torch.float32,
                             device=steps.device)
            seg = prev[:, None] + (cur - prev)[:, None] * ramp / den
        else:
            seg = prev[:, None]
        segments.append(seg)
        prev, start = cur, end
    return torch.cat(segments, dim=1)[:, :length]


def grid_coords(draws: GridDraws, h: int, w: int):
    """The two passes' source coordinates (N, H, W) of the grid distortion,
    clamped at the edges (augment.py:345-357); the identity where a sample
    does not apply."""
    n = draws.apply.shape[0]
    ys, xs = _grid(n, h, w, draws.apply.device)
    map_y = torch.clamp(distortion_map(draws.steps_y, h), 0.0, h - 1.0)
    map_x = torch.clamp(distortion_map(draws.steps_x, w), 0.0, w - 1.0)
    cy = map_y[:, :, None].expand(n, h, w)
    cx = map_x[:, None, :].expand(n, h, w)
    return _select(draws.apply, cy, ys), _select(draws.apply, cx, xs)


def grid_distortion(image, label, draws: GridDraws):
    """Grid distortion (A.GridDistortion defaults): each grid cell stretched
    or compressed by its drawn factor along each axis; bilinear for the
    image, nearest for the label."""
    h, w = label.shape[1:]
    return two_pass_warp(image, label, *grid_coords(draws, h, w))


def one_of(image, label, choice: torch.Tensor, coords):
    """Exactly one warp per sample (A.OneOf): the warp `choice[n]` of
    `coords`, a sequence of each warp's (coords_y, coords_x) (the warps'
    own apply bits already in them). One pair of passes for the batch."""
    cy, cx = coords[0]
    for j, (cy_j, cx_j) in enumerate(coords[1:], start=1):
        cy = _select(choice == j, cy_j, cy)
        cx = _select(choice == j, cx_j, cx)
    return two_pass_warp(image, label, cy, cx)


# ------------------------------------------------------ the degrees' draws
class Degree3Draws(NamedTuple):
    """Crop, elastic, rot90 and flip parameters of degree 3."""

    top: torch.Tensor   # (N,) int32
    left: torch.Tensor  # (N,) int32
    elastic: ElasticDraws
    k: torch.Tensor     # (N,) int32
    flip: torch.Tensor  # (N,) int32


class Degree4Draws(NamedTuple):
    """Crop and OneOf(elastic, grid) parameters of degrees 4 and 0."""

    top: torch.Tensor     # (N,) int32
    left: torch.Tensor    # (N,) int32
    choice: torch.Tensor  # (N,) int32: 0 elastic, 1 grid distortion
    elastic: ElasticDraws
    grid: GridDraws


def draw_degree3(generator: Optional[torch.Generator], n: int, h: int,
                 w: int, size: int, device=None) -> Degree3Draws:
    d2 = draw_degree2(generator, n, h, w, size, device)
    device = d2.top.device
    return Degree3Draws(d2.top, d2.left,
                        draw_elastic(generator, n, size, size, device=device),
                        d2.k, d2.flip)


def draw_degree4(generator: Optional[torch.Generator], n: int, h: int,
                 w: int, size: int, device=None) -> Degree4Draws:
    if h < size or w < size:
        raise ValueError(f"cannot crop ({h}, {w}) slices to {size}")
    device = generator.device if generator is not None else device
    kw = {"generator": generator, "device": device}
    i32 = torch.int32
    top = torch.randint(0, h - size + 1, (n,), dtype=i32, **kw)
    left = torch.randint(0, w - size + 1, (n,), dtype=i32, **kw)
    choice = torch.randint(0, 2, (n,), dtype=i32, **kw)
    return Degree4Draws(top, left, choice,
                        draw_elastic(generator, n, size, size, device=device),
                        draw_grid(generator, n, device=device))


draw_degree0 = draw_degree4
