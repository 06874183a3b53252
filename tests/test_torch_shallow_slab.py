"""The shallow weight gradients on depth slabs (the depth-sharded 3D step)
against the JAX package's whole-volume VJP, on the CPU, with the slabs
emulated in one process: a whole volume cut into 2 and 4 slabs, each slab
taking the halo rows `DepthShard` takes (zeros past the volume's ends),
read straight from the whole volume, so that autograd adds each slab's
share into the whole volume's gradients as the ranks' sum does.

  - The stride-1 conv (`DepthShard.conv` with `conv_smallc`: x extended by
    p rows each side, the conv unpadded along D) and the k=3 s=2 transposed
    conv (`DepthShard.conv_transpose_smallc`: x extended by one row after
    it, the slab's 2m output rows kept): the slabs' summed dW and db, and
    the slabs' outputs and dx, against `jax.vjp` of the JAX
    `conv_smallc` / `conv_transpose_smallc` on the whole volume, float64
    within 1e-10 and float32 within 1e-5 of each gradient's norm (as
    tests/test_torch_shallow_grad.py holds them); k 3 and 5, odd and even
    channel counts. Each slab's weight gradient is one `shallow_dw` call
    at the slab's geometry (depth padding 0; dy 2m rows against x's m + 1).
  - The routing rule on slabs: the port's units on a slab route exactly
    where the JAX units route on the whole volume (the depth gate read on
    the global depth: at depth 96 on 2 and 4 slabs the stride-1 conv does
    not route, the transposed conv does), and nothing routes without a
    gradient.
  - The kernels' walks (tests/test_torch_shallow_dw_s1.py::emulate_dw,
    tests/test_torch_shallow_dwt.py::emulate_dwt, numpy emulations of
    csrc/shallow_dw.cu and csrc/shallow_dwt.cu) at the slab geometry equal
    the plain versions, and `dw_work`'s pairs at the slab shapes are the
    pairs counted one by one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import ctseg_tpu.ops.shallow_grad as jax_sg
from ctseg_tpu.models.layers import ConvTransposeUnit as JaxConvTransposeUnit
from ctseg_tpu.models.layers import ConvUnit as JaxConvUnit
from test_torch_shallow_dw_s1 import emulate_dw
from test_torch_shallow_dwt import emulate_dwt
from ctseg_tpu_torch.models import layers
from ctseg_tpu_torch.ops import shallow_grad as sg
from ctseg_tpu_torch.parallel.collectives import DepthShard

DTYPES = {"float64": (np.float64, jnp.float64),
          "float32": (np.float32, jnp.float32)}
SHAPE = (2, 5, 4, 8)  # (N, H, W, D) of the whole volume's x
# (transposed, cin, cout, k)
CASES = {
    "conv k=3 10 -> 10": (False, 10, 10, 3),
    "conv k=3 3 -> 7": (False, 3, 7, 3),
    "conv k=5 4 -> 6": (False, 4, 6, 5),
    "conv k=5 7 -> 5": (False, 7, 5, 5),
    "transposed 12 -> 10": (True, 12, 10, 3),
    "transposed 9 -> 7": (True, 9, 7, 3),
    "transposed 16 -> 4": (True, 16, 4, 3),
}


class EmulatedSlab(DepthShard):
    """Slab `index` of `n` of the whole volume `whole` (N, C, H, W, D):
    DepthShard's geometry with no process group, its halos read from the
    whole volume (zeros past its ends), so that autograd sends each halo's
    cotangent to the rows it came from, as `_Halo.backward` sends it to the
    neighbours."""

    def __init__(self, whole: torch.Tensor, n: int, index: int):
        self.whole, self.n, self.index = whole, n, index
        self.group, self.ranks, self.min_depth = None, tuple(range(n)), 2

    def halo(self, x, left, right):
        m = x.shape[-1]
        return F.pad(self.whole, (left, right)).narrow(
            -1, self.index * m, m + left + right)


def _assert_grad(got, want, dtype):
    """float64: 1e-10 relative; float32: 1e-5 of the norm."""
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    if dtype == "float64":
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10 * np.abs(
            want).max())
    else:
        assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().movedim(1, -1).numpy()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("slabs", [2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_slab_gradients_sum_to_the_jax_whole_volume_vjp(monkeypatch, case,
                                                        slabs, dtype):
    transposed, cin, cout, k = CASES[case]
    npt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(sum(map(ord, case)) + slabs)
    x = rng.standard_normal(SHAPE + (cin,)).astype(npt)
    w = rng.standard_normal((k,) * 3 + (cin, cout)).astype(npt)
    b = rng.standard_normal((cout,)).astype(npt)
    pad = (k - 1) // 2
    if transposed:
        fn = lambda x_, w_, b_: jax_sg.conv_transpose_smallc(  # noqa: E731
            x_, w_, b_, 2, 3)
    else:
        fn = lambda x_, w_, b_: jax_sg.conv_smallc(  # noqa: E731
            x_, w_, b_, 1, pad)
    out, vjp = jax.vjp(fn, jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                       jnp.asarray(b, jdt))
    cot = rng.standard_normal(out.shape).astype(npt)
    dx, dw, db = vjp(jnp.asarray(cot, jdt))

    calls = []
    real = sg.shallow_dw
    monkeypatch.setattr(sg, "shallow_dw", lambda x_, dy_, *a: calls.append(
        (tuple(x_.shape), tuple(dy_.shape), a)) or real(x_, dy_, *a))
    xt = torch.from_numpy(x).movedim(-1, 1).requires_grad_()
    if transposed:  # torch's (Cin, Cout, *k), the taps flipped
        wt = torch.from_numpy(np.flip(w, (0, 1, 2)).copy()).permute(
            3, 4, 0, 1, 2).requires_grad_()
    else:
        wt = torch.from_numpy(w).permute(4, 3, 0, 1, 2).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    cott = torch.from_numpy(cot).movedim(-1, 1)
    m = SHAPE[-1] // slabs
    rows = 2 * m if transposed else m
    ys = []
    for i in range(slabs):
        space = EmulatedSlab(xt, slabs, i)
        xs = space.slab(xt)
        if transposed:
            y = space.conv_transpose_smallc(sg.conv_transpose_smallc, xs, wt,
                                            bt, 2, 3)
        else:
            y = space.conv(sg.conv_smallc, xs, wt, bt, (1,) * 3, (pad,) * 3,
                           k)
        assert y.shape[-1] == rows
        (y * cott[..., i * rows:(i + 1) * rows]).sum().backward()
        ys.append(y.detach())
    # One weight gradient a slab, at the slab's geometry.
    xd = m + 1 if transposed else m + 2 * pad
    assert [c[:2] for c in calls] == [
        ((SHAPE[0], cin) + SHAPE[1:3] + (xd,),
         (SHAPE[0], cout) + tuple((2 if transposed else 1) * e
                                  for e in SHAPE[1:3]) + (rows,))] * slabs
    _assert_grad(_nhwc(torch.cat(ys, dim=-1)), out, dtype)
    _assert_grad(_nhwc(xt.grad), dx, dtype)
    if transposed:
        gw = np.flip(wt.grad.permute(2, 3, 4, 0, 1).numpy(), (0, 1, 2))
    else:
        gw = wt.grad.permute(2, 3, 4, 1, 0).numpy()
    _assert_grad(gw, dw, dtype)
    _assert_grad(bt.grad.numpy(), db, dtype)


# --------------------------------------------------------------- routing
# (kind, cin, cout, k)
ROUTING_UNITS = (("conv", 10, 10, 3), ("conv", 4, 4, 5), ("conv", 32, 32, 3),
                 ("convt", 32, 10, 3), ("convt", 32, 32, 3))


def _jax_routes(monkeypatch, kind, cin, cout, k, depth):
    """Whether the JAX unit routes on the whole volume (N, 2, 2, depth,
    cin): its call of conv_smallc or conv_transpose_smallc, traced."""
    calls = []
    for name in ("conv_smallc", "conv_transpose_smallc"):
        real = getattr(jax_sg, name)
        monkeypatch.setattr(jax_sg, name, lambda *a, _r=real, _n=name: (
            calls.append(_n), _r(*a))[1])
    unit = (JaxConvUnit if kind == "conv" else JaxConvTransposeUnit)(
        features=cout, kernel_size=k, conv_only=True)
    x = jnp.zeros((1, 2, 2, depth, cin), jnp.float32)
    params = jax.eval_shape(unit.init, jax.random.PRNGKey(0), x)
    calls.clear()
    jax.eval_shape(unit.apply, params, x)
    monkeypatch.undo()
    return calls


@pytest.mark.parametrize("slabs", [2, 4])
@pytest.mark.parametrize("depth", [8, 64, 96, 128])
def test_units_on_a_slab_route_where_the_jax_units_route(monkeypatch, depth,
                                                         slabs):
    for kind, cin, cout, k in ROUTING_UNITS:
        want = _jax_routes(monkeypatch, kind, cin, cout, k, depth)
        calls = []
        for name in ("conv_smallc", "conv_transpose_smallc"):
            real = getattr(layers, name)
            monkeypatch.setattr(layers, name, lambda *a, _r=real, _n=name: (
                calls.append(_n), _r(*a))[1])
        unit = (layers.ConvUnit if kind == "conv" else
                layers.ConvTransposeUnit)(cin, cout, k, conv_only=True,
                                          spatial_dims=3)
        whole = torch.zeros(1, cin, 2, 2, depth)
        space = EmulatedSlab(whole, slabs, slabs - 1)
        y = unit(space.slab(whole), space)
        assert y.shape[-1] == depth // slabs * (2 if kind == "convt" else 1)
        assert calls == want, (kind, cin, cout, k, depth, slabs)
        if depth == 96 and cout == 10:  # the gate reads the global depth
            assert calls == ([] if kind == "conv" else
                             ["conv_transpose_smallc"])
        calls.clear()
        with torch.no_grad():
            unit(space.slab(whole), space)
        assert calls == []
        monkeypatch.undo()


# ----------------------------------------------- the kernels' slab walks
@pytest.mark.parametrize("slabs", [2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_the_kernels_walks_at_the_slab_geometry(monkeypatch, case, slabs):
    """csrc/shallow_dw.cu's and csrc/shallow_dwt.cu's walks, emulated in
    numpy, on slab i's x with its halo (zeros past the volume) and its dy,
    equal the plain versions at the slab's geometry, float32 plans."""
    transposed, cin, cout, k = CASES[case]
    pad = (k - 1) // 2
    rng = np.random.default_rng(slabs)
    m = SHAPE[-1] // slabs
    whole = rng.standard_normal(SHAPE + (cin,))
    i = slabs - 1 if transposed else 1  # the last slab's halo is zeros
    if transposed:
        xs = np.pad(whole, ((0, 0),) * 3 + ((0, 1), (0, 0)))[
            :, :, :, i * m:(i + 1) * m + 1]
        dy = rng.standard_normal((SHAPE[0],) + tuple(
            2 * e for e in SHAPE[1:3]) + (2 * m, cout))
        plan = sg.dwt_plan(SHAPE[0], xs.shape[1:4], cin, cout, 4)
        dw, db = emulate_dwt(xs, dy, plan)
    else:
        monkeypatch.setattr(sg, "STRIPS", {4: (8,)})
        monkeypatch.setattr(sg, "MIN_BLOCKS", 4)
        xs = np.pad(whole, ((0, 0),) * 3 + ((pad, pad), (0, 0)))[
            :, :, :, i * m:(i + 1) * m + 2 * pad]
        dy = rng.standard_normal(SHAPE[:3] + (m, cout))
        plan = sg.dw_plan(SHAPE[0], dy.shape[1:4], cin, cout, 4, k)
        dw, db = emulate_dw(xs, dy, plan)
    pdw, pdb = sg.shallow_dw(torch.from_numpy(xs).movedim(-1, 1),
                             torch.from_numpy(dy).movedim(-1, 1), transposed,
                             k, None, None, None if transposed else 0)
    np.testing.assert_allclose(dw, pdw.numpy(), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(db, pdb.numpy(), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("slabs", [1, 2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_dw_work_counts_the_slab_pairs(case, slabs):
    transposed, cin, cout, k = CASES[case]
    pad = (k - 1) // 2
    m = SHAPE[-1] // slabs
    s = 2 if transposed else 1
    if slabs == 1:  # the whole volume: dw_work's default geometry
        spatial, out_depth = SHAPE[1:], None
    else:
        spatial = SHAPE[1:3] + ((m + 1) if transposed else (m + 2 * pad),)
        out_depth = s * m
    ext = [s * e for e in spatial[:2]] + [out_depth or s * spatial[2]]
    pads = [pad, pad, pad if out_depth is None or transposed else 0]
    pairs = 1
    for e, f, p in zip(spatial, ext, pads):
        if transposed:  # input i writes output 2i - 1 + t
            pairs *= sum(0 <= 2 * i - 1 + t < f for i in range(e)
                         for t in range(3))
        else:  # output o reads input o + t - p
            pairs *= sum(0 <= o + t - p < e for o in range(f)
                         for t in range(k))
    flop, nbytes = sg.dw_work(SHAPE[0], spatial, cin, cout, transposed, k,
                              out_depth)
    out_vox = SHAPE[0] * int(np.prod(ext))
    assert flop == 2 * SHAPE[0] * pairs * cin * cout + out_vox * cout
    assert nbytes == 4 * (SHAPE[0] * int(np.prod(spatial)) * cin
                          + out_vox * cout + k ** 3 * cin * cout + cout)
