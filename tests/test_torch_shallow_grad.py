"""The port's shallow-channel weight gradients (ctseg_tpu_torch/ops/
shallow_grad.py) against the JAX package's (ctseg_tpu/ops/shallow_grad.py),
on the CPU, where `shallow_dw` runs its plain version (the JAX
formulations in torch; the CUDA kernel runs on the card, chip_smoke.py
phase 16b).

  - `smallc_supported` equals the JAX rule over a grid of (cin, cout,
    stride, k, transpose, ndim, depth), both sides of both thresholds.
  - `conv_smallc` and `conv_transpose_smallc`: forward, dx, dW and db
    against the JAX functions and `jax.vjp` at the shapes of
    tests/test_shallow_grad.py (2D and 3D, odd extents, Cin = 1, k = 5),
    float64 within 1e-10 relative and float32 within 1e-5 of each
    gradient's norm; the plain versions in the JAX layout against the JAX
    functions' own dW.
  - The port's ConvUnit and ConvTransposeUnit route to the Functions at
    exactly the convs where the JAX units route (each call's kind,
    channels and input shape, counted on small 2D and 3D UNets, the depth
    gate included), only when a gradient is taken.
  - No weight-gradient work where the weight needs none; an exported
    artifact still holds only aten ops.
  - The kernels' plans at the routed sites of the main paths and at the
    convs the rule routes beyond them (k = 1, 5, 7; a transposed input
    deeper than one strip): the stride-1 plan (`dw_plan`, csrc/
    shallow_dw.cu; tests/test_torch_shallow_dw_s1.py has its own cases)
    and the transposed plan (`dwt_plan`, csrc/shallow_dwt.cu;
    tests/test_torch_shallow_dwt.py), each held to an H100's limits and to
    what its C entry checks. The plans' walks, emulated in numpy, make the
    plain version's dW and db.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ctseg_tpu.ops.shallow_grad as jax_sg
from ctseg_tpu.models import SegmentationModel as JaxSegmentationModel
from test_torch_shallow_dw_s1 import assert_dw_plan_holds_the_kernel, \
    emulate_dw
from test_torch_shallow_dwt import assert_dwt_plan_holds_the_kernel, \
    emulate_dwt
from ctseg_tpu_torch.inference import export
from ctseg_tpu_torch.models import layers
from ctseg_tpu_torch.models.unet import SegmentationModel
from ctseg_tpu_torch.ops import shallow_grad as sg
from ctseg_tpu_torch.training.config import TrainConfig

CONV_CASES = [  # (N, *spatial), cin, cout, k: tests/test_shallow_grad.py's
    ((2, 12, 10), 10, 10, 3),
    ((2, 12, 10), 3, 10, 3),
    ((3, 8, 10, 6), 10, 10, 3),
    ((2, 9, 7, 5), 1, 12, 3),
    ((2, 11, 9), 10, 4, 5),
    ((2, 7, 5, 9), 10, 10, 5),
]
CONVT_CASES = [  # (N, *spatial), cin, cout
    ((2, 8, 6), 12, 10),
    ((2, 8, 6), 10, 10),
    ((3, 6, 4, 3), 14, 10),
    ((2, 5, 7, 3), 10, 2),
    ((2, 5, 3), 1, 10),
    ((1, 3, 5, 7), 1, 4),
]
DTYPES = {"float64": (np.float64, jnp.float64, torch.float64),
          "float32": (np.float32, jnp.float32, torch.float32)}


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).movedim(-1, 1).requires_grad_()


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().movedim(1, -1).numpy()


def _assert_grad(got, want, dtype):
    """float64: 1e-10 relative; float32: 1e-5 of the norm (the two
    frameworks sum in other orders)."""
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    if dtype == "float64":
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10 * np.abs(
            want).max())
    else:
        assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)


@pytest.mark.parametrize("transpose,ndim", [(False, 2), (False, 3),
                                            (True, 2), (True, 3)])
def test_smallc_supported_equals_jax(transpose, ndim):
    grid = itertools.product(
        (1, 10, 15, 16, 17, 64), (1, 10, 16, 17, 128), (1, 2, 3), (1, 3, 4, 5),
        (None, 1, 16, 63, 64, 65, 96))
    for cin, cout, stride, k, depth in grid:
        kw = dict(transpose=transpose, ndim=ndim, depth=depth)
        assert sg.smallc_supported(cin, cout, stride, k, **kw) == \
            jax_sg.smallc_supported(cin, cout, stride, k, **kw), (
                cin, cout, stride, k, kw)
    assert (sg.SMALLC_THRESHOLD, sg.SMALLC_MERGED_MAX_DEPTH) == (
        jax_sg.SMALLC_THRESHOLD, jax_sg.SMALLC_MERGED_MAX_DEPTH)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,cin,cout,k", CONV_CASES)
def test_conv_smallc_matches_jax_vjp(shape, cin, cout, k, dtype):
    npt, jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(0)
    nd = len(shape) - 1
    pad = (k - 1) // 2
    x = rng.standard_normal(shape + (cin,)).astype(npt)
    w = rng.standard_normal((k,) * nd + (cin, cout)).astype(npt)
    b = rng.standard_normal((cout,)).astype(npt)
    out, vjp = jax.vjp(lambda x_, w_, b_: jax_sg.conv_smallc(x_, w_, b_, 1,
                                                             pad),
                       jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                       jnp.asarray(b, jdt))
    cot = rng.standard_normal(out.shape).astype(npt)
    dx, dw, db = vjp(jnp.asarray(cot, jdt))

    xt = _nchw(x)
    wt = torch.from_numpy(w).permute(nd + 1, nd, *range(nd)).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    y = sg.conv_smallc(xt, wt, bt, 1, pad)
    assert y.dtype == tdt
    _assert_grad(_nhwc(y), out, dtype)  # the two frameworks' own convs
    gx, gw, gb = torch.autograd.grad(y, (xt, wt, bt), _nchw(cot))
    _assert_grad(_nhwc(gx), dx, dtype)
    _assert_grad(gw.permute(*range(2, nd + 2), 1, 0).numpy(), dw, dtype)
    _assert_grad(gb.numpy(), db, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,cin,cout", CONVT_CASES)
def test_conv_transpose_smallc_matches_jax_vjp(shape, cin, cout, dtype):
    npt, jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(1)
    nd = len(shape) - 1
    x = rng.standard_normal(shape + (cin,)).astype(npt)
    w = rng.standard_normal((3,) * nd + (cin, cout)).astype(npt)
    b = rng.standard_normal((cout,)).astype(npt)
    out, vjp = jax.vjp(
        lambda x_, w_, b_: jax_sg.conv_transpose_smallc(x_, w_, b_, 2, 3),
        jnp.asarray(x, jdt), jnp.asarray(w, jdt), jnp.asarray(b, jdt))
    assert out.shape[1:-1] == tuple(2 * e for e in shape[1:])
    cot = rng.standard_normal(out.shape).astype(npt)
    dx, dw, db = vjp(jnp.asarray(cot, jdt))

    # torch's (Cin, Cout, *k), the taps flipped (models/jax_import.py).
    spatial = tuple(range(nd))
    wt = torch.from_numpy(np.flip(w, spatial).copy()).permute(
        nd, nd + 1, *spatial).requires_grad_()
    xt, bt = _nchw(x), torch.from_numpy(b).requires_grad_()
    y = sg.conv_transpose_smallc(xt, wt, bt, 2, 3)
    assert y.dtype == tdt
    _assert_grad(_nhwc(y), out, dtype)  # the two frameworks' own convs
    gx, gw, gb = torch.autograd.grad(y, (xt, wt, bt), _nchw(cot))
    _assert_grad(_nhwc(gx), dx, dtype)
    _assert_grad(np.flip(gw.permute(*range(2, nd + 2), 0, 1).numpy(),
                         spatial), dw, dtype)
    _assert_grad(gb.numpy(), db, dtype)
    # The plain version in the JAX layout is the JAX rule's dW.
    plain = sg.convt_dw_plain(torch.from_numpy(x), torch.from_numpy(cot), 2,
                              3).numpy()
    _assert_grad(plain, dw, dtype)


@pytest.mark.parametrize("shape,cin,cout,k", [c for c in CONV_CASES
                                              if len(c[0]) == 4])
def test_merged_fold_equals_the_jax_merged_fold(shape, cin, cout, k):
    rng = np.random.default_rng(2)
    x = rng.standard_normal(shape + (cin,))
    dy = rng.standard_normal(shape + (cout,))
    want = jax_sg._dw_merged_3d(jnp.asarray(x), jnp.asarray(dy), (k - 1) // 2,
                                k)
    got = sg.dw_merged_3d_plain(torch.from_numpy(x), torch.from_numpy(dy),
                                (k - 1) // 2, k)
    _assert_grad(got.numpy(), want, "float64")


# --------------------------------------------------------------- routing
def _record_jax(monkeypatch):
    calls = []
    conv, convt = jax_sg.conv_smallc, jax_sg.conv_transpose_smallc

    def rec_conv(x, w, b, stride, pad):
        calls.append(("conv", x.shape[-1], w.shape[-1], tuple(x.shape[1:-1])))
        return conv(x, w, b, stride, pad)

    def rec_convt(x, w, b, stride, k, fwd_mode="native"):
        calls.append(("convt", x.shape[-1], w.shape[-1],
                      tuple(x.shape[1:-1])))
        return convt(x, w, b, stride, k, fwd_mode)

    monkeypatch.setattr(jax_sg, "conv_smallc", rec_conv)
    monkeypatch.setattr(jax_sg, "conv_transpose_smallc", rec_convt)
    return calls


def _record_port(monkeypatch):
    calls = []
    conv, convt = layers.conv_smallc, layers.conv_transpose_smallc

    def rec_conv(x, w, b, stride, pad):
        calls.append(("conv", x.shape[1], w.shape[0], tuple(x.shape[2:])))
        return conv(x, w, b, stride, pad)

    def rec_convt(x, w, b, stride, k):
        calls.append(("convt", x.shape[1], w.shape[1], tuple(x.shape[2:])))
        return convt(x, w, b, stride, k)

    monkeypatch.setattr(layers, "conv_smallc", rec_conv)
    monkeypatch.setattr(layers, "conv_transpose_smallc", rec_convt)
    return calls


ROUTING = {  # name: (filters, num_res_units, (N, *spatial))
    "2d": ((4, 8, 16), 2, (1, 16, 16)),
    "2d_no_res_units": ((4, 8, 16), 0, (1, 16, 16)),
    "3d": ((4, 8, 16), 2, (1, 16, 16, 8)),
    "3d_no_res_units": ((4, 8, 16), 0, (1, 16, 16, 8)),
    "3d_wide": ((16, 32, 64), 2, (1, 16, 16, 8)),
    # depths 136, 68, 34: the plain convs route at the last only
    "3d_depth_gate": ((4, 8, 16), 2, (1, 8, 8, 136)),
}


@pytest.mark.parametrize("case", list(ROUTING))
def test_units_route_where_the_jax_units_route(monkeypatch, case):
    filters, res, shape = ROUTING[case]
    nd = len(shape) - 1
    jcalls = _record_jax(monkeypatch)
    jm = JaxSegmentationModel(
        out_channels=10, channels=filters,
        strides=(2,) * (len(filters) - 1), num_res_units=res,
        dtype=jnp.float32, param_dtype=jnp.float32)
    x = np.random.default_rng(3).normal(size=shape + (1,)).astype(np.float32)
    # The JAX units route by shape at trace time: tracing alone records it.
    params = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
    jcalls.clear()
    jax.eval_shape(jm.apply, params, jnp.asarray(x))

    pcalls = _record_port(monkeypatch)
    model = SegmentationModel(1, 10, filters, num_res_units=res,
                              spatial_dims=nd, device="cpu",
                              generator=torch.Generator().manual_seed(0))
    xt = layers.channels_last(torch.from_numpy(x).movedim(-1, 1))
    y = model(xt)
    assert sorted(pcalls) == sorted(jcalls) and jcalls
    y.square().mean().backward()  # the routed backward runs
    assert all(p.grad is not None for p in model.parameters())
    pcalls.clear()
    with torch.no_grad():
        model(xt)
    model.requires_grad_(False)
    model(xt)
    assert pcalls == []  # no gradient taken: the plain calls


@pytest.mark.parametrize("transposed", [False, True])
def test_no_weight_gradient_work_without_a_weight_gradient(monkeypatch,
                                                           transposed):
    calls = []
    real = sg.shallow_dw
    monkeypatch.setattr(sg, "shallow_dw",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 6, 4, 4, 4, generator=g, dtype=torch.float64)
    cout = 5
    w = torch.randn((6, cout, 3, 3, 3) if transposed else (cout, 6, 3, 3, 3),
                    generator=g, dtype=torch.float64)
    b = torch.randn(cout, generator=g, dtype=torch.float64)

    def run(x_, w_, b_):
        if transposed:
            return sg.conv_transpose_smallc(x_, w_, b_, 2, 3), \
                torch.nn.functional.conv_transpose3d(x_, w_, b_, 2, 1, 1)
        return sg.conv_smallc(x_, w_, b_, 1, 1), \
            torch.nn.functional.conv3d(x_, w_, b_, 1, 1)

    xg = x.clone().requires_grad_()
    y, ref = run(xg, w, b)
    (gx,) = torch.autograd.grad(y, xg, torch.ones_like(y))
    (rx,) = torch.autograd.grad(run(xg, w, b)[1], xg, torch.ones_like(y))
    assert calls == [] and torch.allclose(gx, rx, rtol=1e-12, atol=1e-12)
    bg = b.clone().requires_grad_()
    y, _ = run(x, w, bg)
    (gb,) = torch.autograd.grad(y, bg, torch.ones_like(y))
    assert calls == [1]
    torch.testing.assert_close(gb, torch.full_like(gb, y[:, 0].numel()),
                               rtol=1e-12, atol=1e-9)


def test_export_holds_only_aten_ops(monkeypatch):
    calls = _record_port(monkeypatch)
    cfg = TrainConfig(filters=(4, 8, 16), num_res_units=2, spatial_dims=3,
                      input_shape=(16, 16, 8), in_channels=1,
                      volumetric_mode="patch", transform_degree=0)
    model = SegmentationModel(1, 10, cfg.filters, num_res_units=2,
                              spatial_dims=3, device="cpu",
                              generator=torch.Generator().manual_seed(5))
    assert all(p.requires_grad for p in model.parameters())
    ep = export.export_patch_model(model, cfg, (16, 16, 8))
    targets = {str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"}
    assert all(t.startswith("aten.") or "getitem" in t for t in targets), \
        targets
    assert calls == []


# The routed sites of the main paths (chip_smoke.py's SHALLOW_SITES), and
# convs the rule routes beyond them: any odd k, a transposed input deeper
# than one strip. (n, spatial, cin, cout, transposed, k)
SITES = {
    "bench_3d conv": (128, (128, 128, 16), 10, 10, False, 3),
    "bench_3d transposed": (128, (64, 64, 8), 128, 10, True, 3),
    "Model L transposed": (128, (128, 128), 128, 10, True, 3),
    "model_3d transposed": (1, (128, 128, 48), 128, 10, True, 3),
    "phase 18 conv": (2, (32, 32, 8), 16, 16, False, 3),
    "phase 18 transposed": (2, (16, 16, 4), 64, 16, True, 3),
    "k=1 conv at depth 64": (2, (16, 16, 64), 10, 10, False, 1),
    "k=5 conv at depth 64": (2, (16, 16, 64), 10, 10, False, 5),
    "k=7 conv at depth 64": (2, (16, 16, 64), 16, 16, False, 7),
    "transposed from depth 400": (1, (8, 8, 400), 128, 10, True, 3),
    "transposed from depth 5000": (1, (4, 4, 5000), 16, 16, True, 3),
}


@pytest.mark.parametrize("site", list(SITES))
@pytest.mark.parametrize("itemsize", [4, 2])
def test_the_kernel_plan_at_the_sites(site, itemsize):
    n, spatial, cin, cout, transposed, k = SITES[site]
    if transposed:  # csrc/shallow_dwt.cu's plan
        plan = sg.dwt_plan(n, spatial, cin, cout, itemsize)
        assert plan["smem_bytes"] <= sg.MAX_SHARED
        assert_dwt_plan_holds_the_kernel(plan, n, spatial, cin, cout,
                                         itemsize)
        flop, _ = sg.dw_work(n, spatial, cin, cout, True)
        assert 0 < flop <= 2 * n * np.prod(spatial) * 3 ** len(spatial) * \
            cin * cout + n * np.prod(spatial) * 2 ** len(spatial) * cout
        return
    plan = sg.dw_plan(n, spatial, cin, cout, itemsize, k)
    assert plan["smem_bytes"] <= sg.MAX_SHARED
    assert_dw_plan_holds_the_kernel(plan, n, spatial, cin, cout, itemsize, k)
    flop, nbytes = sg.dw_work(n, spatial, cin, cout, transposed, k)
    taps = k ** len(spatial)
    assert 0 < flop <= 2 * n * np.prod(spatial) * taps * cin * cout + \
        n * np.prod(spatial) * 2 ** len(spatial) * cout


EMULATED = {  # (N, *spatial), cin, cout, transposed, k, strip
    # The stride-1 kernel takes whole columns of d: runs of t1 columns (the
    # last one ragged), or one column where a column is over a strip.
    "conv k=3, whole columns": ((2, 3, 5, 4), 3, 4, False, 3, 8),
    "conv k=3, column over a strip": ((1, 3, 4, 11), 3, 4, False, 3, 4),
    "conv k=1, column over a strip": ((2, 2, 3, 10), 2, 3, False, 1, 4),
    "conv k=5, column over a strip": ((1, 3, 4, 7), 2, 3, False, 5, 3),
    "transposed 3D, whole columns": ((2, 3, 4, 3), 3, 2, True, 3, 8),
    "transposed 3D, depth tiles": ((1, 2, 3, 10), 3, 2, True, 3, 4),
    "transposed 2D": ((2, 5, 7), 3, 2, True, 3, 4),
}


@pytest.mark.parametrize("case", list(EMULATED))
def test_the_plans_strips_and_windows_make_the_weight_gradient(monkeypatch,
                                                               case):
    shape, cin, cout, transposed, k, strip = EMULATED[case]
    rng = np.random.default_rng(6)
    spatial = shape[1:]
    osp = tuple(e * (2 if transposed else 1) for e in spatial)
    x = rng.standard_normal(shape + (cin,))
    dy = rng.standard_normal((shape[0],) + osp + (cout,))
    pdw, pdb = sg.shallow_dw(_nchw(x).detach(), _nchw(dy).detach(),
                             transposed, k)
    if transposed:
        monkeypatch.setattr(sg, "DWT_STRIPS", {4: (strip,)})
        plan = sg.dwt_plan(shape[0], spatial, cin, cout, 4)
        assert plan["strip"] == strip
        assert_dwt_plan_holds_the_kernel(plan, shape[0], spatial, cin, cout,
                                         4)
        dw, db = emulate_dwt(x, dy, plan)  # torch's layout
        want = pdw
    else:
        monkeypatch.setattr(sg, "STRIPS", {4: (strip,)})
        plan = sg.dw_plan(shape[0], spatial, cin, cout, 4, k)
        assert plan["strip"] == strip
        assert plan["t1"] == max(1, min(spatial[1], strip // spatial[2]))
        assert_dw_plan_holds_the_kernel(plan, shape[0], spatial, cin, cout,
                                        4, k)
        dw, db = emulate_dw(x, dy, plan)  # torch's layout
        want = pdw
    _assert_grad(dw, want.numpy(), "float64")
    _assert_grad(db, pdb.numpy(), "float64")
