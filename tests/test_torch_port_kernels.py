"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version (the CUDA
kernels are compared with those plain versions on the card by
chip_smoke.py). Here the plain versions meet the Pallas kernels in
interpret mode and their jnp references, on the same float32 inputs made
with numpy from a seed:

  - K1 (ops/instance_norm.py) vs instance_norm.fused_instance_norm_prelu and
    reference_instance_norm_prelu, at a resident and a streaming tile shape,
    for alpha > 0, < 0 and = 0 and a near-constant channel: 1e-5.
  - K2 (ops/conv_block.py) vs conv_block.fused_conv3x3_in_prelu,
    conv_block.reference_conv3x3_in_prelu and the float32 prototype
    conv_fused.conv3x3_in_prelu: 1e-4 (float32 sums over 9*Cin products).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctseg_tpu.ops.pallas import conv_block as jax_conv_block
from ctseg_tpu.ops.pallas import conv_fused as jax_conv_fused
from ctseg_tpu.ops.pallas.instance_norm import (
    _pick_tile,
    fused_instance_norm_prelu,
    reference_instance_norm_prelu,
)
from ctseg_tpu_torch.ops import _build
from ctseg_tpu_torch.ops.conv_block import (
    conv3x3_in_prelu,
    conv3x3_in_prelu_plain,
)
from ctseg_tpu_torch.ops.instance_norm import (
    instance_norm_prelu,
    instance_norm_prelu_plain,
)

K1_SHAPES = {
    "resident": (2, 16, 12, 8),
    "streaming": (1, 160, 128, 4),  # h*w*32*4 bytes > the 2 MiB budget
}


def _k1_input(shape, seed):
    x = np.random.default_rng(seed).normal(0.5, 2.0, size=shape)
    x[..., 0] = 3.0 + 1e-6 * x[..., 0]  # near-constant: var rounds to ~0
    return x.astype(np.float32)


@pytest.mark.parametrize("alpha", [0.25, -0.1, 0.0])
@pytest.mark.parametrize("form", sorted(K1_SHAPES))
def test_k1_plain_matches_pallas(form, alpha):
    shape = K1_SHAPES[form]
    n, h, w, c = shape
    assert _pick_tile(c, h, w)[2] == (form == "resident")
    x = _k1_input(shape, seed=1)
    a = np.asarray([alpha], np.float32)

    ours = instance_norm_prelu(torch.from_numpy(x), torch.from_numpy(a)).numpy()
    pallas = np.asarray(fused_instance_norm_prelu(jnp.asarray(x), jnp.asarray(a), True))
    ref = np.asarray(reference_instance_norm_prelu(jnp.asarray(x), jnp.asarray(a)))

    assert ours.dtype == np.float32 and ours.shape == shape
    # The clamp keeps the near-constant channel finite; its values are
    # (x - mean) * rsqrt(eps), rounding noise of each summation order.
    assert np.isfinite(ours).all() and np.isfinite(pallas).all()
    np.testing.assert_allclose(ours[..., 1:], pallas[..., 1:], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ours[..., 1:], ref[..., 1:], rtol=1e-5, atol=1e-5)


def test_k1_plain_clamps_negative_variance():
    """Regression of tests/test_pallas.py's constant channel: its one-pass
    float32 variance rounds to -0.125; the clamp keeps the output finite."""
    x = np.random.default_rng(2).normal(0.0, 2.0, size=(2, 16, 32, 8))
    x[..., 0] = 1174.4667844096757
    x = x.astype(np.float32)
    out = instance_norm_prelu_plain(
        torch.from_numpy(x), torch.tensor([0.25])
    ).numpy()
    assert np.isfinite(out).all()


def _k2_inputs(n, h, w, cin, cout, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h, w, cin)).astype(np.float32)
    wgt = (rng.normal(size=(3, 3, cin, cout)) * 0.2).astype(np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32)
    return x, wgt, b


K2_SHAPES = [(2, 12, 12, 8, 16), (1, 9, 7, 6, 5)]


@pytest.mark.parametrize("alpha", [0.25, -0.1])
@pytest.mark.parametrize("shape", K2_SHAPES)
def test_k2_plain_matches_pallas(shape, alpha):
    x, wgt, b = _k2_inputs(*shape, seed=3)
    a = np.asarray([alpha], np.float32)
    t = [torch.from_numpy(v) for v in (x, wgt, b, a)]
    j = [jnp.asarray(v) for v in (x, wgt, b, a)]

    ours = conv3x3_in_prelu(*t).numpy()
    fused = np.asarray(jax_conv_block.fused_conv3x3_in_prelu(*j, True))
    ref = np.asarray(jax_conv_block.reference_conv3x3_in_prelu(*j))

    assert ours.shape == shape[:3] + (shape[4],)
    np.testing.assert_allclose(ours, fused, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", K2_SHAPES)
def test_k2_plain_matches_f32_prototype(shape):
    """K3 (conv_fused.py) is K2's float32 forward: the same port covers it."""
    x, wgt, b = _k2_inputs(*shape, seed=4)
    a = np.asarray([0.25], np.float32)
    ours = conv3x3_in_prelu_plain(
        *[torch.from_numpy(v) for v in (x, wgt, b, a)]
    ).numpy()
    j = [jnp.asarray(v) for v in (x, wgt, b, a)]
    proto = np.asarray(jax_conv_fused.conv3x3_in_prelu(*j, interpret=True))
    ref = np.asarray(jax_conv_fused.reference_conv3x3_in_prelu(*j))
    np.testing.assert_allclose(ours, proto, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)


def test_cpu_tensors_take_the_plain_versions_without_launching():
    x, wgt, b = _k2_inputs(1, 6, 6, 4, 4, seed=5)
    a = torch.tensor([0.25])
    k1, k2 = instance_norm_prelu.launches, conv3x3_in_prelu.launches
    t = [torch.from_numpy(v) for v in (x, wgt, b)]
    torch.testing.assert_close(
        conv3x3_in_prelu(*t, a), conv3x3_in_prelu_plain(*t, a), rtol=0, atol=0
    )
    torch.testing.assert_close(
        instance_norm_prelu(t[0], a), instance_norm_prelu_plain(t[0], a),
        rtol=0, atol=0,
    )
    assert (instance_norm_prelu.launches, conv3x3_in_prelu.launches) == (k1, k2)


def test_plain_versions_keep_float64_and_bfloat16():
    x, wgt, b = _k2_inputs(1, 6, 6, 4, 4, seed=6)
    a = torch.tensor([0.25], dtype=torch.float64)
    t64 = [torch.from_numpy(v).double() for v in (x, wgt, b)]
    assert conv3x3_in_prelu(*t64, a).dtype == torch.float64
    assert instance_norm_prelu(t64[0], a).dtype == torch.float64
    x16 = t64[0].to(torch.bfloat16)
    y16 = instance_norm_prelu(x16, a.float())
    assert y16.dtype == torch.bfloat16
    # statistics in float32 on the bf16 values, one rounding of the output
    y32 = instance_norm_prelu(x16.float(), a.float())
    torch.testing.assert_close(y16.float(), y32, rtol=2.0 ** -7, atol=1e-5)


@pytest.mark.parametrize("bad", ["w_shape", "b_shape", "alpha", "x_rank"])
def test_wrappers_reject_bad_shapes(bad):
    x = torch.zeros(1, 6, 6, 4)
    w, b, a = torch.zeros(3, 3, 4, 8), torch.zeros(8), torch.zeros(1)
    if bad == "w_shape":
        w = torch.zeros(8, 4, 3, 3)  # the MONAI layout, not (3, 3, Cin, Cout)
    elif bad == "b_shape":
        b = torch.zeros(4)
    elif bad == "alpha":
        a = torch.zeros(2)
    else:
        x = torch.zeros(6, 6, 4)
    with pytest.raises(ValueError):
        conv3x3_in_prelu(x, w, b, a)
    if bad in ("alpha", "x_rank"):
        with pytest.raises(ValueError):
            instance_norm_prelu(x[0] if bad == "x_rank" else x, a)


def test_kernel_build_has_no_fallback(monkeypatch):
    """Without nvcc the loader raises; it never substitutes anything."""
    import torch.utils.cpp_extension as cpp

    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_kernel_build_key_tracks_sources():
    srcs = [p.name for p in _build.sources()]
    assert {"common.cuh", "instance_norm.cu", "conv_block.cu",
            "preprocess.cu"} <= set(srcs)
    assert len(_build.build_key()) == 16
    assert _build.BUILD_ROOT.name == "_build"
