"""The port's 3D model layer against the JAX package, on the CPU.

  - The 3D UNet (filters (4, 8, 16), 2 residual units, 1 -> 10 channels) on
    (2, 16, 16, 8) volumes, the same weights carried by
    `import_monai_state_dict`: float64 logits within 1e-10 of the JAX
    SegmentationModel's; float32 within 1e-4 of them (the two float32 paths
    sum in other orders); the weights round-trip through
    `import_monai_state_dict` and `state_dict_from_jax_params` exactly,
    with and without the 1x1 input conv.
  - K1's plain forward and backward at rank 5 (N, H, W, D, C) against the
    Pallas kernel in interpret mode (its `_as_4d` merges the leading
    spatial axes), its jnp reference and jax.vjp, at 1e-5: the site shapes
    of the 3D UNet at a small size, a near-constant channel included; the
    two-phase plans' chunk cap at batch 1 and 4.
  - `build_model`, `model_from_checkpoint` and `load_checkpoint` on 3D
    configs (the `model_3d` preset included), and the entry points' device
    defaults.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctseg_tpu.models import SegmentationModel as JaxSegmentationModel
from ctseg_tpu.models.torch_import import import_monai_state_dict
from ctseg_tpu.ops.pallas.instance_norm import (
    fused_instance_norm_prelu,
    reference_instance_norm_prelu,
)
from ctseg_tpu_torch.models import layers
from ctseg_tpu_torch.models.jax_import import state_dict_from_jax_params
from ctseg_tpu_torch.models.presets import PRESETS
from ctseg_tpu_torch.models.unet import SegmentationModel
from ctseg_tpu_torch.ops import instance_norm
from ctseg_tpu_torch.training import config
from ctseg_tpu_torch.training.config import TrainConfig

FILTERS = (4, 8, 16)
STRIDES = (2, 2)
SHAPE = (2, 16, 16, 8)  # (N, H, W, D): the bottom level is 4 x 4 x 2


def _model(dtype=torch.float64, downsample=False, in_channels=1, seed=0):
    return SegmentationModel(
        in_channels, 10, FILTERS, num_res_units=2, downsample=downsample,
        spatial_dims=3, device="cpu", dtype=dtype,
        generator=torch.Generator().manual_seed(seed))


def _jax_model(dtype, downsample=False):
    return JaxSegmentationModel(
        channels=FILTERS, strides=STRIDES, num_res_units=2,
        downsample=downsample, dtype=dtype, param_dtype=dtype)


def _forward(model, x):
    """(N, H, W, D, C) numpy -> (N, H, W, D, 10) logits, through the
    channels_last_3d layout the trainer gives the model."""
    t = layers.channels_last(torch.from_numpy(x).movedim(-1, 1))
    with torch.no_grad():
        return model(t).movedim(1, -1).numpy()


@pytest.mark.parametrize("downsample", [False, True])
def test_3d_unet_matches_jax_in_float64(downsample):
    in_channels = 3 if downsample else 1
    model = _model(downsample=downsample, in_channels=in_channels)
    params = import_monai_state_dict(
        model.state_dict(), in_channels, FILTERS, strides=STRIDES,
        num_res_units=2, downsample=downsample, dtype=jnp.float64)
    x = np.random.default_rng(1).normal(40, 300, SHAPE + (in_channels,))
    ours = _forward(model, x)
    theirs = np.asarray(_jax_model(jnp.float64, downsample).apply(
        params, jnp.asarray(x)))
    assert ours.shape == SHAPE + (10,)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-10)

    # the weights carry back exactly
    back = state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), in_channels, FILTERS,
        STRIDES, num_res_units=2, downsample=downsample)
    sd = model.state_dict()
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].shape == v.shape and v.ndim in (1, 5), k
        torch.testing.assert_close(back[k], v, rtol=0, atol=0, msg=k)


def test_3d_unet_float32_path_matches_jax():
    model = _model(torch.float32)
    params = import_monai_state_dict(
        model.state_dict(), 1, FILTERS, strides=STRIDES, num_res_units=2,
        dtype=jnp.float32)
    x = np.random.default_rng(2).normal(0, 1, SHAPE + (1,)).astype(np.float32)
    ours = _forward(model, x)
    theirs = np.asarray(_jax_model(jnp.float32).apply(params, jnp.asarray(x)))
    assert ours.dtype == np.float32
    np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=1e-4)


def test_3d_units_keep_channels_last_3d_and_the_2d_units_their_kernel():
    unit = layers.ConvUnit(4, 8, spatial_dims=3)
    assert isinstance(unit.conv, torch.nn.Conv3d) and not unit.fused
    assert layers.ConvUnit(4, 8).fused
    x = layers.channels_last(torch.randn(2, 4, 6, 6, 4))
    assert x.is_contiguous(memory_format=torch.channels_last_3d)
    assert layers._nhwc(x).is_contiguous()  # the kernels' view, no copy
    assert layers._nhwc(x).data_ptr() == x.data_ptr()
    y = unit(x)
    assert y.shape == (2, 8, 6, 6, 4)
    assert y.is_contiguous(memory_format=torch.channels_last_3d)


# ------------------------------------------------------------ K1 at rank 5
K1_SHAPES_3D = [
    (2, 8, 8, 4, 4),    # a level-0 site at a small size
    (2, 4, 4, 2, 8),    # the bottom level
    (1, 16, 16, 8, 10), # the top decoder's transposed conv (C = 10)
    (3, 2, 2, 1, 16),   # a channel of 4 elements
]


def _k1_input(shape, seed):
    x = np.random.default_rng(seed).normal(0.5, 2.0, size=shape)
    x[..., 0] = 3.0 + 1e-6 * x[..., 0]  # near-constant: var rounds to ~0
    return x.astype(np.float32)


@pytest.mark.parametrize("alpha", [0.25, -0.1])
@pytest.mark.parametrize("shape", K1_SHAPES_3D, ids=str)
def test_k1_plain_at_rank_5_matches_pallas(shape, alpha):
    x = _k1_input(shape, 1)
    g = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    a = np.asarray([alpha], np.float32)
    xt, at = torch.from_numpy(x), torch.from_numpy(a)

    ours = instance_norm.instance_norm_prelu(xt, at).numpy()
    pallas, vjp = jax.vjp(
        lambda x, a: fused_instance_norm_prelu(x, a, True),
        jnp.asarray(x), jnp.asarray(a))
    ref = np.asarray(reference_instance_norm_prelu(jnp.asarray(x),
                                                   jnp.asarray(a)))
    assert ours.shape == shape and np.isfinite(ours).all()
    np.testing.assert_allclose(ours[..., 1:], np.asarray(pallas)[..., 1:],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ours[..., 1:], ref[..., 1:], rtol=1e-5,
                               atol=1e-5)

    dx_ref, da_ref = (np.asarray(v) for v in vjp(jnp.asarray(g)))
    _, mean, var = instance_norm._fwd_plain(xt, at)
    assert mean.shape == var.shape == (shape[0], shape[-1])
    dx, da = instance_norm.instance_norm_prelu_bwd(
        xt, torch.from_numpy(g), mean, var, at)
    # dx carries rsqrt(var + eps), about 316, on the near-constant channel
    np.testing.assert_allclose(dx.numpy()[..., 1:], dx_ref[..., 1:],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(da.numpy(), da_ref, rtol=1e-5, atol=1e-5)


def test_k1_rank_5_plans_take_every_3d_bench_site():
    """The kernels' plans on the bench's 17 sites at batch 128 (float32 and
    bfloat16): each site gets a read-once cluster or a two-phase plan whose
    chunks tile the sample, and the wrapper's limits admit it."""
    sites = [(64, 64, 8, 64), (32, 32, 4, 128), (16, 16, 2, 256),
             (8, 8, 1, 512), (8, 8, 1, 1024), (128, 128, 16, 10)]
    for h, w, d, c in sites:
        s = h * w * d
        assert 128 * s * c < 2 ** 31
        for itemsize in (4, 2):
            fwd = instance_norm.fwd_cluster_plan(128, s, c, itemsize) \
                or instance_norm.fwd_plan(128, s, c, itemsize)
            bwd = instance_norm.bwd_cluster_plan(128, s, c, itemsize) \
                or instance_norm.bwd_plan(128, s, c, itemsize)
            assert fwd and bwd, (h, w, d, c, itemsize)


@pytest.mark.parametrize("n,h,w,d,c,chunks", [
    (1, 64, 64, 24, 128, instance_norm.MAX_CHUNKS),   # model_3d, batch 1
    (1, 256, 256, 96, 10, instance_norm.MAX_CHUNKS),
    (4, 128, 128, 48, 10, instance_norm.MAX_CHUNKS),  # evaluation windows
    (128, 128, 128, 16, 10, 17),                      # the bench step
])
def test_k1_two_phase_plans_cap_a_samples_chunks(n, h, w, d, c, chunks):
    """At batch 1 and 4 the two-phase forms take at most MAX_CHUNKS chunks a
    sample (their statistics add a sample's chunks one after another); at
    batch 128 the card is full long before the cap."""
    for plan in (instance_norm.fwd_plan(n, h * w * d, c, 4),
                 instance_norm.bwd_plan(n, h * w * d, c, 4)):
        assert plan["chunks"] == chunks
        assert plan["chunks"] * plan["rows_per_chunk"] >= plan["rows_total"]


# ---------------------------------------------------------- configs and checkpoints
def test_build_model_builds_3d_configs_with_their_channels():
    cfg = TrainConfig(filters=FILTERS, num_res_units=2, spatial_dims=3,
                      in_channels=1, input_shape=(16, 16, 8))
    model = config.build_model(cfg, "cpu", torch.Generator().manual_seed(0))
    assert model.spatial_dims == 3
    assert model.unet.model[0].conv.unit0.conv.weight.shape == (4, 1, 3, 3, 3)
    assert config.input_shape(cfg) == (16, 16, 8)
    assert config.input_shape(dataclasses.replace(cfg, input_shape=None)) \
        == (256, 256, 256)
    preset = config.build_model(
        dataclasses.replace(PRESETS["model_3d"], filters=FILTERS), "cpu")
    assert preset.unet.model[0].conv.unit0.conv.weight.shape[:2] == (4, 1)
    with pytest.raises(ValueError, match="spatial_dims"):
        config.build_model(dataclasses.replace(cfg, spatial_dims=1), "cpu")


def test_3d_checkpoints_load_as_3d_models(tmp_path):
    cfg = TrainConfig(filters=FILTERS, num_res_units=2, spatial_dims=3,
                      in_channels=1, input_shape=(16, 16, 8),
                      volumetric_mode="patch")
    model = config.build_model(cfg, "cpu", torch.Generator().manual_seed(3))
    config.save_checkpoint(tmp_path / "m3d.ckpt", cfg, model)
    cfg2, model2 = config.load_checkpoint(tmp_path / "m3d.ckpt", "cpu")
    assert cfg2 == cfg and not model2.training
    x = np.random.default_rng(4).normal(size=(1, 16, 16, 8, 1)).astype(
        np.float32)
    np.testing.assert_array_equal(_forward(model2, x), _forward(model, x))
