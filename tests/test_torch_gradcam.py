"""The port's GradCAM (ctseg_tpu_torch/interpret/) against the JAX package's,
on the CPU, and the conv backward's output mask it relies on.

  - `gradcam` at every layer name of a 2D model (2 residual units, as Model
    L) and at one 3D layer, `gradcam_all_structures` and run_interpretability's
    `.npy` files: float64 on both sides, the port's weights imported into
    the JAX model, within 1e-8 of each map's max.
  - An unknown layer raises KeyError; no hook is left and the parameters
    and their `requires_grad` are as before the call.
  - conv3x3_backward computes only what `ctx.needs_input_grad` asks for:
    dx unchanged, dw and db None with frozen parameters; a training step's
    gradients are unchanged.
"""

import importlib.util

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctseg_tpu.interpret.gradcam import gradcam as jax_gradcam
from ctseg_tpu.interpret.gradcam import (
    gradcam_all_structures as jax_gradcam_all,
)
from ctseg_tpu.interpret.run import run_interpretability as jax_run
from ctseg_tpu.models import SegmentationModel as JaxSegmentationModel
from ctseg_tpu.models.torch_import import import_monai_state_dict
from ctseg_tpu.training.trainer import TrainConfig as JaxTrainConfig
from ctseg_tpu.training.trainer import Trainer as JaxTrainer
from ctseg_tpu_torch.data.datasets import PackedDataset2D
from ctseg_tpu_torch.interpret.gradcam import (
    class_activation_maps,
    gradcam,
    gradcam_all_structures,
    layers,
)
from ctseg_tpu_torch.interpret.run import run_interpretability
from ctseg_tpu_torch.models.layers import channels_last
from ctseg_tpu_torch.ops import conv_block
from ctseg_tpu_torch.training.config import TrainConfig, build_model
from ctseg_tpu_torch.transforms.pipelines import get_transform

FILTERS = (4, 8, 16)
SIZE = 16


def _pair(spatial_dims=2, in_channels=3, num_res_units=2, seed=0):
    """A float64 port model and the JAX model with the same weights."""
    cfg = TrainConfig(filters=FILTERS, num_res_units=num_res_units,
                      compute_dtype="float64", spatial_dims=spatial_dims,
                      in_channels=in_channels)
    model = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(seed))
    jm = JaxSegmentationModel(out_channels=10, channels=FILTERS,
                              strides=(2, 2), num_res_units=num_res_units,
                              dtype=jnp.float64, param_dtype=jnp.float64)
    params = import_monai_state_dict(
        model.state_dict(), in_channels, FILTERS, strides=(2, 2),
        num_res_units=num_res_units, dtype=jnp.float64)
    return model, jm, params


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape)


def _port(x_last: np.ndarray) -> torch.Tensor:
    """(N, *spatial, C) numpy -> (N, C, *spatial) channels_last tensor."""
    return channels_last(torch.from_numpy(x_last).movedim(-1, 1))


def _assert_maps_close(ours: np.ndarray, theirs: np.ndarray, lead: int,
                       rtol: float = 1e-8):
    """Each map (the axes after the first `lead`) within `rtol` of its max."""
    assert ours.shape == theirs.shape
    maps_o = ours.reshape(int(np.prod(ours.shape[:lead])), -1)
    maps_t = theirs.reshape(maps_o.shape)
    scale = np.abs(maps_t).max(axis=1)
    assert (scale > 0).sum() >= len(scale) // 2  # most maps are not all zero
    err = np.abs(maps_o - maps_t).max(axis=1)
    assert np.all(err <= rtol * np.maximum(scale, 1e-300)), (err, scale)


@pytest.fixture(scope="module")
def pair2d():
    return _pair()


def test_layer_names_are_the_jax_ones(pair2d):
    model = pair2d[0]
    assert list(layers(model)) == ["feat_down0", "feat_down1", "feat_bottom",
                                   "feat_up1"]
    unet = model.unet.model
    found = layers(model)
    assert found["feat_down0"] is unet[0]
    assert found["feat_down1"] is unet[1].submodule[0]
    assert found["feat_bottom"] is unet[1].submodule[1].submodule
    assert found["feat_up1"] is unet[1].submodule[2]
    deep = build_model(TrainConfig(filters=(2, 4, 8, 16, 32), num_res_units=1),
                       "cpu")
    assert list(layers(deep)) == [
        "feat_down0", "feat_down1", "feat_down2", "feat_down3", "feat_bottom",
        "feat_up3", "feat_up2", "feat_up1"]


@pytest.mark.parametrize("layer", ["feat_down0", "feat_down1", "feat_bottom",
                                   "feat_up1"])
def test_gradcam_matches_jax_at_every_layer(pair2d, layer):
    model, jm, params = pair2d
    x = _x((2, SIZE, SIZE, 3), seed=1)
    for c in (1, 6):
        theirs = np.asarray(jax_gradcam(jm, params, jnp.asarray(x), c, layer))
        ours = gradcam(model, _port(x), c, layer)
        assert ours.dtype == torch.float64 and ours.shape == (2, SIZE, SIZE)
        assert (ours >= 0).all()
        _assert_maps_close(ours.numpy(), theirs, 1)


def test_gradcam_3d_matches_jax():
    model, jm, params = _pair(spatial_dims=3, in_channels=1, num_res_units=1)
    x = _x((1, 8, 8, 4, 1), seed=2)
    theirs = np.asarray(jax_gradcam_all(jm, params, jnp.asarray(x),
                                        "feat_down1"))
    ours = gradcam_all_structures(model, _port(x), "feat_down1")
    assert ours.shape == (1, 9, 8, 8, 4)
    _assert_maps_close(ours.numpy(), theirs, 2)


def test_all_structures_equals_the_single_maps_stacked(pair2d):
    model, jm, params = pair2d
    x = _x((2, SIZE, SIZE, 3), seed=3)
    every = gradcam_all_structures(model, _port(x), "feat_down1")
    assert every.shape == (2, 9, SIZE, SIZE)
    singles = torch.stack([gradcam(model, _port(x), c, "feat_down1")
                           for c in range(1, 10)], dim=1)
    assert torch.equal(every, singles)
    theirs = np.asarray(jax_gradcam_all(jm, params, jnp.asarray(x),
                                        "feat_down1"))
    _assert_maps_close(every.numpy(), theirs, 2)


def test_parts_are_the_maps_before_their_relu_and_resize(pair2d):
    """What `with_parts` returns is what the maps are made of: the pooled
    gradient times the activation, before the ReLU and the resize."""
    model = pair2d[0]
    x = _port(_x((2, SIZE, SIZE, 3), seed=5))
    cams, logits, parts = class_activation_maps(model, x, (2, 7),
                                                "feat_down1", with_parts=True)
    act, grads, maps = parts["activation"], parts["gradients"], parts["maps"]
    assert grads.shape == (2, *act.shape) and maps.shape == (2, 2, 4, 4)
    pooled = grads.mean(dim=(3, 4), keepdim=True)
    assert torch.allclose(maps, (pooled * act).sum(dim=2), rtol=1e-12)
    again, _ = class_activation_maps(model, x, (2, 7), "feat_down1")
    assert torch.equal(cams, again)
    assert torch.equal(cams[1], gradcam(model, x, 7, "feat_down1"))
    assert torch.equal(torch.nn.functional.interpolate(
        torch.relu(maps).reshape(4, 1, 4, 4), size=(SIZE, SIZE),
        mode="bilinear", align_corners=False).reshape(cams.shape), cams)
    assert logits.shape == (2, 10, SIZE, SIZE) and not logits.requires_grad


def test_unknown_layer_raises_key_error(pair2d):
    with pytest.raises(KeyError, match="feat_bottom"):
        gradcam(pair2d[0], _port(_x((1, SIZE, SIZE, 3), 0)), 1, "nonexistent")


def test_no_hook_left_and_parameters_unchanged(pair2d):
    model = pair2d[0]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    model.unet.model[0].conv.unit0.conv.weight.requires_grad_(False)
    try:
        flags = [p.requires_grad for p in model.parameters()]
        gradcam(model, _port(_x((1, SIZE, SIZE, 3), 4)), 2, "feat_bottom")
        assert [p.requires_grad for p in model.parameters()] == flags
        assert all(p.grad is None for p in model.parameters())
        for m in model.modules():
            assert not m._forward_hooks
        for k, v in model.state_dict().items():
            assert torch.equal(v, before[k]), k
        # and a failing call restores them too
        with pytest.raises(RuntimeError):
            gradcam(model, torch.zeros((1, 5, SIZE, SIZE), dtype=torch.float64),
                    1, "feat_down0")
        assert [p.requires_grad for p in model.parameters()] == flags
        assert not any(m._forward_hooks for m in model.modules())
    finally:
        model.unet.model[0].conv.unit0.conv.weight.requires_grad_(True)


def test_frozen_parameters_take_no_weight_gradient(pair2d, monkeypatch):
    """Every stride-1 unit after the layer asks its conv backward for dx
    alone."""
    masks = []
    real = conv_block.conv3x3_backward

    def spy(dy, x, w, output_mask=(True, True, True)):
        masks.append(tuple(output_mask))
        return real(dy, x, w, output_mask)

    monkeypatch.setattr(conv_block, "conv3x3_backward", spy)
    gradcam(pair2d[0], _port(_x((1, SIZE, SIZE, 3), 5)), 3, "feat_down0")
    # after feat_down0: level 1's unit, 2 at the bottom, the up's unit
    assert masks == [(True, False, False)] * 4


@pytest.mark.parametrize("needs", [(True, False, False), (False, True, True),
                                   (True, True, True)])
def test_conv_backward_computes_what_is_asked(needs):
    gen = torch.Generator().manual_seed(6)
    x = torch.randn((2, 6, 5, 4), generator=gen, dtype=torch.float64)
    w = torch.randn((3, 3, 4, 8), generator=gen, dtype=torch.float64)
    dy = torch.randn((2, 6, 5, 8), generator=gen, dtype=torch.float64)
    full = conv_block.conv3x3_backward(dy, x, w)
    part = conv_block.conv3x3_backward(dy, x, w, needs)
    for want, got, asked in zip(full, part, needs):
        if asked:
            assert torch.equal(got, want)
        else:
            assert got is None
    # through the autograd.Function: the gradients of what requires one
    xs = x.clone().requires_grad_(needs[0])
    ws = w.clone().requires_grad_(needs[1])
    b = torch.zeros(8, dtype=torch.float64, requires_grad=needs[2])
    alpha = torch.tensor([0.25], dtype=torch.float64)
    out = conv_block.conv3x3_in_prelu(xs, ws, b, alpha)
    inputs = [t for t, n in zip((xs, ws, b), needs) if n]
    grads = torch.autograd.grad(out, inputs, grad_outputs=dy)
    assert len(grads) == sum(needs)


def test_training_gradients_are_unchanged():
    """A train step's parameter gradients: every conv backward still takes
    dw and db, equal to the full mask's."""
    cfg = TrainConfig(filters=FILTERS, num_res_units=2, compute_dtype="float64",
                      in_channels=3)
    model = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(8))
    x = _port(_x((2, SIZE, SIZE, 3), 9))
    model(x).square().mean().backward()
    got = {k: p.grad.clone() for k, p in model.named_parameters()}
    model.zero_grad()
    real = conv_block.conv3x3_backward
    try:
        conv_block.conv3x3_backward = lambda dy, x, w, mask=None: real(dy, x, w)
        model(x).square().mean().backward()
    finally:
        conv_block.conv3x3_backward = real
    for k, p in model.named_parameters():
        assert torch.equal(p.grad, got[k]), k


def test_run_interpretability_writes_the_jax_runs_files(tmp_path):
    """run_interpretability's .npy files against the JAX run's on the same split
    and weights (a float64 model; 5 qualifying samples in batches of 2, the
    last one short). Both runs transform the raw slices in float32, and
    XLA rounds the jitted transform up to an ulp off the eager one, so the
    maps agree to 1e-5 of their max; on the port's own images its
    maps are `gradcam_all_structures`'s, held to JAX at 1e-8 above."""
    rng = np.random.default_rng(10)
    n, hw = 7, 24
    images = rng.normal(40, 300, (n, hw, hw)).astype(np.float32)
    labels = rng.integers(0, 10, (n, hw, hw)).astype(np.uint8)
    indicators = np.zeros((n, 9), bool)
    indicators[:, :6] = True
    indicators[[1, 4], 3:] = False  # 2 samples with 3 structures: skipped
    dataset = PackedDataset2D(images, labels, indicators,
                              names=[f"s{i}" for i in range(n)])
    cfg = TrainConfig(filters=FILTERS, num_res_units=2, transform_degree=2,
                      input_size=SIZE, compute_dtype="float64")
    model = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(11))
    done = run_interpretability(cfg, model, dataset, tmp_path / "port",
                                max_samples=20, batch_size=2)
    jcfg = JaxTrainConfig.from_dict(cfg.as_dict())
    params = import_monai_state_dict(
        model.state_dict(), 3, FILTERS, strides=(2, 2), num_res_units=2,
        dtype=jnp.float64)
    jax_done = jax_run(JaxTrainer(jcfg), params, dataset, tmp_path / "jax",
                       max_samples=20, batch_size=2)
    assert done == jax_done == 5
    for i in (0, 2, 3, 5, 6):
        for kind in ("pred", "gradcam"):
            ours = np.load(tmp_path / "port" / f"s{i}_{kind}.npy")
            theirs = np.load(tmp_path / "jax" / f"s{i}_{kind}.npy")
            # int32 labels, as the JAX run writes them outside x64 mode
            assert ours.dtype == (np.int32 if kind == "pred" else theirs.dtype)
            assert ours.shape == theirs.shape
            if kind == "pred":
                np.testing.assert_array_equal(ours, theirs)
            else:
                assert ours.shape == (9, SIZE, SIZE)
                _assert_maps_close(ours, theirs, 1, rtol=1e-5)
    imgs, _ = get_transform(2, False, (SIZE, SIZE))(
        torch.from_numpy(images[[5, 6]]))
    x = channels_last(imgs.to(torch.float64).permute(0, 3, 1, 2))
    direct = gradcam_all_structures(model, x, "feat_down1").numpy()
    for j, i in enumerate((5, 6)):
        np.testing.assert_array_equal(
            np.load(tmp_path / "port" / f"s{i}_gradcam.npy"), direct[j])
    assert not (tmp_path / "port" / "s1_pred.npy").exists()
    assert sorted(p.name for p in (tmp_path / "port").glob("*.npy")) == sorted(
        p.name for p in (tmp_path / "jax").glob("*.npy"))
    # the PNG panels, where matplotlib imports
    has_png = importlib.util.find_spec("matplotlib") is not None
    assert (tmp_path / "port" / "s0_gradcam.png").exists() == has_png
