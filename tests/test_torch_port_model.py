"""The port's SegmentationModel against the JAX one, on the same weights.

Weights go JAX -> port through models/jax_import.py::state_dict_from_jax_params
and port -> JAX through the JAX package's import_monai_state_dict, so both
converters and the MONAI key layout are checked with the forward pass.
Logits agree to 1e-9 in float64 (the IN+PReLU and conv3x3+IN+PReLU sites run
their kernels' plain versions on the CPU); a float32 case holds the port to
the JAX model with its Pallas conv kernel on (interpret mode) at 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctseg_tpu.models import SegmentationModel as JaxSegmentationModel
from ctseg_tpu.models.torch_import import import_monai_state_dict
from ctseg_tpu.models.torch_import import monai_key_map as jax_monai_key_map
from ctseg_tpu_torch.models import layers
from ctseg_tpu_torch.models.jax_import import (
    monai_key_map,
    state_dict_from_jax_params,
)
from ctseg_tpu_torch.models.unet import SegmentationModel
from ctseg_tpu_torch.training.config import (
    TrainConfig,
    build_model,
    load_checkpoint,
    save_checkpoint,
)

FILTERS = (4, 8, 16, 32, 64)


def _jax_model(num_res_units, downsample, dtype=jnp.float64, **kw):
    return JaxSegmentationModel(
        out_channels=10, channels=FILTERS, strides=(2,) * 4,
        num_res_units=num_res_units, downsample=downsample, dtype=dtype,
        param_dtype=dtype, **kw,
    )


def _port_forward(model, x_nhwc: np.ndarray) -> np.ndarray:
    x = torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)
    with torch.inference_mode():
        y = model(x.contiguous(memory_format=torch.channels_last))
    return y.permute(0, 2, 3, 1).numpy()


def _x(seed, dtype=np.float64):
    return np.random.default_rng(seed).normal(size=(2, 32, 32, 3)).astype(dtype)


@pytest.mark.parametrize("downsample", [False, True])
@pytest.mark.parametrize("num_res_units", [0, 1, 2])
def test_jax_weights_give_jax_logits(num_res_units, downsample):
    jm = _jax_model(num_res_units, downsample)
    params = jm.init(jax.random.key(num_res_units), jnp.zeros((1, 32, 32, 3)))
    x = _x(0)
    ref = np.asarray(jax.jit(jm.apply)(params, x))

    sd = state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), 3, FILTERS,
        num_res_units=num_res_units, downsample=downsample,
    )
    model = SegmentationModel(3, 10, FILTERS, num_res_units=num_res_units,
                              downsample=downsample, dtype=torch.float64)
    model.load_state_dict(sd)  # strict: every key present, none left over
    np.testing.assert_allclose(_port_forward(model, x), ref, rtol=0, atol=1e-9)


@pytest.mark.parametrize("num_res_units", [0, 1, 2])
def test_port_weights_give_jax_logits(num_res_units):
    downsample = num_res_units == 1
    model = SegmentationModel(
        3, 10, FILTERS, num_res_units=num_res_units, downsample=downsample,
        dtype=torch.float64, generator=torch.Generator().manual_seed(7),
    )
    entries = monai_key_map(3, FILTERS, (2,) * 4, num_res_units, downsample)
    assert entries == jax_monai_key_map(3, FILTERS, (2,) * 4, num_res_units,
                                        downsample)
    prefixes = {k.rsplit(".", 1)[0] for k in model.state_dict()}
    assert prefixes == {prefix for _, prefix, _ in entries}

    params = import_monai_state_dict(
        model.state_dict(), 3, FILTERS, num_res_units=num_res_units,
        downsample=downsample, dtype=jnp.float64,
    )
    x = _x(1)
    ref = np.asarray(jax.jit(_jax_model(num_res_units, downsample).apply)(params, x))
    np.testing.assert_allclose(_port_forward(model, x), ref, rtol=0, atol=1e-9)


def test_float32_matches_jax_with_pallas_conv_kernel():
    """JAX with fused_conv_block (Pallas K2 in interpret mode) vs the port."""
    jm = _jax_model(2, False, dtype=jnp.float32, fused_conv_block=True)
    params = jm.init(jax.random.key(3), jnp.zeros((1, 32, 32, 3), jnp.float32))
    x = _x(2, np.float32)[:1]
    ref = np.asarray(jax.jit(jm.apply)(params, x))
    sd = state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), 3, FILTERS, num_res_units=2
    )
    model = SegmentationModel(3, 10, FILTERS, num_res_units=2)
    model.load_state_dict(sd)
    np.testing.assert_allclose(_port_forward(model, x), ref, rtol=1e-4, atol=1e-4)


def test_model_l_topology_calls_each_kernel_at_its_sites(monkeypatch):
    """Per forward, Model L's layout runs 8 IN+PReLU sites (4 strided encoder
    convs, 4 transposed convs) and 9 stride-1 conv3x3 units; the other convs
    stay torch convs. Counted at the dispatch functions, on the CPU."""
    calls = {"k1": 0, "k2": 0}

    def count(key, fn):
        def wrapped(*a):
            calls[key] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(layers, "instance_norm_prelu",
                        count("k1", layers.instance_norm_prelu))
    monkeypatch.setattr(layers, "conv3x3_in_prelu",
                        count("k2", layers.conv3x3_in_prelu))
    model = SegmentationModel(3, 10, FILTERS, num_res_units=2)
    out = _port_forward(model, _x(3, np.float32))
    assert out.shape == (2, 32, 32, 10)
    assert calls == {"k1": 8, "k2": 9}


def test_checkpoint_round_trip(tmp_path):
    cfg = TrainConfig(filters=FILTERS, num_res_units=2, transform_degree=2,
                      input_size=32)
    model = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(0))
    save_checkpoint(tmp_path / "m.ckpt", cfg, model)
    cfg2, model2 = load_checkpoint(tmp_path / "m.ckpt", "cpu")
    assert cfg2 == cfg and not model2.training
    x = _x(4, np.float32)
    np.testing.assert_array_equal(_port_forward(model, x), _port_forward(model2, x))


def test_reference_style_checkpoint_loads(tmp_path):
    """A Lightning .ckpt of the reference: hparams without num_res_units
    (recovered from the keys), conv1x1 present though unused, loss buffers,
    newer MONAI `.adn.A.` spellings."""
    src = SegmentationModel(3, 10, FILTERS, num_res_units=2,
                            generator=torch.Generator().manual_seed(1))
    sd = {k.replace(".act.", ".adn.A."): v for k, v in src.state_dict().items()}
    sd["conv1x1.weight"] = torch.zeros(1, 3, 1, 1)
    sd["conv1x1.bias"] = torch.zeros(1)
    sd["loss_func.weight"] = torch.ones(10)
    hp = {"filters": list(FILTERS), "downsample": False, "lr": 1e-3,
          "use_res_units": True, "loss_fx": ["Focal", "Dice"]}
    torch.save({"hyper_parameters": hp, "state_dict": sd}, tmp_path / "ref.ckpt")

    cfg, model = load_checkpoint(tmp_path / "ref.ckpt", "cpu")
    assert cfg.num_res_units == 2 and cfg.transform_degree == 1
    assert cfg.filters == FILTERS
    x = _x(5, np.float32)
    np.testing.assert_array_equal(_port_forward(model, x), _port_forward(src, x))


def test_3d_checkpoint_names_the_roadmap_item(tmp_path):
    cfg = TrainConfig(filters=FILTERS, spatial_dims=3)
    torch.save({"hyper_parameters": cfg.as_dict(), "state_dict": {}},
               tmp_path / "m3d.ckpt")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        load_checkpoint(tmp_path / "m3d.ckpt", "cpu")


def test_train_config_fields_match_the_jax_package():
    from ctseg_tpu.training.trainer import TrainConfig as JaxTrainConfig

    ours = {f.name: f.default for f in dataclasses.fields(TrainConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxTrainConfig)}
    assert ours == theirs
    d = JaxTrainConfig(filters=FILTERS, num_res_units=2).as_dict()
    assert TrainConfig.from_dict(d).as_dict() == d
