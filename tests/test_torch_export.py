"""The port's export (ctseg_tpu_torch/inference/export.py) and the custom ops
it traces (ops/custom_ops.py), on the CPU.

  - `torch.library.opcheck` on `ctseg::instance_norm_prelu` (2D and rank 5)
    and `ctseg::conv3x3_in_prelu`, float32 and bfloat16.
  - The portable artifact (aten ops only) gives `predict_labels_2d`'s labels
    at degrees 0 and 2, and the JAX package's `export_slice_model` artifact's
    labels on the same weights except at near-ties of the port's logits;
    any batch; loads and runs in a process that cannot import the port.
  - The inference calls take the ops on every device (the CPU implementation
    being the plain version), so the kernel artifact traced on the CPU has
    one `ctseg::` node per K1 site and per stride-1 2D unit and computes
    what the portable graph (the ops decomposed into their plain versions)
    computes.
  - The 3D patch export against the model and the JAX `export_patch_model`;
    `infer_dtype`; the CLI and its sidecar.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctseg_tpu.inference.export import export_patch_model as jax_export_patch
from ctseg_tpu.inference.export import export_slice_model as jax_export_slice
from ctseg_tpu.models.torch_import import import_monai_state_dict
from ctseg_tpu.training.trainer import TrainConfig as JaxTrainConfig
from ctseg_tpu.training.trainer import Trainer as JaxTrainer
from ctseg_tpu_torch.inference import export
from ctseg_tpu_torch.inference.predict import predict_labels_2d
from ctseg_tpu_torch.models.layers import ConvTransposeUnit, ConvUnit
from ctseg_tpu_torch.ops import custom_ops
from ctseg_tpu_torch.ops.conv_block import conv3x3_in_prelu
from ctseg_tpu_torch.ops.instance_norm import instance_norm_prelu
from ctseg_tpu_torch.training.config import (
    TrainConfig,
    build_model,
    save_checkpoint,
)
from ctseg_tpu_torch.transforms.pipelines import get_transform
from ctseg_tpu_torch.transforms.windowing import apply_window

FILTERS = (4, 8, 16)
SLICE = (40, 40)
REPO = Path(__file__).resolve().parent.parent
CTSEG_OPS = ["ctseg::conv3x3_in_prelu", "ctseg::instance_norm_prelu"]


def _config(degree=2, **kw):
    return TrainConfig(filters=FILTERS, num_res_units=2, input_size=32,
                       transform_degree=degree, **kw)


def _model(cfg, seed=0):
    return build_model(cfg, "cpu",
                       generator=torch.Generator().manual_seed(seed)).eval()


def _volume(seed, n=5, shape=SLICE):
    return np.random.default_rng(seed).normal(40, 300, (n, *shape)).astype(
        np.float32)


def _sites(model):
    """(K1 sites, stride-1 2D units) of a model: the sites the kernel form
    sends to each custom op."""
    k1 = k2 = 0
    for m in model.modules():
        if isinstance(m, ConvUnit) and m.act is not None:
            k2 += m.fused
            k1 += not m.fused
        elif isinstance(m, ConvTransposeUnit) and m.act is not None:
            k1 += 1
    return k1, k2


def _ctseg_nodes(ep):
    counts = {}
    for n in ep.graph.nodes:
        if n.op == "call_function" and "ctseg" in str(n.target):
            name = n.target.name()
            counts[name] = counts.get(name, 0) + 1
    return counts


@pytest.fixture(scope="module")
def model2d():
    cfg = _config()
    return cfg, _model(cfg)


@pytest.fixture(scope="module")
def portable(model2d, tmp_path_factory):
    cfg, model = model2d
    ep = export.export_slice_model(model, cfg, SLICE)
    path = tmp_path_factory.mktemp("export") / "portable.pt2"
    export.save_exported(ep, path, config=cfg.as_dict())
    return ep, path


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 6, 5, 8), (2, 4, 3, 5, 8)],
                         ids=["2d", "rank5"])
def test_opcheck_instance_norm_prelu(shape, dtype):
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(shape, generator=gen).to(dtype)
    alpha = torch.tensor([0.25])
    torch.library.opcheck(torch.ops.ctseg.instance_norm_prelu.default,
                          (x, alpha))
    y = torch.ops.ctseg.instance_norm_prelu(x, alpha)
    assert torch.equal(y, instance_norm_prelu(x, alpha))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_opcheck_conv3x3_in_prelu(dtype):
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((2, 6, 5, 8), generator=gen).to(dtype)
    w = (torch.randn((3, 3, 8, 16), generator=gen) * 0.1).to(dtype)
    b = torch.randn((16,), generator=gen)
    alpha = torch.tensor([0.25])
    torch.library.opcheck(torch.ops.ctseg.conv3x3_in_prelu.default,
                          (x, w, b, alpha))
    y = torch.ops.ctseg.conv3x3_in_prelu(x, w, b, alpha)
    assert y.is_contiguous() and y.shape == (2, 6, 5, 16)
    assert torch.equal(y, conv3x3_in_prelu(x, w, b, alpha).contiguous())


class _Ops(torch.utils._python_dispatch.TorchDispatchMode):
    """Records the ops dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


def test_inference_calls_take_the_ops_on_every_device():
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((1, 4, 4, 8), generator=gen)
    w = torch.randn((3, 3, 8, 8), generator=gen) * 0.1
    b, alpha = torch.zeros(8), torch.tensor([0.25])
    with torch.inference_mode(), _Ops() as ops:
        instance_norm_prelu(x, alpha)
        conv3x3_in_prelu(x, w, b, alpha)
    assert [op for op in ops.seen if op.startswith("ctseg")] == [
        "ctseg.instance_norm_prelu.default", "ctseg.conv3x3_in_prelu.default"]
    # the training form stays the autograd.Function
    y = instance_norm_prelu(x.requires_grad_(), alpha)
    assert y.grad_fn is not None and "InstanceNormPReLU" in type(y.grad_fn).__name__


def test_portable_program_is_decomposed_and_on_the_cpu(model2d, portable):
    ep, _ = portable
    assert set(custom_ops.plain_decompositions()) == {
        torch.ops.ctseg.instance_norm_prelu.default,
        torch.ops.ctseg.conv3x3_in_prelu.default}
    tensors = [*ep.state_dict.values(), *ep.constants.values()]
    assert tensors and all(t.device.type == "cpu" for t in tensors
                           if isinstance(t, torch.Tensor))


@pytest.mark.parametrize("degree", [0, 2])
def test_portable_labels_equal_predict_labels_2d(degree, tmp_path):
    cfg = _config(degree)
    model = _model(cfg, seed=degree)
    ep = export.export_slice_model(model, cfg, SLICE)
    fn = export.load_exported(export.save_exported(ep, tmp_path / "m.pt2"))
    vol = _volume(degree)
    with torch.inference_mode():
        got = fn(torch.from_numpy(vol)).numpy()
    want = predict_labels_2d(
        model, get_transform(degree, False, (32, 32)), vol, "cpu")
    assert got.dtype == np.uint8 and got.shape == (5, *SLICE)
    np.testing.assert_array_equal(got, want)


def test_portable_graph_has_only_aten_ops(portable):
    ep, _ = portable
    targets = {str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"}
    assert not [t for t in targets if "ctseg" in t]
    assert all(t.startswith("aten.") or "getitem" in t for t in targets), targets
    assert export.custom_op_names(ep) == []
    ranges = list(ep.range_constraints.values())
    assert len(ranges) == 1 and ranges[0].lower == 1  # the symbolic batch


def test_kernel_form_graph_has_a_node_per_site(model2d, portable):
    cfg, model = model2d
    ep = export.export_slice_model(model, cfg, SLICE, platforms=("cuda",))
    k1, k2 = _sites(model)
    # 2 strided downs and 2 transposed convs; a stride-1 unit in each down,
    # 2 at the bottom, 1 in the lower up
    assert (k1, k2) == (4, 5)
    assert _ctseg_nodes(ep) == {"ctseg::instance_norm_prelu": k1,
                                "ctseg::conv3x3_in_prelu": k2}
    vol = torch.from_numpy(_volume(3, n=3))
    with torch.inference_mode():
        assert torch.equal(ep.module()(vol), portable[0].module()(vol))


@pytest.mark.parametrize("batch", [1, 3, 7])
def test_symbolic_batch(portable, batch):
    # moved to a device at load (here the one it was traced on)
    fn = export.load_exported(portable[1], device="cpu")
    vol = _volume(batch, n=batch)
    with torch.inference_mode():
        out = fn(torch.from_numpy(vol))
    assert out.shape == (batch, *SLICE) and out.dtype == torch.uint8


def test_portable_artifact_loads_with_torch_alone(portable):
    _, path = portable
    code = f"""
import sys
sys.modules["ctseg_tpu_torch"] = None  # any import of the port raises
sys.modules["ctseg_tpu"] = None
import torch
ep = torch.export.load({str(path)!r})
with torch.inference_mode():
    out = ep.module()(torch.zeros((2, {SLICE[0]}, {SLICE[1]})))
assert out.shape == (2, {SLICE[0]}, {SLICE[1]}) and out.dtype == torch.uint8
assert not any(m.startswith("ctseg") for m in sys.modules if sys.modules[m])
print("portable-ok")
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd="/")
    assert r.returncode == 0, r.stderr
    assert "portable-ok" in r.stdout


def test_kernel_artifact_needs_the_registration(model2d, tmp_path):
    cfg, model = model2d
    ep = export.export_slice_model(model, cfg, SLICE, platforms=("cuda",))
    path = export.save_exported(ep, tmp_path / "k.pt2")
    meta = json.loads(Path(str(path) + ".json").read_text())
    assert meta["platforms"] == ["cuda"]
    assert meta["custom_ops"] == CTSEG_OPS
    assert "custom_ops" in meta["loader"]
    # the loader imports the registration; the artifact runs its CPU form
    vol = torch.from_numpy(_volume(4, n=2))
    with torch.inference_mode():
        assert torch.equal(export.load_exported(path)(vol), ep.module()(vol))


def test_portable_matches_the_jax_artifact(model2d):
    """Same weights (the port's, imported into the JAX model), each
    package's own export: labels equal except where the port's top two
    logits lie within 1e-4 (float32 on both sides; counted)."""
    cfg, model = model2d
    jcfg = JaxTrainConfig.from_dict(cfg.as_dict())
    trainer = JaxTrainer(jcfg)
    params = import_monai_state_dict(
        model.state_dict(), 3, FILTERS, strides=(2, 2), num_res_units=2)
    jax_fn = jax_export_slice(trainer, params, slice_shape=SLICE,
                              platforms=("cpu",))
    vol = _volume(5, n=6)
    theirs = np.asarray(jax.jit(jax_fn.call)(jnp.asarray(vol)))
    ep = export.export_slice_model(model, cfg, SLICE)
    with torch.inference_mode():
        ours = ep.module()(torch.from_numpy(vol)).numpy()
        imgs, _ = get_transform(2, False, (32, 32))(torch.from_numpy(vol))
        logits = model(imgs.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last))
    top2 = torch.topk(logits, 2, dim=1).values
    gap = torch.nn.functional.interpolate(
        (top2[:, 0] - top2[:, 1])[:, None], size=SLICE,
        mode="nearest-exact")[:, 0].numpy()
    near_ties = int((gap < 1e-4).sum())
    differ = ours != theirs
    assert np.all(gap[differ] < 1e-4), (int(differ.sum()), near_ties)
    assert differ.sum() <= near_ties


def _model3d(seed=0):
    cfg = TrainConfig(filters=FILTERS, num_res_units=1, spatial_dims=3,
                      input_shape=(16, 16, 8), volumetric_mode="patch",
                      in_channels=1, transform_degree=0)
    return cfg, _model(cfg, seed)


def test_patch_export_matches_the_model_and_jax(tmp_path):
    from ctseg_tpu.transforms.windowing import apply_window as jax_window

    cfg, model = _model3d()
    ep = export.export_patch_model(model, cfg, (16, 16, 8))
    fn = export.load_exported(export.save_exported(ep, tmp_path / "p.pt2"))
    patches = np.random.default_rng(6).normal(40, 300, (3, 16, 16, 8)).astype(
        np.float32)
    with torch.inference_mode():
        got = fn(torch.from_numpy(patches)).numpy()
        vol = apply_window(torch.from_numpy(patches)[..., None], 350, 20)
        want = model(vol.movedim(-1, 1).contiguous(
            memory_format=torch.channels_last_3d)).movedim(1, -1).numpy()
    assert got.shape == (3, 16, 16, 8, 10)
    np.testing.assert_array_equal(got, want)

    jcfg = JaxTrainConfig.from_dict(cfg.as_dict())
    params = import_monai_state_dict(
        model.state_dict(), 1, FILTERS, strides=(2, 2), num_res_units=1)
    theirs = jax_export_patch(JaxTrainer(jcfg), params, patch_size=(16, 16, 8),
                              platforms=("cpu",))
    theirs = np.asarray(jax.jit(theirs.call)(jnp.asarray(patches)))
    np.testing.assert_allclose(got, theirs, rtol=1e-4, atol=1e-4)
    # the window is the JAX one
    np.testing.assert_allclose(
        vol.numpy(), np.asarray(jax_window(jnp.asarray(patches)[..., None],
                                           350, 20, shift=True)),
        rtol=0, atol=1e-7)
    # 3D units are a library conv and K1: every site a K1 node
    kern = export.export_patch_model(model, cfg, (16, 16, 8),
                                     platforms=("cuda",))
    assert _ctseg_nodes(kern) == {"ctseg::instance_norm_prelu": _sites(model)[0]}
    with torch.inference_mode():
        assert torch.equal(kern.module()(torch.from_numpy(patches)),
                           torch.from_numpy(got))


def test_infer_dtype_bakes_in_bfloat16(model2d):
    cfg, model = model2d
    ep = export.export_slice_model(model, cfg, SLICE, infer_dtype="bfloat16")
    def conv_dtypes(program):
        return {n.meta["val"].dtype for n in program.graph.nodes
                if str(n.target) == "aten.conv2d.default"}

    # the library convs compute in bfloat16; K2's plain version convolves
    # the bfloat16 values in float32, as the kernel accumulates
    assert conv_dtypes(ep) == {torch.bfloat16, torch.float32}
    f32 = export.export_slice_model(model, cfg, SLICE)
    assert conv_dtypes(f32) == {torch.float32}
    # the parameters stay float32, the caller's model untouched
    assert all(p.dtype == torch.float32 for p in ep.state_dict.values())
    assert model.compute_dtype == torch.float32
    bf16 = _model(cfg)
    bf16.compute_dtype = torch.bfloat16
    vol = _volume(7, n=3)
    with torch.inference_mode():
        got = ep.module()(torch.from_numpy(vol)).numpy()
    want = predict_labels_2d(bf16, get_transform(2, False, (32, 32)), vol,
                             "cpu", dtype=torch.bfloat16)
    np.testing.assert_array_equal(got, want)
    kern = export.export_slice_model(model, cfg, SLICE, platforms=("cuda",),
                                     infer_dtype="bfloat16")
    k1 = [n for n in kern.graph.nodes if "instance_norm_prelu" in str(n.target)]
    assert all(n.meta["val"].dtype == torch.bfloat16 for n in k1)


def test_platforms_are_checked(model2d):
    cfg, model = model2d
    assert not export.kernel_artifact(("cpu", "cuda"))
    assert not export.kernel_artifact(("cpu",))
    assert export.kernel_artifact(("cuda",))
    with pytest.raises(ValueError, match="platforms"):
        export.export_slice_model(model, cfg, SLICE, platforms=("tpu",))
    three_d = _model3d()
    with pytest.raises(ValueError, match="2D checkpoint"):
        export.export_slice_model(three_d[1], three_d[0], SLICE)
    with pytest.raises(ValueError, match="3D checkpoint"):
        export.export_patch_model(model, cfg, (16, 16, 8))


def test_export_cli_and_sidecar(model2d, tmp_path):
    cfg, model = model2d
    save_checkpoint(tmp_path / "model.ckpt", cfg, model)
    out = tmp_path / "cli.pt2"
    export.main(["--checkpoint", str(tmp_path / "model.ckpt"), "--out",
                 str(out), "--slice_shape", *map(str, SLICE), "--device",
                 "cpu", "--infer_dtype", "float32"])
    meta = json.loads(Path(str(out) + ".json").read_text())
    assert meta["platforms"] == ["cpu", "cuda"]
    assert meta["custom_ops"] == [] and meta["loader"] == "torch alone"
    assert meta["in_specs"] == [f"float32[b, {SLICE[0]}, {SLICE[1]}]"]
    assert meta["out_specs"] == [f"uint8[b, {SLICE[0]}, {SLICE[1]}]"]
    assert meta["config"]["filters"] == list(FILTERS)
    assert meta["config"]["_exported_infer_dtype"] == "float32"
    assert meta["torch_version"] == torch.__version__
    with torch.inference_mode():
        out_labels = export.load_exported(out)(torch.zeros((2, *SLICE)))
    assert out_labels.shape == (2, *SLICE)

    kern = tmp_path / "kernel.pt2"
    export.main(["--checkpoint", str(tmp_path / "model.ckpt"), "--out",
                 str(kern), "--slice_shape", *map(str, SLICE), "--device",
                 "cpu", "--platforms", "cuda"])
    meta = json.loads(Path(str(kern) + ".json").read_text())
    assert meta["platforms"] == ["cuda"]
    assert meta["custom_ops"] == CTSEG_OPS
    assert meta["config"]["_exported_infer_dtype"] is None


def test_the_eager_transform_still_runs_after_a_trace(model2d):
    """The windows' constants are cached per device; a trace must not leave
    its fake tensors in the cache."""
    cfg, model = model2d
    export.export_slice_model(model, cfg, SLICE)
    imgs, _ = get_transform(2, False, (32, 32))(torch.zeros((1, *SLICE)))
    assert isinstance(imgs.sum().item(), float)
