"""Inference export: checkpoint -> one self-contained `torch.export` artifact
(port of ctseg_tpu/inference/export.py, `torch.export` in place of
`jax.export`).

A trained checkpoint exports to one `.pt2` file (`torch.export.save`) that
  - bakes the weights in (graph + weights + preprocessing in one file);
  - holds the whole numeric contract: the checkpoint's own test transform
    (windows + resize + normalize) for a 2D slice model, the soft-tissue
    window for a 3D patch scorer;
  - has a symbolic batch dimension, `torch.export.Dim("b")` (traced from a
    batch of 2: a batch of 1 would fix it at 1);
  - comes with a sidecar `<path>.json`: torch version, platforms, the
    `ctseg::` custom ops the graph holds, input and output specs, config.

Exported contracts (the JAX ones):
  2D slice model:  f(slices: f32[b, H, W] raw HU) -> u8[b, H, W] labels
  3D patch model:  f(patches: f32[b, ph, pw, pd] raw HU)
                   -> f32[b, ph, pw, pd, 10] logits (the caller blends the
                   windows, as inference/sliding_window.py does)

Platforms follow the JAX rule, which keeps its Pallas kernels only for a
TPU-only target. The default is ("cpu", "cuda"). Every artifact is traced
on the model's device through the custom ops `ctseg::instance_norm_prelu`
and `ctseg::conv3x3_in_prelu` (ops/custom_ops.py). `--platforms cuda` alone
keeps them: the KERNEL artifact launches K1 and K2 on the card, and loading
it needs the op registration, which `load_exported` imports. Any other
target list gives a PORTABLE artifact: the ops decomposed into their plain
PyTorch versions (`custom_ops.plain_decompositions`), so the graph holds
aten ops only, and the program moved to the CPU, so that it loads and runs
with `torch` alone on either device (`load_exported(path, device)` moves
it).

Usage:
  python -m ctseg_tpu_torch.inference.export --checkpoint model.ckpt \\
      --out model_large.pt2 --slice_shape 280 280 [--platforms cuda]
  # then, anywhere with torch (a portable artifact; no ctseg_tpu_torch):
  #   ep = torch.export.load("model_large.pt2")
  #   labels = ep.module()(slices)
"""

import copy
import json
from argparse import ArgumentParser
from pathlib import Path
from typing import Optional, Sequence, Tuple

import torch
from torch.export.passes import move_to_device_pass

from ctseg_tpu_torch.constants import WINDOWING_CONFIG
from ctseg_tpu_torch.inference.predict import slice_labels
from ctseg_tpu_torch.inference.sliding_window import model_apply_fn
from ctseg_tpu_torch.ops import custom_ops
from ctseg_tpu_torch.training.config import TrainConfig, load_checkpoint
from ctseg_tpu_torch.transforms.pipelines import get_transform
from ctseg_tpu_torch.transforms.windowing import apply_window

DEFAULT_PLATFORMS = ("cpu", "cuda")  # every target the port has
TRACE_BATCH = 2  # a batch of 1 would be specialised


def kernel_artifact(platforms: Sequence[str]) -> bool:
    """True for `cuda` alone: the artifact calls the hand kernels. Any
    other target list gives a portable artifact (aten ops only)."""
    platforms = tuple(platforms)
    if not platforms or set(platforms) - set(DEFAULT_PLATFORMS):
        raise ValueError(
            f"platforms {platforms}: choose from {DEFAULT_PLATFORMS}")
    return platforms == ("cuda",)


def _model_for_export(model: torch.nn.Module,
                      infer_dtype: Optional[str]) -> torch.nn.Module:
    """A frozen copy of `model` to trace: eval mode, no parameter needing a
    gradient (so every K1 and K2 site takes its inference form), computing
    in `infer_dtype` (None or "checkpoint" keeps the model's; parameters
    stay float32, as the JAX export's param_dtype)."""
    frozen = copy.deepcopy(model).eval().requires_grad_(False)
    if infer_dtype not in (None, "checkpoint"):
        frozen.compute_dtype = getattr(torch, infer_dtype)
    return frozen


class _SliceModel(torch.nn.Module):
    def __init__(self, model, transform, dtype):
        super().__init__()
        self.model = model
        self.transform = transform
        self.dtype = dtype

    def forward(self, slices: torch.Tensor) -> torch.Tensor:
        return slice_labels(self.model, self.transform, slices, self.dtype)


class _PatchModel(torch.nn.Module):
    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        vol = apply_window(patches.to(torch.float32)[..., None],
                           *WINDOWING_CONFIG["soft_tissue"])
        return model_apply_fn(self.model)(vol)


def _export(module: torch.nn.Module, spatial: Tuple[int, ...],
            platforms: Sequence[str]) -> torch.export.ExportedProgram:
    device = next(module.parameters()).device
    example = torch.zeros((TRACE_BATCH, *spatial), dtype=torch.float32,
                          device=device)
    kernels = kernel_artifact(platforms)  # the targets checked first
    ep = torch.export.export(
        module, (example,), dynamic_shapes=({0: torch.export.Dim("b", min=1)},))
    if kernels:
        return ep
    return move_to_device_pass(
        ep.run_decompositions(custom_ops.plain_decompositions()), "cpu")


def export_slice_model(
    model: torch.nn.Module,
    config: TrainConfig,
    slice_shape: Tuple[int, int] = (280, 280),
    platforms: Sequence[str] = DEFAULT_PLATFORMS,
    infer_dtype: Optional[str] = None,
) -> torch.export.ExportedProgram:
    """Export a 2D checkpoint's model as f(f32[b, H, W] raw HU) -> u8[b,
    H, W]: the checkpoint's own test transform, the model, argmax and a
    nearest resize back to (H, W), as predict.predict_labels_2d computes
    each batch (`slice_labels`)."""
    if config.spatial_dims != 2:
        raise ValueError("export_slice_model needs a 2D checkpoint")
    frozen = _model_for_export(model, infer_dtype)
    transform = get_transform(config.transform_degree, train=False,
                              size=(config.input_size,) * 2)
    module = _SliceModel(frozen, transform, frozen.compute_dtype)
    return _export(module, tuple(slice_shape), platforms)


def export_patch_model(
    model: torch.nn.Module,
    config: TrainConfig,
    patch_size: Tuple[int, int, int] = (128, 128, 48),
    platforms: Sequence[str] = DEFAULT_PLATFORMS,
    infer_dtype: Optional[str] = None,
) -> torch.export.ExportedProgram:
    """Export a 3D checkpoint's model as f(f32[b, ph, pw, pd] raw HU) ->
    logits (b, ph, pw, pd, 10), the soft-tissue window (350/20, shifted)
    baked in; the window grid and blending stay with the caller."""
    if config.spatial_dims != 3:
        raise ValueError("export_patch_model needs a 3D checkpoint")
    module = _PatchModel(_model_for_export(model, infer_dtype))
    return _export(module, tuple(patch_size), platforms)


def custom_op_names(ep: torch.export.ExportedProgram) -> list:
    """The `ctseg::` ops an exported graph calls, sorted."""
    return sorted({
        n.target.name() for n in ep.graph.nodes
        if n.op == "call_function"
        and isinstance(n.target, torch._ops.OpOverload)
        and n.target.namespace == custom_ops.NAMESPACE
    })


def _spec(value) -> str:
    """dtype[dims] of a traced tensor, a symbolic dimension written b."""
    dims = ", ".join(str(d) if isinstance(d, int) else "b" for d in value.shape)
    return f"{str(value.dtype).removeprefix('torch.')}[{dims}]"


def save_exported(ep: torch.export.ExportedProgram, path,
                  config=None) -> Path:
    """Write the artifact to `path` and a readable sidecar `<path>.json`,
    whose platforms are those the graph runs on: cuda for a graph that
    holds `ctseg::` ops, else DEFAULT_PLATFORMS."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.export.save(ep, str(path))
    ops = custom_op_names(ep)
    platforms = ("cuda",) if ops else DEFAULT_PLATFORMS
    inputs = [n.meta["val"] for n in ep.graph.nodes
              if n.op == "placeholder"
              and n.name in ep.graph_signature.user_inputs]
    outputs = [a.meta["val"] for a in ep.graph.output_node().args[0]]
    meta = {
        "torch_version": torch.__version__,
        "platforms": list(platforms),
        "custom_ops": ops,
        "loader": ("import ctseg_tpu_torch.ops.custom_ops before "
                   "torch.export.load (inference.export.load_exported does)"
                   if ops else "torch alone"),
        "in_specs": [_spec(v) for v in inputs],
        "out_specs": [_spec(v) for v in outputs],
        "config": dict(config) if config else None,
    }
    Path(str(path) + ".json").write_text(json.dumps(meta, indent=1))
    return path


def load_exported(path, device=None) -> torch.nn.Module:
    """Load an artifact -> a callable module, moved to `device` when one is
    given. The `ctseg::` ops are registered first (the import of
    ops/custom_ops.py), so a kernel artifact loads too; a portable one
    needs only torch (`torch.export.load(path).module()`). A portable
    artifact's convs follow the process's TF32 flags: the port turns them
    off (training/config.py::use_float32_convs) to compute in FP32."""
    ep = torch.export.load(str(path))
    if device is not None:
        ep = move_to_device_pass(ep, device)
    return ep.module().requires_grad_(False)


def export_checkpoint(
    checkpoint: str,
    out: str,
    slice_shape: Tuple[int, int] = (280, 280),
    patch_size: Tuple[int, int, int] = (128, 128, 48),
    platforms: Sequence[str] = DEFAULT_PLATFORMS,
    infer_dtype: Optional[str] = None,
    device="cuda",
) -> Path:
    """Load `checkpoint` on `device`, export its model (2D or 3D from its
    config), save."""
    config, model = load_checkpoint(checkpoint, device)
    if config.spatial_dims == 3:
        ep = export_patch_model(model, config, patch_size, platforms,
                                infer_dtype)
    else:
        ep = export_slice_model(model, config, slice_shape, platforms,
                                infer_dtype)
    meta = dict(config.as_dict(), _exported_infer_dtype=infer_dtype)
    return save_exported(ep, out, config=meta)


def main(argv: Optional[Sequence[str]] = None):
    parser = ArgumentParser(description="Export a checkpoint with torch.export")
    parser.add_argument("--checkpoint", required=True,
                        help="a port checkpoint or a reference Lightning "
                        ".ckpt file")
    parser.add_argument("--out", required=True, help="artifact path (.pt2)")
    parser.add_argument(
        "--slice_shape", type=int, nargs=2, default=(280, 280),
        metavar=("H", "W"), help="native slice shape baked into a 2D export",
    )
    parser.add_argument("--patch_size", type=int, nargs=3,
                        default=(128, 128, 48), help="3D checkpoints only")
    parser.add_argument(
        "--platforms", nargs="+", default=list(DEFAULT_PLATFORMS),
        choices=DEFAULT_PLATFORMS,
        help="targets (default: cpu cuda, a portable artifact of aten ops); "
        "cuda alone bakes in the hand-written kernels",
    )
    parser.add_argument(
        "--infer_dtype", choices=("checkpoint", "float32", "bfloat16"),
        default="checkpoint",
        help="activation compute dtype baked into the artifact",
    )
    parser.add_argument("--device", default="cuda",
                        help="where the checkpoint loads and is traced (a "
                        "portable artifact is then moved to the CPU)")
    args = parser.parse_args(argv)
    path = export_checkpoint(
        args.checkpoint, args.out, slice_shape=tuple(args.slice_shape),
        patch_size=tuple(args.patch_size), platforms=tuple(args.platforms),
        infer_dtype=None if args.infer_dtype == "checkpoint" else args.infer_dtype,
        device=args.device,
    )
    print(f"wrote {path} (+{path}.json)")


if __name__ == "__main__":
    main()
