"""MONAI key layout, and JAX parameter trees -> the port's state_dict.

`monai_key_map` is a copy of ctseg_tpu/models/torch_import.py::monai_key_map:
it enumerates (flax_path, torch_prefix, kind) for every parameterized module
of the reference model. `state_dict_from_jax_params` inverts that module's
`_conv_to_flax` / `_convT_to_flax`, so the JAX package's parameters (as a
nested dict of numpy arrays; no JAX needed here) load into
SegmentationModel. Together with `import_monai_state_dict` in the JAX package
this lets the parity tests run both models on the same weights.

Layouts:
  conv:   flax (*k, in, out) -> torch (out, in, *k)
  convT:  flax (*k, in, out) -> torch (in, out, *k), spatial axes flipped
  PReLU:  flax alpha (1,)    -> torch weight (1,)
"""

from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

FlaxPath = Tuple[str, ...]


def monai_key_map(
    in_channels: int,
    channels: Tuple[int, ...],
    strides: Tuple[int, ...] = (2, 2, 2, 2),
    num_res_units: int = 0,
    downsample: bool = False,
) -> List[Tuple[FlaxPath, str, str]]:
    """Enumerate (flax_path, torch_prefix, kind) for every parameterized
    module of the reference model (kind in {"conv", "convT", "prelu"}).

    flax paths are relative to the SegmentationModel params root; torch
    prefixes are relative to the reference's BaseUNet2D (`conv1x1.*` and
    `unet.model.*`, matching the released checkpoints).
    """
    depth = len(strides)
    assert len(channels) == depth + 1
    entries: List[Tuple[FlaxPath, str, str]] = []

    def conv_unit(fpath: FlaxPath, tprefix: str, conv_only: bool, transposed=False):
        conv_name = "ConvTranspose_0" if transposed else "Conv_0"
        kind = "convT" if transposed else "conv"
        entries.append((fpath + (conv_name,), f"{tprefix}.conv", kind))
        if not conv_only:
            entries.append((fpath + ("PReLU_0",), f"{tprefix}.act", "prelu"))

    def residual_unit(
        fpath: FlaxPath, tprefix: str, inc: int, outc: int, stride: int,
        subunits: int, last_conv_only: bool,
    ):
        subunits = max(1, subunits)
        for su in range(subunits):
            conv_unit(
                fpath + (f"unit{su}",),
                f"{tprefix}.conv.unit{su}",
                last_conv_only and su == subunits - 1,
            )
        if stride != 1 or inc != outc:
            entries.append((fpath + ("shortcut",), f"{tprefix}.residual", "conv"))

    def down_layer(fpath, tprefix, inc, outc, stride):
        if num_res_units > 0:
            residual_unit(fpath, tprefix, inc, outc, stride, num_res_units, False)
        else:
            conv_unit(fpath, tprefix, conv_only=False)

    if downsample:
        entries.append((("conv1x1",), "conv1x1", "conv"))
        in_channels = 1

    unet = ("unet",)
    inc = in_channels
    for i in range(depth):
        bp = "unet.model" + ".1.submodule" * i
        down_layer(unet + (f"down{i}",), f"{bp}.0", inc, channels[i], strides[i])
        inc = channels[i]
    bottom_prefix = "unet.model" + ".1.submodule" * depth
    down_layer(unet + ("bottom",), bottom_prefix, channels[depth - 1], channels[depth], 1)

    for i in range(depth):
        bp = "unet.model" + ".1.submodule" * i
        is_top = i == 0
        if num_res_units > 0:
            conv_unit(
                unet + (f"up{i}_transp",), f"{bp}.2.0", conv_only=False,
                transposed=True,
            )
            # stride 1 and in==out: the decoder ResidualUnit never has a
            # shortcut conv, so the channel arguments only need to be equal.
            residual_unit(unet + (f"up{i}_ru",), f"{bp}.2.1", 0, 0, 1, 1, is_top)
        else:
            conv_unit(
                unet + (f"up{i}_transp",), f"{bp}.2", conv_only=is_top,
                transposed=True,
            )
    return entries


def _conv_from_flax(w: np.ndarray) -> np.ndarray:
    # (*k, in, out) -> (out, in, *k)
    return np.moveaxis(w, (-1, -2), (0, 1))


def _convT_from_flax(w: np.ndarray) -> np.ndarray:
    # unflip the spatial axes, then (*k, in, out) -> (in, out, *k)
    w = w[tuple(slice(None, None, -1) for _ in range(w.ndim - 2))]
    return np.moveaxis(w, (-2, -1), (0, 1))


def state_dict_from_jax_params(
    params: Mapping[str, Any],
    in_channels: int,
    channels: Tuple[int, ...],
    strides: Tuple[int, ...] = (2, 2, 2, 2),
    num_res_units: int = 0,
    downsample: bool = False,
) -> Dict[str, torch.Tensor]:
    """JAX SegmentationModel params ({"params": ...} or its inner tree, numpy
    leaves) -> a state_dict for the port's SegmentationModel, dtype kept."""
    root = params["params"] if "params" in params else params
    sd: Dict[str, torch.Tensor] = {}
    for fpath, tprefix, kind in monai_key_map(
        in_channels, tuple(channels), tuple(strides), num_res_units, downsample
    ):
        node = root
        for name in fpath:
            node = node[name]
        if kind == "prelu":
            sd[f"{tprefix}.weight"] = _tensor(node["alpha"])
            continue
        w = np.asarray(node["kernel"])
        w = _convT_from_flax(w) if kind == "convT" else _conv_from_flax(w)
        sd[f"{tprefix}.weight"] = _tensor(w)
        sd[f"{tprefix}.bias"] = _tensor(node["bias"])
    return sd


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))  # a writable, contiguous copy
