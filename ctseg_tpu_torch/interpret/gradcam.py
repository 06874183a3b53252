"""GradCAM for the segmentation models (port of
ctseg_tpu/interpret/gradcam.py).

Per class, the scalar target is the class logit summed over every pixel and
sample (a one-hot channel cotangent broadcast to the whole logits, as the
JAX package's `_gradcam_multi` does); the attribution at a named layer is
ReLU(sum_c pooled_grad_c * activation_c), with the gradient pooled by its
mean over the layer's spatial axes, then resized linearly (bilinear or
trilinear, half-pixel) to the input's spatial size.

Layer names are the JAX model's (ctseg_tpu/models/unet.py:170-193):
feat_down0..D-1 (encoder level i's output), feat_bottom, feat_up1..D-1
(decoder level i's output). `layers(model)` maps them onto the MONAI
module tree: feat_down{i} is `unet.model` + `.1.submodule` x i + `.0`,
feat_bottom the innermost `.1.submodule`, feat_up{i} `... .1.submodule` x i
+ `.2`.

In place of flax's `perturb`, a forward hook on that module returns its
output detached as a new leaf that requires grad: the graph starts at the
layer, and the gradient there is the total one, through the skip
connection and the deeper path alike. The parameters are frozen for the
call (their `requires_grad` restored after it), so the units before the
layer run their inference forms and those after it their training forms,
whose backwards are K1b and K2b on the card; the stride-1 units' conv
backward computes dx only (ops/conv_block.py::conv3x3_backward).

One forward, then one backward per class through the retained graph
(`torch.autograd.grad` in a loop). Not `is_grads_batched=True`: it vmaps
the backward, and the hand kernels' autograd.Functions read `data_ptr()`,
which vmap's batched tensors do not have. Not one backward over the batch
replicated per class: exact too, but it holds 9 forwards' activations.
"""

from typing import Dict, Iterable

import torch
import torch.nn as nn
import torch.nn.functional as F

from ctseg_tpu_torch.constants import NUM_STRUCTURES
from ctseg_tpu_torch.models.unet import _SkipConnection


def layers(model: nn.Module) -> Dict[str, nn.Module]:
    """{JAX layer name: module} of a SegmentationModel (or its UNet), in
    the JAX model's order: the encoder, the bottom, the decoder."""
    node = getattr(model, "unet", model).model
    downs, ups = {}, {}
    i = 0
    while True:
        downs[f"feat_down{i}"] = node[0]
        if i > 0:
            ups[f"feat_up{i}"] = node[2]
        sub = node[1].submodule
        if not (isinstance(sub, nn.Sequential) and len(sub) == 3
                and isinstance(sub[1], _SkipConnection)):
            return {**downs, "feat_bottom": sub,
                    **dict(sorted(ups.items(), reverse=True))}
        node, i = sub, i + 1


def class_activation_maps(
    model: nn.Module,
    x: torch.Tensor,
    class_indices: Iterable[int],
    layer: str = "feat_down1",
    with_parts: bool = False,
):
    """(cams (K, N, *spatial), logits (N, classes, *spatial)) for the K
    classes, from one forward of x (N, C, *spatial) and K backwards. With
    `with_parts`, a third item: {"activation": the layer's output (N, C,
    *s), "gradients": each class's gradient there (K, N, C, *s), "maps":
    the maps before their ReLU and resize (K, N, *s)}."""
    found = layers(model)
    if layer not in found:
        raise KeyError(f"layer {layer!r} not found; available: {list(found)}")
    captured = {}

    def capture(module, inputs, out):
        captured["act"] = out.detach().requires_grad_()
        return captured["act"]

    params = list(model.parameters())
    wanted = [p.requires_grad for p in params]
    handle = found[layer].register_forward_hook(capture)
    try:
        for p in params:
            p.requires_grad_(False)
        with torch.enable_grad():
            logits = model(x)
        act = captured["act"]
        ctype = torch.promote_types(act.dtype, torch.float32)
        classes = list(class_indices)
        cams, grads = [], []
        for k, c in enumerate(classes):
            g = torch.zeros_like(logits)
            g[:, c] = 1
            (grad,) = torch.autograd.grad(logits, act, grad_outputs=g,
                                          retain_graph=k + 1 < len(classes))
            pooled = grad.to(ctype).mean(dim=tuple(range(2, grad.ndim)),
                                         keepdim=True)
            cams.append((pooled * act.detach().to(ctype)).sum(dim=1))
            if with_parts:
                grads.append(grad)
    finally:
        handle.remove()
        for p, w in zip(params, wanted):
            p.requires_grad_(w)
    maps = torch.stack(cams)  # (K, N, *layer spatial)
    k, n = maps.shape[:2]
    mode = {2: "bilinear", 3: "trilinear"}[x.ndim - 2]
    cams = F.interpolate(F.relu(maps).reshape(k * n, 1, *maps.shape[2:]),
                         size=tuple(x.shape[2:]), mode=mode,
                         align_corners=False)
    out = (cams.reshape(k, n, *x.shape[2:]), logits.detach())
    if not with_parts:
        return out
    return (*out, {"activation": act.detach(), "gradients": torch.stack(grads),
                   "maps": maps})


def gradcam(model: nn.Module, x: torch.Tensor, class_idx: int,
            layer: str = "feat_down1") -> torch.Tensor:
    """CAM for one class: x (N, C, *spatial) -> (N, *spatial)."""
    return class_activation_maps(model, x, (int(class_idx),), layer)[0][0]


def gradcam_all_structures(model: nn.Module, x: torch.Tensor,
                           layer: str = "feat_down1") -> torch.Tensor:
    """(N, 9, *spatial) maps, one per structure (classes 1..9)."""
    cams, _ = class_activation_maps(
        model, x, range(1, NUM_STRUCTURES + 1), layer)
    return cams.movedim(0, 1)
