"""The inference forms of K1 and K2 as `torch.library` custom ops.

  ctseg::instance_norm_prelu(x, alpha) -> y          K1, ops/instance_norm.py
  ctseg::conv3x3_in_prelu(x, w, b, alpha) -> y       K2, ops/conv_block.py

The kernels are ctypes calls on `tensor.data_ptr()`, which `torch.export`'s
fake tensors cannot trace. As custom ops with a fake implementation (an
empty tensor of the output's shape, dtype and contiguous (N, *spatial, C)
layout) they stay in an exported graph as `ctseg::` nodes, and an exported
program launches the kernels when it runs on the card.

Each op has one implementation for every device: the kernel module's
`_forward(..., train=False)`, which launches the CUDA kernel for a CUDA
tensor (and counts the launch there, so an exported program's launches are
counted too) or raises on what the kernel does not take, and runs the plain
PyTorch version for a CPU tensor.

The inference calls of the two wrappers take these ops on every device, so
one route serves eager inference and an exported program, and a graph
traced anywhere holds the `ctseg::` nodes. The portable export replaces
them with the plain versions (`plain_decompositions()`) by
`ExportedProgram.run_decompositions`.

Importing this module registers the ops; `inference/export.py::
load_exported` imports it before deserializing an artifact that holds them.
"""

import torch

NAMESPACE = "ctseg"


@torch.library.custom_op("ctseg::instance_norm_prelu", mutates_args=())
def instance_norm_prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """K1's inference form: PReLU(InstanceNorm(x)), x (N, *spatial, C)."""
    from ctseg_tpu_torch.ops.instance_norm import _forward

    return _forward(x, alpha, train=False)[0].contiguous()


@instance_norm_prelu.register_fake
def _(x, alpha):
    return x.new_empty(x.shape)


@torch.library.custom_op("ctseg::conv3x3_in_prelu", mutates_args=())
def conv3x3_in_prelu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     alpha: torch.Tensor) -> torch.Tensor:
    """K2's inference form: PReLU(InstanceNorm(conv3x3_same(x, w) + b)),
    x (N, H, W, Cin), w (3, 3, Cin, Cout) -> (N, H, W, Cout)."""
    from ctseg_tpu_torch.ops.conv_block import _forward

    return _forward(x, w, b, alpha, train=False)[0].contiguous()


@conv3x3_in_prelu.register_fake
def _(x, w, b, alpha):
    return x.new_empty((x.shape[0], x.shape[1], x.shape[2], w.shape[3]))


def plain_decompositions() -> dict:
    """{op overload: its plain PyTorch version}: the decomposition table
    that turns a graph of `ctseg::` nodes into aten ops only."""
    from ctseg_tpu_torch.ops.conv_block import conv3x3_in_prelu_plain
    from ctseg_tpu_torch.ops.instance_norm import instance_norm_prelu_plain

    return {
        torch.ops.ctseg.instance_norm_prelu.default: instance_norm_prelu_plain,
        torch.ops.ctseg.conv3x3_in_prelu.default: conv3x3_in_prelu_plain,
    }
