"""Adam with the plateau learning rate (port of ctseg_tpu/training/optimizer.py).

The JAX package hand-rolls Adam to be torch-exact (torch.optim.Adam's
update: b1 0.9, b2 0.999, eps 1e-8 outside the sqrt, bias-corrected
moments), so the port uses torch.optim.Adam itself. The learning rate is a
plain float set from the plateau state before each step.
"""

from typing import Iterable

import torch


def make_adam(params: Iterable[torch.nn.Parameter], lr: float,
              eps: float = 1e-8) -> torch.optim.Adam:
    """The reference's optimizer (capstone/training/base_trainer.py:138-139)."""
    return torch.optim.Adam(params, lr=lr, eps=eps)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
