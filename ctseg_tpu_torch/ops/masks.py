"""Logits -> label map (port of ctseg_tpu/ops/masks.py::squash_predictions).

Softmax is monotonic, so the reference's softmax + argmax
(capstone/training/utils.py:19-20) is the argmax of the logits.
torch.argmax returns the first maximal index, as jnp.argmax does.
"""

import torch


def squash_predictions(logits: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """(..., C) logits -> (...) predicted label map."""
    return torch.argmax(logits, dim=dim)
