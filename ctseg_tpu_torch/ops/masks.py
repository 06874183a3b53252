"""Label-map <-> mask-stack conversions, channel-last (port of
ctseg_tpu/ops/masks.py).

  squash_masks: S binary structure masks x class ids 1..S, max over the
    structure axis -> one integer label map; where structures overlap the
    highest class id wins (reference capstone/training/utils.py:13-16).
  squash_predictions: softmax + argmax over the class axis (reference
    capstone/training/utils.py:19-20); softmax is monotonic, so this is the
    argmax of the logits. torch.argmax returns the first maximal index, as
    jnp.argmax does.
  one_hot: as jax.nn.one_hot, a label outside [0, n_classes) gives a row of
    zeros (torch.nn.functional.one_hot would raise).
"""

import torch


def squash_masks(masks: torch.Tensor, n_classes: int) -> torch.Tensor:
    """(..., S) stack of S = n_classes - 1 binary structure masks -> (...)
    int32 label map: structure s (0-based channel) gets class id s + 1,
    background 0, the highest id where structures overlap."""
    n_structures = n_classes - 1
    if masks.shape[-1] != n_structures:
        raise ValueError(f"expected {n_structures} structure masks, got "
                         f"{masks.shape[-1]}")
    class_ids = torch.arange(1, n_classes, dtype=torch.int32,
                             device=masks.device)
    return torch.amax(masks.to(torch.int32) * class_ids, dim=-1)


def squash_predictions(logits: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """(..., C) logits -> (...) predicted label map."""
    return torch.argmax(logits, dim=dim)


def one_hot(labels: torch.Tensor, n_classes: int,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(...) integer label map -> (..., n_classes) one-hot of `dtype`."""
    classes = torch.arange(n_classes, device=labels.device)
    return (labels[..., None] == classes).to(dtype)
