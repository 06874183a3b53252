from ctseg_tpu_torch.ops.masks import (  # noqa: F401
    one_hot,
    squash_masks,
    squash_predictions,
)
