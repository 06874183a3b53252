"""Signed Euclidean distance maps for the boundary loss (host-side) (a copy
of ctseg_tpu/data/distance.py: the port never imports the JAX package;
tests/test_torch_data_prep.py pins the code of the two copies equal,
docstrings aside).

Numerical contract from the reference (capstone/data/utils.py:10-26, adapted
from LIVIAETS/boundary-loss): per class,
    map = dist(~mask) * ~mask - (dist(mask) - 1) * mask
with the whole result divided by 255.0 (a reference quirk we preserve).

The reference recomputes this per item, per epoch, inside CPU dataloader
workers — one of its biggest input-pipeline costs. In the port this scipy
version is the host oracle; the train step makes its maps on the card
(ops/edt.py, the row scan and K5).
"""

import numpy as np
from scipy.ndimage import distance_transform_edt


def compute_distance_map(mask: np.ndarray) -> np.ndarray:
    """Per-class signed EDT of a (C, *spatial) binary mask stack.

    Classes with an empty mask yield an all-zero map (reference behavior).
    """
    mask = np.asarray(mask)
    result = np.zeros(mask.shape, dtype=np.float32)
    for c in range(mask.shape[0]):
        posmask = mask[c].astype(bool)
        if posmask.any():
            negmask = ~posmask
            result[c] = (
                distance_transform_edt(negmask) * negmask
                - (distance_transform_edt(posmask) - 1) * posmask
            )
    return result / 255.0
