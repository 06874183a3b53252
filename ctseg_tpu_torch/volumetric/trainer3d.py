"""3D volumetric training (port of ctseg_tpu/volumetric/trainer3d.py).

The N-D model, losses and metrics are the 2D ones; 3D is a Trainer whose
transforms are those of its config's `volumetric_mode`
(transforms/volumetric.py) fed by a 3D pipeline (volumetric/pipeline3d.py).

Resize mode (the reference's parity mode): whole volumes nearest-resized to
256x256x96, one input channel of raw HU, CrossEntropy, batch 1, Adam with
no LR schedule (a plateau patience larger than any run).

Patch mode: native-resolution random patches, the soft-tissue window and
random H and W flips, trainable with any of the losses.

The `train_3d` subcommand is training/cli.py's `run_3d`.
"""

import dataclasses
from typing import Optional, Tuple

from ctseg_tpu_torch.training.config import TrainConfig
from ctseg_tpu_torch.training.trainer import Trainer
from ctseg_tpu_torch.volumetric.pipeline3d import RESIZE_SHAPE

DEFAULT_PATCH = (128, 128, 48)


def make_trainer_3d(config: Optional[TrainConfig] = None,
                    mode: str = "resize",
                    patch_size: Optional[Tuple[int, int, int]] = None,
                    device="cuda") -> Trainer:
    """A 3D trainer; `config` defaults to the reference's parity settings.

    In patch mode `patch_size` sets the training grid whether or not a
    config is given: it overrides `config.input_shape`. `mode` is stamped
    into the config's `volumetric_mode`, which picks the Trainer's
    transforms."""
    if config is not None and mode == "patch" and patch_size is not None:
        if tuple(config.input_shape or ()) != tuple(patch_size):
            config = dataclasses.replace(config, input_shape=tuple(patch_size))
    if patch_size is None:
        patch_size = DEFAULT_PATCH
    if config is None:
        config = TrainConfig(
            filters=(64, 128, 256, 512, 1024),
            num_res_units=2,  # hardcoded in the reference (3D)
            transform_degree=0,
            lr=1e-3,
            batch_size=1,
            loss_fx=("CrossEntropy",),
            spatial_dims=3,
            input_shape=RESIZE_SHAPE if mode == "resize" else tuple(patch_size),
            in_channels=1,
            # the reference's 3D trainer has no LR schedule
            plateau_patience=10_000,
        )
    if config.volumetric_mode != mode:
        config = dataclasses.replace(config, volumetric_mode=mode)
    return Trainer(config, device)
