"""Published model configurations (reference Report.pdf Table 1; port of
ctseg_tpu/models/presets.py).

Model L: 26M params, Focal+Dice, 2 residual units, exclude-missing masking.
Model M: weighted mixup, Focal+Dice+Boundary, 1 residual unit.
Both: filters 64..1024, batch 128, lr 1e-3, 200 epochs, trained on
train+valid for the final numbers. Model 3D: the reference's volumetric
parity configuration (whole volumes resized to 256x256x96, CrossEntropy,
batch 1), trained by the `train_3d` subcommand.
"""

from ctseg_tpu_torch.training.config import TrainConfig

MODEL_L = TrainConfig(
    filters=(64, 128, 256, 512, 1024),
    num_res_units=2,
    transform_degree=2,
    lr=1e-3,
    batch_size=128,
    loss_fx=("Focal", "Dice"),
    exclude_missing=True,
    mixup=False,
    epochs=200,
)

MODEL_M = TrainConfig(
    filters=(64, 128, 256, 512, 1024),
    num_res_units=1,
    transform_degree=2,
    lr=1e-3,
    batch_size=128,
    loss_fx=("Boundary", "Dice", "Focal"),
    exclude_missing=True,
    mixup=True,
    epochs=200,
)

# 3D reference-parity configuration (volumetric/base_trainer.py defaults).
MODEL_3D = TrainConfig(
    filters=(64, 128, 256, 512, 1024),
    num_res_units=2,
    transform_degree=0,
    lr=1e-3,
    batch_size=1,
    loss_fx=("CrossEntropy",),
    spatial_dims=3,
    input_shape=(256, 256, 96),
    in_channels=1,
    plateau_patience=10_000,
    epochs=200,
)

PRESETS = {"model_l": MODEL_L, "model_m": MODEL_M, "model_3d": MODEL_3D}
