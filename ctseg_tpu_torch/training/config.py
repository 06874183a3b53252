"""TrainConfig and checkpoints of the port (from ctseg_tpu/training/trainer.py).

`TrainConfig` keeps the JAX package's fields and `as_dict`/`from_dict`, so
the same hyperparameter dicts describe both. A checkpoint is the shape of a
Lightning `.ckpt`: {"hyper_parameters": config dict, "state_dict": MONAI
keys, float32}; a training checkpoint (training/checkpoint.py) adds the
optimizer, plateau and step. `load_checkpoint` reads all of them and the
reference's `.ckpt` files alike for inference; the port never reads the JAX
package's flax msgpack checkpoints.
"""

import dataclasses
from pathlib import Path
from typing import Any, Dict, Tuple, Union

import torch

from ctseg_tpu_torch.constants import EXPERIMENT_SEED, NUM_CLASSES
from ctseg_tpu_torch.models.unet import SegmentationModel
from ctseg_tpu_torch.transforms.pipelines import transform_in_channels


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Hyperparameters (reference argparse surface, base_trainer.py:150-209)."""

    filters: Tuple[int, ...] = (64, 128, 256, 512, 1024)
    num_res_units: int = 0  # use_res_units: base->2, mixup->1
    downsample: bool = False
    transform_degree: int = 0
    lr: float = 1e-3
    batch_size: int = 128
    loss_fx: Tuple[str, ...] = ("Focal", "Dice")
    exclude_missing: bool = False
    mixup: bool = False
    mixup_alpha: float = 0.2
    epochs: int = 200
    seed: int = EXPERIMENT_SEED
    plateau_factor: float = 0.5
    plateau_patience: int = 10
    plateau_threshold: float = 0.01
    # "float32", "bfloat16" or "float64" (the CPU differential tests).
    compute_dtype: str = "float32"
    # The JAX package's TPU-only switches, kept so its checkpoints' hparams
    # round-trip. They have no effect here: on CUDA the hand-written kernels
    # ARE the implementation of every IN+PReLU and stride-1 3x3 unit.
    fused_conv: bool = False
    fused_norm: bool = False
    polyphase_up: bool = False
    packed_depth: bool = False
    packed_up_fwd: bool = False
    spatial_dims: int = 2
    input_size: int = 256  # post-transform spatial size (reference: 256)
    input_shape: Any = None  # tuple of spatial dims
    in_channels: Any = None
    volumetric_mode: Any = None
    steps_per_epoch: Any = None

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TrainConfig":
        d = dict(d)
        for k in ("filters", "loss_fx", "input_shape"):
            if k in d and isinstance(d[k], list):
                d[k] = tuple(d[k])
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float64": torch.float64,
}


def model_dtype(config: TrainConfig) -> torch.dtype:
    return _DTYPES[config.compute_dtype]


def use_float32_convs() -> None:
    """A float32 model computes in float32 on the card: cuDNN's convs and
    cuBLAS's matmuls may not round their inputs to TF32, as torch lets cuDNN
    do by default. The hand-written kernels compute in FP32, so without this
    the library convs beside them (strided, transposed, shortcut, and every
    conv backward) would run at another precision. Process-wide torch flags;
    no effect on bfloat16 convs or on the CPU."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def build_model(config: TrainConfig, device="cuda",
                generator: torch.Generator = None) -> SegmentationModel:
    """The 2D or 3D SegmentationModel a config describes: float32
    parameters (float64 for "float64"), computing in the config's dtype;
    `in_channels` from the config, else from its transform degree. Every
    model of the port is built here, so this is where TF32 is turned off
    (`use_float32_convs`)."""
    if config.spatial_dims not in (2, 3):
        raise ValueError(f"spatial_dims {config.spatial_dims}: 2 or 3")
    use_float32_convs()
    return SegmentationModel(
        in_channels=config.in_channels
        or transform_in_channels(config.transform_degree),
        out_channels=NUM_CLASSES,
        channels=tuple(config.filters),
        num_res_units=config.num_res_units,
        downsample=config.downsample,
        spatial_dims=config.spatial_dims,
        device=device,
        dtype=model_dtype(config),
        generator=generator,
    )


def input_shape(config: TrainConfig) -> Tuple[int, ...]:
    """The model's spatial input shape: `input_shape`, else `input_size`
    on every axis (the JAX Trainer.init_state's rule)."""
    return tuple(config.input_shape
                 or (config.input_size,) * config.spatial_dims)


def save_checkpoint(path: Union[str, Path], config: TrainConfig,
                    model: torch.nn.Module) -> None:
    torch.save(
        {"hyper_parameters": config.as_dict(),
         "state_dict": {k: v.detach().cpu() for k, v in model.state_dict().items()}},
        str(path),
    )


def _num_res_units(state_dict) -> int:
    """Recovered from the keys (`unit1` => 2 subunits), as the JAX
    load_reference_checkpoint does: the reference's mixup trainer hardcodes
    1 while sharing the `use_res_units` hparam."""
    if any(".conv.unit1." in k for k in state_dict):
        return 2
    if any(".conv.unit0." in k for k in state_dict):
        return 1
    return 0


def model_from_checkpoint(ckpt: Dict[str, Any], device="cuda"
                          ) -> Tuple[TrainConfig, SegmentationModel]:
    """A loaded checkpoint dict (the port's, or a reference Lightning
    `.ckpt`'s) -> (config, model on `device`)."""
    hp = dict(ckpt.get("hyper_parameters", ckpt.get("hparams", {})))
    sd = {k.replace(".adn.A.", ".act."): v for k, v in ckpt["state_dict"].items()}
    hp.setdefault("transform_degree", 1)  # the reference's default
    config = dataclasses.replace(
        TrainConfig.from_dict(hp), num_res_units=_num_res_units(sd)
    )
    model = build_model(config, device="cpu")
    # The reference owns conv1x1 even when `downsample` is off and keeps its
    # loss weights in the state_dict; neither is part of the model.
    sd = {
        k: v for k, v in sd.items()
        if not k.startswith("loss_func.")
        and not (not config.downsample and k.startswith("conv1x1."))
    }
    model.load_state_dict(sd)
    return config, model.to(device)


def load_checkpoint(path: Union[str, Path], device="cuda"
                    ) -> Tuple[TrainConfig, SegmentationModel]:
    """A port checkpoint (training/checkpoint.py's included) or a reference
    Lightning `.ckpt` -> (config, model on `device`, in eval mode).

    The file is unpickled (Lightning checkpoints hold more than tensors):
    load only checkpoints you trust.
    """
    ckpt = torch.load(str(path), map_location="cpu", weights_only=False)
    config, model = model_from_checkpoint(ckpt, device)
    return config, model.eval()
