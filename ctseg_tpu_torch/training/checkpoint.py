"""Training checkpoints: one torch.save file (port of
ctseg_tpu/training/checkpoint.py's role).

The file is the inference checkpoint of training/config.py
({"hyper_parameters", "state_dict" under MONAI's keys, float32}) plus
"optimizer" (torch.optim.Adam's state_dict), "plateau" (lr, best,
num_bad_epochs) and "step", so `config.load_checkpoint` and the server read
it as they read any checkpoint, and `load` resumes training from it. A
reference Lightning `.ckpt` loads too, with a fresh optimizer and plateau
at step 0, as the JAX Trainer.restore does. Each save writes a temporary
file and renames it, so a kill leaves the previous checkpoint whole.
"""

import os
from pathlib import Path
from typing import TYPE_CHECKING, Tuple, Union

import torch

from ctseg_tpu_torch.training.config import TrainConfig, model_from_checkpoint
from ctseg_tpu_torch.training.optimizer import make_adam
from ctseg_tpu_torch.training.schedule import PlateauState, plateau_init

if TYPE_CHECKING:
    from ctseg_tpu_torch.training.trainer import TrainState


def save(path: Union[str, Path], config: TrainConfig,
         state: "TrainState") -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {
        "hyper_parameters": config.as_dict(),
        "state_dict": {k: v.detach().cpu()
                       for k, v in state.model.state_dict().items()},
        "optimizer": state.optimizer.state_dict(),
        "plateau": state.plateau._asdict(),
        "step": state.step,
    }
    tmp = path.with_name(path.name + ".tmp")
    torch.save(payload, str(tmp))
    os.replace(tmp, path)


def load(path: Union[str, Path], device="cpu"
         ) -> Tuple[TrainConfig, "TrainState"]:
    """(config, TrainState on `device`). The file is unpickled: load only
    checkpoints you trust."""
    from ctseg_tpu_torch.training.trainer import TrainState

    ckpt = torch.load(str(path), map_location="cpu", weights_only=False)
    config, model = model_from_checkpoint(ckpt, device)
    optimizer = make_adam(model.parameters(), config.lr)
    if "optimizer" in ckpt:
        optimizer.load_state_dict(ckpt["optimizer"])
    plateau = (PlateauState(**ckpt["plateau"]) if "plateau" in ckpt
               else plateau_init(config.lr, mode="max"))
    state = TrainState(step=int(ckpt.get("step", 0)), model=model.train(),
                       optimizer=optimizer, plateau=plateau)
    return config, state
