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

`AsyncCheckpointer` (after ctseg_tpu/training/checkpoint.py:121-160) saves
without holding up the training loop: clones of the state on the card,
then the copy to the host (on a stream of its own), `torch.save` and the
rename in a worker thread.
"""

import os
import threading
from pathlib import Path
from typing import TYPE_CHECKING, Any, Dict, Tuple, Union

import torch

from ctseg_tpu_torch.training.config import TrainConfig, model_from_checkpoint
from ctseg_tpu_torch.training.optimizer import make_adam
from ctseg_tpu_torch.training.schedule import PlateauState, plateau_init

if TYPE_CHECKING:
    from ctseg_tpu_torch.training.trainer import TrainState


def _payload(config: TrainConfig, state: "TrainState") -> Dict[str, Any]:
    """The checkpoint's contents; its tensors are the state's own."""
    return {
        "hyper_parameters": config.as_dict(),
        "state_dict": {k: v.detach()
                       for k, v in state.model.state_dict().items()},
        "optimizer": state.optimizer.state_dict(),
        "plateau": state.plateau._asdict(),
        "step": state.step,
    }


def _map_tensors(fn, tree):
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    return tree


def _write(path: Path, payload: Dict[str, Any]) -> None:
    """The payload's tensors on the host, saved to a temporary file that
    then replaces `path`."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    torch.save(_map_tensors(lambda t: t.cpu(), payload), str(tmp))
    os.replace(tmp, path)


def save(path: Union[str, Path], config: TrainConfig,
         state: "TrainState") -> None:
    _write(Path(path), _payload(config, state))


class AsyncCheckpointer:
    """Non-blocking checkpoint saves for the training loop.

    `save()` clones every tensor of the state on the current stream (device
    copies, ordered before the next step's in-place Adam update) and hands
    the rest to a worker thread. On a card the worker copies the clones to
    pinned host memory on a stream of its own, after the clones' event: a
    copy on the loop's stream would wait behind the steps queued there and
    stall them. Then it saves and renames. At most one save is in flight: a
    new `save()` first joins the previous one. `wait()` joins it and raises
    its failure, once; call it before reading the checkpoint or exiting.
    """

    def __init__(self):
        self._thread = None
        self._error = None

    def save(self, path: Union[str, Path], config: TrainConfig,
             state: "TrainState") -> None:
        self.wait()
        snapshot = _map_tensors(torch.clone, _payload(config, state))
        device = next(state.model.parameters()).device
        ready = None
        if device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(device))

        def work():
            try:
                payload = snapshot
                if ready is not None:
                    side = torch.cuda.Stream(device)
                    with torch.cuda.stream(side):
                        side.wait_event(ready)
                        payload = _map_tensors(
                            lambda t: t.to("cpu", non_blocking=True), snapshot)
                    side.synchronize()
                _write(Path(path), payload)
            except Exception as e:  # raised by the next wait() or save()
                self._error = e

        self._thread = threading.Thread(target=work, name="ctseg-async-ckpt",
                                        daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint save failed") from err


def load(path: Union[str, Path], device="cuda"
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
