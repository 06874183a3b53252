"""ReduceLROnPlateau as a state transition on Python floats (port of
ctseg_tpu/training/schedule.py).

torch.optim.lr_scheduler.ReduceLROnPlateau as the reference configures it
(capstone/training/base_trainer.py:140-148): mode 'max' on the validation
mean Dice, factor 0.5, relative threshold 0.01, patience 10, cooldown 0,
min_lr 0, eps 1e-8. The state is a NamedTuple so a checkpoint stores it as
three numbers.
"""

import math
from typing import NamedTuple, Tuple


class PlateauState(NamedTuple):
    lr: float  # current learning rate
    best: float  # best metric seen so far
    num_bad_epochs: int  # epochs without improvement


def plateau_init(lr: float, mode: str = "max") -> PlateauState:
    return PlateauState(lr=float(lr),
                        best=-math.inf if mode == "max" else math.inf,
                        num_bad_epochs=0)


def reduce_on_plateau(
    state: PlateauState,
    metric: float,
    mode: str = "max",
    factor: float = 0.5,
    patience: int = 10,
    threshold: float = 0.01,
    min_lr: float = 0.0,
    eps: float = 1e-8,
) -> Tuple[PlateauState, float]:
    """One per-epoch transition; returns (new_state, new_lr).

    With the relative threshold and mode 'max', `metric` improves iff
    metric > best * (1 + threshold) (for best >= 0); the LR is multiplied
    by `factor` once more than `patience` epochs in a row fail to improve,
    and only if the change exceeds `eps`.
    """
    metric = float(metric)
    if mode == "max":
        is_better = metric > state.best * (1.0 + threshold)
    else:
        is_better = metric < state.best * (1.0 - threshold)
    best = metric if is_better else state.best
    num_bad = 0 if is_better else state.num_bad_epochs + 1
    lr = state.lr
    if num_bad > patience:
        new_lr = max(state.lr * factor, min_lr)
        if state.lr - new_lr > eps:
            lr = new_lr
        num_bad = 0
    return PlateauState(lr=lr, best=best, num_bad_epochs=num_bad), lr
