"""Faults planted underneath the timed path, for the readings
(readings.py) and the tests that see `correct` come out false:

  - `state_unchanged`: the optimizer's step does nothing, so a train step
    returns its state as it found it;
  - `half_batch`: a train step sees the first half of its batch and takes
    its mean over those rows;
  - `answer_altered`: the slice model's label maps have one row of their
    first slice shifted to the next class where they are produced
    (inference/predict.py::slice_labels);
  - `exchange_left_out`: the ranks of a data mesh skip the sum of their
    gradients (parallel/distributed.py::sum_gradients, as the trainer
    calls it), so each applies its own rows' update.

Each is a context manager that patches the program for its duration, and
names itself in `active()` meanwhile, so that a data-parallel run plants
it in every rank's process too.
"""

import contextlib
import functools

_ACTIVE = []


def active():
    return tuple(_ACTIVE)


def _named(fn):
    @functools.wraps(fn)
    @contextlib.contextmanager
    def cm():
        _ACTIVE.append(fn.__name__)
        try:
            with contextlib.contextmanager(fn)():
                yield
        finally:
            _ACTIVE.remove(fn.__name__)
    return cm


@_named
def state_unchanged():
    import torch

    step = torch.optim.Adam.step
    torch.optim.Adam.step = lambda self, closure=None: None
    try:
        yield
    finally:
        torch.optim.Adam.step = step


@_named
def half_batch():
    from ctseg_tpu_torch.training.trainer import Trainer

    step = Trainer.train_step

    def half(self, state, batch, draws=None, **kw):
        n = batch[0].shape[0] // 2
        batch = tuple(t[:n] for t in batch)
        if draws is not None:
            draws = type(draws)(*(t[:n] for t in draws))
        return step(self, state, batch, draws, **kw)

    Trainer.train_step = half
    try:
        yield
    finally:
        Trainer.train_step = step


@_named
def answer_altered():
    from ctseg_tpu_torch.inference import predict

    labels = predict.slice_labels

    def altered(*args, **kw):
        out = labels(*args, **kw).clone()
        out[0, out.shape[1] // 2] = (out[0, out.shape[1] // 2] + 1) % 10
        return out

    predict.slice_labels = altered
    try:
        yield
    finally:
        predict.slice_labels = labels


@_named
def exchange_left_out():
    from ctseg_tpu_torch.training import trainer

    summed = trainer.sum_gradients
    trainer.sum_gradients = lambda params, group: None
    try:
        yield
    finally:
        trainer.sum_gradients = summed


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "answer_altered": answer_altered,
          "exchange_left_out": exchange_left_out}
