"""The trainer: train and eval steps, plateau LR, checkpoints (port of
ctseg_tpu/training/trainer.py), 2D and 3D.

  TrainState = (step, model, optimizer, plateau)
  train_step: train transform (2D: degree 2 on K4; 3D: the volumetric
              transform of the config's mode) -> [weighted mixup] ->
              forward (K1, K2 in 2D; K1 and cuDNN convs in 3D) -> multi-loss
              [signed distance maps on K5 for Boundary; under mixup both
              target sets, mixed by lambda] -> backward (K1b, K2b, cuDNN) ->
              Adam(lr from plateau) -> Dice
  eval_step:  test transform -> forward -> losses and per-structure Dice

A train transform maps (images, labels, draws) to (images (N, *spatial, C),
labels); its random parameters, the draws, come from a generator unless the
caller feeds them. A transform that has a `draw(generator, shape, device)`
attribute makes its own; a 2D one without it takes degree 2's
(`draw_degree2`). A test transform maps (images, labels) -> (images,
labels), or, with a `draw` attribute, also takes draws: the reference's
eval step draws them from the fixed key 0, and this one from a generator
seeded 0 (the same distribution; RNG streams are not compared).

Eager PyTorch on one device. A step never waits for the device: metrics
stay device tensors until the one stacked fetch at the end of an epoch.
Losses and metrics run in float32 under bfloat16 compute (float64 under
float64), as in the JAX trainer.
"""

import dataclasses
import signal
import time
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ctseg_tpu_torch.constants import STRUCTURES
from ctseg_tpu_torch.losses.segmentation import MultiLoss
from ctseg_tpu_torch.metrics.dice import (
    DiceMetric,
    dice_per_sample_class,
    masked_mean_batch,
)
from ctseg_tpu_torch.models.layers import channels_last
from ctseg_tpu_torch.models.unet import SegmentationModel
from ctseg_tpu_torch.ops.edt import signed_distance_maps_from_labels
from ctseg_tpu_torch.ops.masks import squash_predictions
from ctseg_tpu_torch.training import checkpoint as ckpt
from ctseg_tpu_torch.training.config import (
    TrainConfig,
    build_model,
    input_shape,
    model_dtype,
)
from ctseg_tpu_torch.training.logging import MetricLogger
from ctseg_tpu_torch.training.mixup import (
    draw_mixup,
    mixup_probability,
    mixup_tensors,
)
from ctseg_tpu_torch.training.optimizer import make_adam, set_lr
from ctseg_tpu_torch.training.schedule import (
    PlateauState,
    plateau_init,
    reduce_on_plateau,
)
from ctseg_tpu_torch.transforms.augment import draw_degree2
from ctseg_tpu_torch.transforms.pipelines import get_transform
from ctseg_tpu_torch.transforms.volumetric import volumetric_transform


@dataclasses.dataclass
class TrainState:
    step: int
    model: SegmentationModel
    optimizer: torch.optim.Adam
    plateau: PlateauState


class Preempted(RuntimeError):
    """Raised by Trainer.fit after a SIGTERM-triggered save: training was cut
    short. Carries the last state; callers must not run their 'training
    finished' tails (publishing the final model, test evaluation)."""

    def __init__(self, state: TrainState, epoch: int):
        super().__init__(f"training preempted by SIGTERM at epoch {epoch}")
        self.state = state
        self.epoch = epoch


def epoch_generator(seed: int, epoch: int, device) -> torch.Generator:
    """The epoch's generator (permutation, then the steps' draws), derived
    from (seed, epoch) so a resumed run continues the sequence."""
    derived = int(np.random.SeedSequence([seed, epoch]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(derived)


class Trainer:
    def __init__(self, config: TrainConfig, device="cuda",
                 train_transform=None, test_transform=None):
        self.config = config
        self.device = torch.device(device)
        self._metric_dtype = (torch.float64 if model_dtype(config) == torch.float64
                              else torch.float32)
        self.loss = MultiLoss(list(config.loss_fx),
                              exclude_missing=config.exclude_missing)
        self.needs_dist_maps = "Boundary" in config.loss_fx
        self.dice = DiceMetric()
        # Each side falls back on its own: a 3D trainer given only a train
        # transform must not evaluate through the 2D resize pipeline.
        if config.spatial_dims == 3:
            vt = volumetric_transform(config.volumetric_mode)
            train_transform = train_transform or vt
            test_transform = test_transform or vt
        size = (config.input_size,) * 2
        self.train_transform = train_transform or get_transform(
            config.transform_degree, True, size)
        self.test_transform = test_transform or get_transform(
            config.transform_degree, False, size)

    # ------------------------------------------------------------------ state
    def init_state(self, generator: Optional[torch.Generator] = None
                   ) -> TrainState:
        """Fresh weights (drawn from `generator`, default seeded by
        config.seed), Adam, and the plateau at the config's LR. The
        weights' shapes follow the config's rank and `in_channels`; its
        input shape must be one the UNet maps onto itself."""
        levels = len(self.config.filters) - 1
        shape = input_shape(self.config)
        if any(s % 2 ** levels for s in shape):
            raise ValueError(
                f"input shape {shape}: each axis must divide by 2**{levels} "
                "for the skip connections to line up")
        gen = generator or torch.Generator().manual_seed(self.config.seed)
        model = build_model(self.config, self.device, generator=gen).train()
        return TrainState(
            step=0, model=model,
            optimizer=make_adam(model.parameters(), self.config.lr),
            plateau=plateau_init(self.config.lr, mode="max"),
        )

    # ------------------------------------------------------------------ steps
    def _logits(self, model, images):
        """images (N, *spatial, C) -> logits (N, classes, *spatial)."""
        x = channels_last(images.movedim(-1, 1))
        return model(x).to(self._metric_dtype)

    def _dist_maps(self, labels):
        """Signed distance maps of the labels (data, no gradient) when a
        Boundary loss wants them."""
        if not self.needs_dist_maps:
            return None
        return signed_distance_maps_from_labels(labels)

    def _losses_and_logits(self, model, images, labels, indicators,
                           sample_mask=None):
        logits = self._logits(model, images)
        values = self.loss(logits, labels, indicators,
                           self._dist_maps(labels), sample_mask)
        return values, logits

    def _predictions(self, logits, indicators):
        """Argmax; with exclude_missing, the logits of structures missing
        from a sample are zeroed first (a reference quirk kept: negative
        logits become 0, not -inf)."""
        if not self.config.exclude_missing:
            return squash_predictions(logits, dim=1)
        ind = indicators.to(logits.dtype).reshape(
            indicators.shape + (1,) * (logits.ndim - 2))
        return squash_predictions(
            torch.cat([logits[:, :1], logits[:, 1:] * ind], dim=1), dim=1
        )

    def draw(self, generator: Optional[torch.Generator], images_raw):
        """The train transform's draws for a raw batch."""
        draw = getattr(self.train_transform, "draw", None)
        if draw is not None:
            return draw(generator, tuple(images_raw.shape), self.device)
        if self.config.spatial_dims != 2:
            return None
        n, h, w = images_raw.shape
        return draw_degree2(generator, n, h, w, self.config.input_size,
                            device=self.device)

    def test_inputs(self, images_raw, labels_raw, draws=None):
        """The test transform of a raw batch, with fixed draws where it
        takes draws (see the module's docstring)."""
        draw = getattr(self.test_transform, "draw", None)
        if draw is None:
            return self.test_transform(images_raw, labels_raw)
        if draws is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
            draws = draw(gen, tuple(images_raw.shape), self.device)
        return self.test_transform(images_raw, labels_raw, draws)

    def train_step(self, state: TrainState, batch,
                   draws=None,
                   generator: Optional[torch.Generator] = None,
                   mixup_draws: Optional[Tuple[torch.Tensor, torch.Tensor]]
                   = None) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One step on a raw batch (images (N, *spatial) HU, labels
        (N, *spatial), indicators (N, 9)); the augmentation `draws` (degree
        2's `Degree2Draws` in 2D, the volumetric transform's in 3D) and,
        under mixup, the partner index and lambda `mixup_draws` are drawn
        from `generator` unless given. Updates `state` in place and returns
        it."""
        images_raw, labels_raw, indicators = batch
        if draws is None:
            draws = self.draw(generator, images_raw)
        images, labels = self.train_transform(images_raw, labels_raw, draws)

        model = state.model.train()
        set_lr(state.optimizer, state.plateau.lr)
        if self.config.mixup:
            if mixup_draws is None:
                mixup_draws = draw_mixup(generator, mixup_probability(labels),
                                         self.config.mixup_alpha)
            index, lam = mixup_draws
            lam = lam.to(self._metric_dtype)  # a device scalar: no wait
            images = images.to(self._metric_dtype)
            logits = self._logits(
                model, mixup_tensors(images, images[index], lam))
            # The maps come from the unmixed labels, once; the partner's
            # are a gather (reference mixup_trainer.py:94-128).
            dist_maps = self._dist_maps(labels)
            labels_b, indicators_b = labels[index], indicators[index]
            values_a = self.loss(logits, labels, indicators, dist_maps)
            values_b = self.loss(
                logits, labels_b, indicators_b,
                None if dist_maps is None else dist_maps[index])
            values = {name: mixup_tensors(values_a[name], values_b[name], lam)
                      for name in values_a}
        else:
            values, logits = self._losses_and_logits(model, images, labels,
                                                     indicators)
        total = self.loss.total(values)
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        state.optimizer.step()

        with torch.no_grad():
            dice_mean, dice_per_class = self.dice(
                self._predictions(logits.detach(), indicators), labels
            )
            if self.config.mixup:
                # Each target set is scored with its own indicator.
                mean_b, per_class_b = self.dice(
                    self._predictions(logits.detach(), indicators_b), labels_b
                )
                dice_mean = mixup_tensors(dice_mean, mean_b, lam)
                dice_per_class = mixup_tensors(dice_per_class, per_class_b, lam)
        metrics = {f"loss/{k}": v.detach() for k, v in values.items()}
        metrics["loss/total"] = total.detach()
        metrics["dice/mean"] = dice_mean
        for s, v in zip(STRUCTURES, dice_per_class):
            metrics[f"dice/{s}"] = v
        metrics["lr"] = state.plateau.lr
        state.step += 1
        return state, metrics

    @torch.no_grad()
    def eval_step(self, model: SegmentationModel, batch, draws=None
                  ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """One evaluation step over a possibly padded batch (images,
        labels, indicators, row_valid): padded rows count for nothing in
        the losses and the Dice. Returns (metrics, number of real rows)."""
        images_raw, labels_raw, indicators, row_valid = batch
        images, labels = self.test_inputs(images_raw, labels_raw, draws)
        values, logits = self._losses_and_logits(
            model.eval(), images, labels, indicators, sample_mask=row_valid
        )
        dice, valid = dice_per_sample_class(
            self._predictions(logits, indicators), labels
        )
        dice_per_class, _ = masked_mean_batch(dice, valid & row_valid[:, None])
        metrics = {f"loss/{k}": v for k, v in values.items()}
        metrics["dice/mean"] = torch.mean(dice_per_class)
        for s, v in zip(STRUCTURES, dice_per_class):
            metrics[f"dice/{s}"] = v
        return metrics, torch.sum(row_valid.to(torch.float32))

    # ------------------------------------------------------------------ loops
    @staticmethod
    def _fetch(values: Dict) -> Dict[str, float]:
        """Device scalars (and plain floats) as floats, with one
        device-to-host copy for all the tensors."""
        names = [k for k, v in values.items() if torch.is_tensor(v)]
        out = {k: float(v) for k, v in values.items() if not torch.is_tensor(v)}
        if names:
            fetched = torch.stack([values[k].double() for k in names])
            out.update(zip(names, fetched.cpu().tolist()))
        return out

    def train_epoch(self, state: TrainState, pipeline,
                    generator: Optional[torch.Generator] = None,
                    logger: Optional[MetricLogger] = None):
        """One epoch, shuffled and augmented from `generator`."""
        sums: Dict = {}
        count = 0
        for batch in pipeline.epoch(generator):
            state, metrics = self.train_step(state, batch, generator=generator)
            count += 1
            for k, v in metrics.items():
                sums[k] = v if k not in sums else sums[k] + v
        means = {f"train/{k}": v / max(count, 1)
                 for k, v in self._fetch(sums).items()}
        if logger is not None:
            logger.log(means, step=state.step)
        return state, means

    def eval_epoch(self, model: SegmentationModel, pipeline, prefix="val",
                   logger: Optional[MetricLogger] = None, step: int = 0):
        """Full-split evaluation: batch means weighted by their real rows."""
        sums: Dict = {}
        rows = torch.zeros((), device=self.device)
        for batch in pipeline.padded_epoch(None):
            metrics, n_valid = self.eval_step(model, batch)
            rows = rows + n_valid
            for k, v in metrics.items():
                sums[k] = v * n_valid if k not in sums else sums[k] + v * n_valid
        fetched = self._fetch({**sums, "_rows": rows})
        denom = max(fetched.pop("_rows"), 1.0)
        means = {f"{prefix}/{k}": v / denom for k, v in fetched.items()}
        if logger is not None:
            logger.log(means, step=step)
        return means

    def fit(self, state: TrainState, train_pipeline, val_pipeline=None,
            epochs: Optional[int] = None,
            logger: Optional[MetricLogger] = None,
            checkpoint_path=None, checkpoint_every: int = 0) -> TrainState:
        """Train up to `epochs` in total (a restored state resumes at the
        epoch its step count gives); the plateau follows val/dice/mean.

        SIGTERM finishes the current epoch, saves to `checkpoint_path` and
        raises `Preempted` carrying the state. `checkpoint_every` > 0 saves
        every that many epochs."""
        epochs = epochs or self.config.epochs
        pipeline_spe = max(1, train_pipeline.num_batches())
        # Resume derives the start epoch from the checkpoint's schedule, so
        # the config records the steps per epoch of the first fit.
        if self.config.steps_per_epoch is None:
            self.config = dataclasses.replace(
                self.config, steps_per_epoch=pipeline_spe
            )
        steps_per_epoch = int(self.config.steps_per_epoch)
        if pipeline_spe != steps_per_epoch and state.step > 0:
            warnings.warn(
                f"resume: the training pipeline yields {pipeline_spe} "
                f"batches/epoch but the checkpoint's schedule is "
                f"{steps_per_epoch}; the start epoch follows the checkpoint"
            )
        start_epoch = min(state.step // steps_per_epoch, epochs)
        preempted = {"flag": False}

        def _on_sigterm(signum, frame):
            preempted["flag"] = True

        prev_handler, installed = None, False
        try:
            prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
            installed = True
        except ValueError:
            pass  # not the main thread: no signal handling there
        try:
            for epoch in range(start_epoch, epochs):
                gen = epoch_generator(self.config.seed, epoch, self.device)
                t0 = time.time()
                state, _ = self.train_epoch(state, train_pipeline, gen, logger)
                if val_pipeline is not None:
                    val = self.eval_epoch(state.model, val_pipeline, "val",
                                          logger, step=state.step)
                    plateau, _ = reduce_on_plateau(
                        state.plateau, val["val/dice/mean"], mode="max",
                        factor=self.config.plateau_factor,
                        patience=self.config.plateau_patience,
                        threshold=self.config.plateau_threshold,
                    )
                    state.plateau = plateau
                if logger is not None:
                    logger.log({"epoch": epoch, "epoch_time": time.time() - t0},
                               step=state.step)
                if preempted["flag"]:
                    if checkpoint_path:
                        self.save(checkpoint_path, state)
                    if logger is not None:
                        logger.log({"preempted_at_epoch": epoch},
                                   step=state.step)
                    raise Preempted(state, epoch)
                if checkpoint_path and checkpoint_every \
                        and (epoch + 1) % checkpoint_every == 0:
                    self.save(checkpoint_path, state)
        finally:
            if installed:
                signal.signal(signal.SIGTERM, prev_handler
                              if prev_handler is not None else signal.SIG_DFL)
        return state

    # ------------------------------------------------------------ checkpoints
    def save(self, path, state: TrainState) -> None:
        ckpt.save(path, self.config, state)

    @classmethod
    def restore(cls, path, device="cuda") -> Tuple["Trainer", TrainState]:
        """(trainer, state) from a training checkpoint, or from any port or
        reference checkpoint with a fresh optimizer and plateau."""
        config, state = ckpt.load(path, device)
        return cls(config, device), state
