"""The trainer: train and eval steps, plateau LR, checkpoints (port of
ctseg_tpu/training/trainer.py), 2D and 3D.

  TrainState = (step, model, optimizer, plateau)
  train_step: train transform (2D: the config's degree, on K4 at degree
              2, warps in plain torch at 0, 3 and 4; 3D: the volumetric
              transform of the config's mode) -> [weighted mixup] ->
              forward (K1, K2 in 2D; K1 and cuDNN convs in 3D) -> multi-loss
              [signed distance maps on K5 for Boundary; under mixup both
              target sets, mixed by lambda] -> backward (K1b, K2b, cuDNN) ->
              Adam(lr from plateau) -> Dice
  eval_step:  test transform -> forward -> losses and per-structure Dice

A train transform maps (images, labels, draws) to (images (N, *spatial, C),
labels); its random parameters, the draws, come from a generator unless the
caller feeds them: every train transform of the port carries a
`draw(generator, shape, device)` attribute that makes them (a transform
without one gets None). A test transform maps (images, labels) -> (images,
labels), or, with a `draw` attribute, also takes draws: the reference's
eval step draws them from the fixed key 0, and this one from a generator
seeded 0 (the same distribution; RNG streams are not compared).

Eager PyTorch, one device a process. A step never waits for the device:
metrics stay device tensors until the one stacked fetch at the end of an
epoch (`ctseg.sync`). Under a profiler the step is the span `ctseg.step`,
its phases `ctseg.step.transform`, `.forward`, `.loss`, `.optimizer`,
`.backward`, `.allreduce` (on a mesh) and `.dice` (utils/profiling.py). Losses and metrics run in float32 under bfloat16 compute (float64
under float64), as in the JAX trainer.

Under a mesh (parallel/mesh.py; `mesh=`) each rank trains on its rows of
the global batch (`config.batch_size` is the global batch, as in the JAX
Trainer), and on a ('data', 'space') mesh a 3D trainer also on its depth
slab of each volume (the model then shards depth, models/unet.py). The
update every rank applies is the single-process update on the global batch
(parallel/distributed.py): the losses and Dice reduce over the global batch
(their GlobalBatch), the transform's and mixup's draws are the global
batch's, from a generator that is the same on every rank, and the ranks
sum their gradients. A step's metrics are the global batch's on every
rank. Only rank 0 logs and saves. The hand kernels run as without a mesh:
under data parallelism every kernel sees whole samples.
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
from ctseg_tpu_torch.parallel.collectives import (
    LOCAL,
    GlobalBatch,
    all_sum,
    depth_shard,
)
from ctseg_tpu_torch.parallel.distributed import sum_gradients
from ctseg_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    depth_slab,
    replicated,
)
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
    take_partners,
)
from ctseg_tpu_torch.training.optimizer import make_adam, set_lr
from ctseg_tpu_torch.training.schedule import (
    PlateauState,
    plateau_init,
    reduce_on_plateau,
)
from ctseg_tpu_torch.transforms.pipelines import get_transform
from ctseg_tpu_torch.transforms.volumetric import volumetric_transform
from ctseg_tpu_torch.utils.profiling import span, to_host


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


def take_rows(tree, rows: slice):
    """`rows` of every tensor of a (nested) NamedTuple of per-sample draws
    (None stays None)."""
    if tree is None:
        return None
    if torch.is_tensor(tree):
        return tree[rows]
    return type(tree)(*(take_rows(t, rows) for t in tree))


def epoch_generator(seed: int, epoch: int, device) -> torch.Generator:
    """The epoch's generator (permutation, then the steps' draws), derived
    from (seed, epoch) so a resumed run continues the sequence."""
    derived = int(np.random.SeedSequence([seed, epoch]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(derived)


class Trainer:
    def __init__(self, config: TrainConfig, device="cuda",
                 train_transform=None, test_transform=None,
                 mesh: Optional[Mesh] = None):
        self.config = config
        self.device = torch.device(device)
        self._metric_dtype = (torch.float64 if model_dtype(config) == torch.float64
                              else torch.float32)
        # A 2D config on a ('data', 'space') mesh is plain data parallelism
        # over every rank, as the JAX Trainer makes of it.
        self._spatial = (mesh is not None and mesh.n_space > 1
                         and config.spatial_dims == 3)
        if mesh is not None and mesh.n_space > 1 and not self._spatial:
            mesh = mesh.data_parallel()
        self.mesh = mesh
        self.batch = LOCAL if mesh is None else GlobalBatch(
            mesh.data, mesh.space if self._spatial else None)
        self._shard = (0, 1) if mesh is None \
            else (mesh.data_index, mesh.shape["data"])
        self.loss = MultiLoss(list(config.loss_fx),
                              exclude_missing=config.exclude_missing,
                              batch=self.batch)
        self.needs_dist_maps = "Boundary" in config.loss_fx
        self.dice = DiceMetric(batch=self.batch)
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
        model = self.place(build_model(self.config, self.device,
                                       generator=gen).train())
        return TrainState(
            step=0, model=model,
            optimizer=make_adam(model.parameters(), self.config.lr),
            plateau=plateau_init(self.config.lr, mode="max"),
        )

    def place(self, model: SegmentationModel) -> SegmentationModel:
        """The model on this trainer's mesh: rank 0's weights on every rank
        and, for a depth-sharded 3D trainer, the mesh on its UNet."""
        if self.mesh is not None:
            replicated(self.mesh, model)
            model.unet.spatial_mesh = self.mesh if self._spatial else None
        return model

    @property
    def is_main(self) -> bool:
        """Whether this process logs and saves (rank 0, or no mesh)."""
        return self.mesh is None or self.mesh.rank == 0

    def shard_batch(self, batch):
        """This rank's part of a global batch: its rows and, depth-sharded,
        its depth slab of every volume-shaped tensor (rank >= 4; per-sample
        rows such as indicators keep their width)."""
        if self.mesh is None:
            return batch
        return self._slabs(batch_sharding(self.mesh, tuple(batch)))

    def _pipeline_kw(self) -> Dict:
        """On a mesh, a pipeline yields this rank's rows of each batch."""
        return {} if self.mesh is None else {"shard": self._shard}

    def _slabs(self, rows):
        if not self._spatial:
            return rows
        return tuple(depth_slab(self.mesh, t, 3) if t.ndim >= 4 else t
                     for t in rows)

    # ------------------------------------------------------------------ steps
    def _logits(self, model, images):
        """images (N, *spatial, C) -> logits (N, classes, *spatial)."""
        x = channels_last(images.movedim(-1, 1))
        return model(x).to(self._metric_dtype)

    def _dist_maps(self, labels):
        """Signed distance maps of the labels (data, no gradient) when a
        Boundary loss wants them; depth-sharded, the slab of the whole
        volume's maps."""
        if not self.needs_dist_maps:
            return None
        shard = depth_shard(self.mesh) if self._spatial else None
        if shard is None:
            return signed_distance_maps_from_labels(labels)
        return shard.slab(signed_distance_maps_from_labels(
            shard.gather(labels)))

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
        """The train transform's draws for a raw batch (None for a
        transform without a `draw` attribute): on a mesh, this rank's rows
        of the global batch's draws."""
        draw = getattr(self.train_transform, "draw", None)
        if draw is None:
            return None
        return self._rows_of_draws(draw, generator, images_raw)

    def _global(self, values: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """The ranks' loss shares summed into the global batch's losses (one
        all_reduce)."""
        if self.mesh is None:
            return values
        names = list(values)
        total = all_sum(torch.stack([values[k].detach() for k in names]),
                        self.mesh.world)
        return dict(zip(names, total.unbind()))

    def test_inputs(self, images_raw, labels_raw, draws=None):
        """The test transform of a raw batch, with fixed draws where it
        takes draws (see the module's docstring)."""
        draw = getattr(self.test_transform, "draw", None)
        if draw is None:
            return self.test_transform(images_raw, labels_raw)
        if draws is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
            draws = self._rows_of_draws(draw, gen, images_raw)
        return self.test_transform(images_raw, labels_raw, draws)

    def _rows_of_draws(self, draw, generator, images_raw):
        """`draw`'s draws for the global batch of which `images_raw` holds
        this rank's rows (all of it without a mesh), this rank's rows."""
        index, parts = self._shard
        n = images_raw.shape[0]
        draws = draw(generator, (n * parts,) + tuple(images_raw.shape[1:]),
                     self.device)
        return take_rows(draws, slice(index * n, (index + 1) * n))

    def train_step(self, state: TrainState, batch,
                   draws=None,
                   generator: Optional[torch.Generator] = None,
                   mixup_draws: Optional[Tuple[torch.Tensor, torch.Tensor]]
                   = None) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One step on a raw batch (images (N, *spatial) HU, labels
        (N, *spatial), indicators (N, 9)); the augmentation `draws` (the
        degree's NamedTuple in 2D, the volumetric transform's in 3D) and,
        under mixup, the partner index and lambda `mixup_draws` are drawn
        from `generator` unless given. Updates `state` in place and returns
        it. On a mesh `batch` and `draws` are this rank's rows (and depth
        slab), and `mixup_draws` are the global batch's."""
        with span("ctseg.step", {"step": state.step}):
            return self._train_step(state, batch, draws, generator,
                                    mixup_draws)

    def _train_step(self, state, batch, draws, generator, mixup_draws):
        images_raw, labels_raw, indicators = batch
        with span("ctseg.step.transform"):
            if draws is None:
                draws = self.draw(generator, images_raw)
            images, labels = self.train_transform(images_raw, labels_raw,
                                                  draws)

        model = state.model.train()
        set_lr(state.optimizer, state.plateau.lr)
        if self.config.mixup:
            with span("ctseg.step.forward"):
                if mixup_draws is None:
                    mixup_draws = draw_mixup(
                        generator, mixup_probability(labels, self.batch),
                        self.config.mixup_alpha)
                index, lam = mixup_draws
                lam = lam.to(self._metric_dtype)  # a device scalar: no wait
                images = images.to(self._metric_dtype)
                images_b, labels_b, indicators_b = take_partners(
                    index, self.batch, images, labels, indicators)
                logits = self._logits(model,
                                      mixup_tensors(images, images_b, lam))
            with span("ctseg.step.loss"):
                # The maps come from the unmixed labels, once; the
                # partner's are a gather (reference mixup_trainer.py:94-128).
                # On a mesh a partner may live on another rank: its maps are
                # made here from its labels (per sample, so the same maps).
                dist_maps = self._dist_maps(labels)
                values_a = self.loss(logits, labels, indicators, dist_maps)
                dist_b = None
                if dist_maps is not None:
                    dist_b = (dist_maps[index] if self.mesh is None
                              else self._dist_maps(labels_b))
                values_b = self.loss(logits, labels_b, indicators_b, dist_b)
                values = {name: mixup_tensors(values_a[name], values_b[name],
                                              lam)
                          for name in values_a}
                total = self.loss.total(values)
        else:
            with span("ctseg.step.forward"):
                logits = self._logits(model, images)
            with span("ctseg.step.loss"):
                values = self.loss(logits, labels, indicators,
                                   self._dist_maps(labels))
                total = self.loss.total(values)
        with span("ctseg.step.optimizer"):
            state.optimizer.zero_grad(set_to_none=True)
        with span("ctseg.step.backward"):
            total.backward()
        if self.mesh is not None:
            with span("ctseg.step.allreduce"):
                sum_gradients(model.parameters(), self.mesh.world)
        with span("ctseg.step.optimizer"):
            state.optimizer.step()

        with span("ctseg.step.dice"), torch.no_grad():
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
        losses = {**values, "total": total}
        if self.mesh is not None:
            with span("ctseg.step.allreduce"):
                losses = self._global(losses)
        metrics = {f"loss/{k}": v.detach() for k, v in losses.items()}
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
            self._predictions(logits, indicators), labels, batch=self.batch
        )
        dice_per_class, _ = masked_mean_batch(
            dice, valid & row_valid[:, None], self.batch)
        metrics = {f"loss/{k}": v for k, v in self._global(values).items()}
        metrics["dice/mean"] = torch.mean(dice_per_class)
        for s, v in zip(STRUCTURES, dice_per_class):
            metrics[f"dice/{s}"] = v
        return metrics, self.batch.rows(torch.sum(row_valid.to(torch.float32)))

    # ------------------------------------------------------------------ loops
    @staticmethod
    def _fetch(values: Dict) -> Dict[str, float]:
        """Device scalars (and plain floats) as floats, with one
        device-to-host copy for all the tensors."""
        names = [k for k, v in values.items() if torch.is_tensor(v)]
        out = {k: float(v) for k, v in values.items() if not torch.is_tensor(v)}
        if names:
            fetched = torch.stack([values[k].double() for k in names])
            out.update(zip(names, to_host(fetched).tolist()))
        return out

    def train_epoch(self, state: TrainState, pipeline,
                    generator: Optional[torch.Generator] = None,
                    logger: Optional[MetricLogger] = None):
        """One epoch, shuffled and augmented from `generator`."""
        sums: Dict = {}
        count = 0
        for batch in pipeline.epoch(generator, **self._pipeline_kw()):
            state, metrics = self.train_step(state, self._slabs(batch),
                                             generator=generator)
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
        for batch in pipeline.padded_epoch(None, **self._pipeline_kw()):
            metrics, n_valid = self.eval_step(model, self._slabs(batch))
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
            checkpoint_path=None, checkpoint_every: int = 0,
            callbacks: Optional[list] = None) -> TrainState:
        """Train up to `epochs` in total (a restored state resumes at the
        epoch its step count gives); the plateau follows val/dice/mean.
        `checkpoint_every` > 0 saves to `checkpoint_path` every that many
        epochs, asynchronously (checkpoint.AsyncCheckpointer: the loop does
        not wait for the copy to the host or the file). Each of `callbacks`
        is called as cb(trainer, state, epoch) after every epoch.

        SIGTERM finishes the current epoch, waits for a save in flight
        (a failure of an earlier async save is reported and passed over:
        the synchronous save that follows is the last chance to keep the
        progress), saves to `checkpoint_path` and raises `Preempted`
        carrying the state."""
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
        if not self.is_main:
            logger, checkpoint_path, callbacks = None, None, None
        async_ckpt = ckpt.AsyncCheckpointer() if checkpoint_path else None
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
                if self._any_rank(preempted["flag"]):
                    if checkpoint_path:
                        try:
                            async_ckpt.wait()
                        except RuntimeError as e:
                            print(f"ignoring an earlier async save's "
                                  f"failure: {e!r} from {e.__cause__!r}")
                        self.save(checkpoint_path, state)
                    if logger is not None:
                        logger.log({"preempted_at_epoch": epoch},
                                   step=state.step)
                    raise Preempted(state, epoch)
                if checkpoint_path and checkpoint_every \
                        and (epoch + 1) % checkpoint_every == 0:
                    async_ckpt.save(checkpoint_path, self.config, state)
                for cb in callbacks or ():
                    cb(self, state, epoch)
        finally:
            # The handler is restored even if the wait below raises.
            try:
                if installed:
                    signal.signal(signal.SIGTERM, prev_handler
                                  if prev_handler is not None
                                  else signal.SIG_DFL)
            finally:
                if async_ckpt is not None:
                    async_ckpt.wait()
        return state

    def _any_rank(self, flag: bool) -> bool:
        """Whether `flag` holds on any rank (a SIGTERM reaches the ranks at
        different times; they must stop at the same epoch)."""
        if self.mesh is None:
            return flag
        t = torch.tensor([int(flag)], device=self.device)
        return bool(to_host(all_sum(t, self.mesh.world)).item())

    # ------------------------------------------------------------ checkpoints
    def save(self, path, state: TrainState) -> None:
        if self.is_main:
            ckpt.save(path, self.config, state)

    @classmethod
    def restore(cls, path, device="cuda", mesh: Optional[Mesh] = None
                ) -> Tuple["Trainer", TrainState]:
        """(trainer, state) from a training checkpoint, or from any port or
        reference checkpoint with a fresh optimizer and plateau; on `mesh`
        every rank reads the file and holds rank 0's weights."""
        config, state = ckpt.load(path, device)
        trainer = cls(config, device, mesh=mesh)
        trainer.place(state.model)
        return trainer, state
