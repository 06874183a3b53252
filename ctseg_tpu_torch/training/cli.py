"""Training CLI of the port (port of ctseg_tpu/training/cli.py).

    python -m ctseg_tpu_torch.training.cli train --data_dir <dir> \\
        [--device cuda --transform_degree 2 --use_res_units --exclude_missing]
    python -m ctseg_tpu_torch.training.cli train_mixup --preset model_m \\
        --data_dir <dir>
    python -m ctseg_tpu_torch.training.cli train_3d --data_dir <dir> \\
        --volumetric_mode patch --patch_size 128 128 16 --steps_per_epoch 100

reads `train_packed.npz` and `valid_packed.npz` (data/datasets.py) from
--data_dir (default $CTSEG_DATA_STORAGE/miccai_2d), trains with the
plateau LR on val/dice/mean, logs to <checkpoint_dir or logs>/metrics.jsonl
and saves <checkpoint_dir>/model.ckpt, a training checkpoint that --resume,
predict and serve all read. Flags follow the reference's trainer
(capstone/training/base_trainer.py:150-209). `train_mixup` trains with
weighted mixup (1 residual unit under --use_res_units; with the full data
it publishes `model_mixup.ckpt`). The 2D train transform is degree 2's.
`train_3d` (`run_3d`, volumetric/trainer3d.py) reads `PackedDataset3D` splits
(default $CTSEG_DATA_STORAGE/miccai_3d) and trains whole resized volumes
(`--volumetric_mode resize`, the reference's parity mode; `--preset
model_3d`) or random native-resolution patches (`patch`).
"""

import dataclasses
import warnings
from argparse import ArgumentParser
from pathlib import Path

from ctseg_tpu_torch.constants import EXPERIMENT_SEED
from ctseg_tpu_torch.data.datasets import PackedDataset2D, PackedDataset3D
from ctseg_tpu_torch.data.pipeline import DevicePipeline2D
from ctseg_tpu_torch.models.presets import PRESETS
from ctseg_tpu_torch.paths import DEFAULT_DATA_STORAGE
from ctseg_tpu_torch.training.config import TrainConfig
from ctseg_tpu_torch.training.logging import MetricLogger
from ctseg_tpu_torch.training.trainer import Preempted, Trainer
from ctseg_tpu_torch.volumetric.pipeline3d import (
    RESIZE_SHAPE,
    DevicePipeline3D,
    PatchPipeline3D,
)
from ctseg_tpu_torch.volumetric.trainer3d import DEFAULT_PATCH, make_trainer_3d


def _add_args(parser: ArgumentParser) -> None:
    parser.add_argument("--batch_size", type=int, default=128)
    parser.add_argument(
        "--transform_degree", type=int, default=2,
        help="Augmentation degree. The port trains degree 2 only, so its "
             "default is 2 where the reference's is 0.")
    parser.add_argument("--filters", nargs="+", type=int,
                        default=[64, 128, 256, 512, 1024])
    parser.add_argument("--use_res_units", action="store_true", default=False)
    parser.add_argument("--downsample", action="store_true", default=False)
    parser.add_argument("--input_size", type=int, default=None,
                        help="Train crop and test resize size (default 256).")
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--loss_fx", nargs="+", type=str,
                        default=["Focal", "Dice"])
    parser.add_argument("--exclude_missing", action="store_true", default=False)
    parser.add_argument("--use_full_data", action="store_true", default=False)
    # None = not given: 200 for a fresh run, the checkpoint's on --resume.
    parser.add_argument("--max_epochs", type=int, default=None)
    parser.add_argument("--seed", type=int, default=EXPERIMENT_SEED)
    parser.add_argument("--bf16", action="store_true", default=False)
    parser.add_argument("--data_dir", type=str, default=None)
    parser.add_argument("--checkpoint_dir", type=str, default=None)
    parser.add_argument("--use_wandb", action="store_true", default=False)
    parser.add_argument("--experiment_name", type=str, default="UNet 2D")
    parser.add_argument("--preset", type=str, default=None,
                        choices=sorted(PRESETS),
                        help="A published configuration (reference report, "
                        "Table 1); overrides the model flags.")
    parser.add_argument("--resume", type=str, default=None,
                        help="A training checkpoint file (model, optimizer, "
                        "plateau and step restore) or a reference .ckpt.")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument(
        "--resize_shape", nargs=3, type=int, default=None,
        help="train_3d: (H, W, D) volume grid (default: the reference's "
        "256 256 96).")
    parser.add_argument(
        "--volumetric_mode", type=str, default="resize",
        choices=["resize", "patch"],
        help="train_3d: 'resize' = whole volumes nearest-resized to "
        "--resize_shape (the reference's parity mode); 'patch' = random "
        "native-resolution patches with the soft-tissue window and flips.")
    parser.add_argument(
        "--patch_size", nargs=3, type=int, default=None,
        help="train_3d patch mode: (H, W, D) patch (default 128 128 48).")
    parser.add_argument(
        "--steps_per_epoch", type=int, default=None,
        help="train_3d patch mode: random-patch batches per epoch (default "
        "100; on --resume the checkpoint's schedule wins).")


def _config_from_args(args, mixup: bool) -> TrainConfig:
    dtype = "bfloat16" if args.bf16 else "float32"
    if args.preset:
        if PRESETS[args.preset].spatial_dims != 2:
            raise SystemExit(
                f"--preset {args.preset} is a 3D configuration; use the "
                "train_3d subcommand for it"
            )
        return dataclasses.replace(
            PRESETS[args.preset], epochs=args.max_epochs or 200,
            seed=args.seed, compute_dtype=dtype)
    size_kw = {"input_size": args.input_size} if args.input_size else {}
    # use_res_units: 2 subunits for the base trainer, 1 for mixup ("works
    # better for mixup", reference mixup_trainer.py:26-42).
    num_res_units = (1 if mixup else 2) if args.use_res_units else 0
    return TrainConfig(
        **size_kw,
        filters=tuple(args.filters),
        num_res_units=num_res_units,
        downsample=args.downsample,
        transform_degree=args.transform_degree,
        lr=args.lr,
        batch_size=args.batch_size,
        loss_fx=tuple(args.loss_fx),
        exclude_missing=args.exclude_missing,
        mixup=mixup,
        epochs=args.max_epochs or 200,
        seed=args.seed,
        compute_dtype=dtype,
    )


def fit_and_finalize(trainer, state, train_pipe, val_pipe, args, logger):
    """Trainer.fit to --max_epochs with a save every 25 epochs, then the
    final save to <checkpoint_dir>/model.ckpt. On SIGTERM: say how to
    resume, close the logger and return None, so that the caller skips its
    publishing tail."""
    ckpt_path = (Path(args.checkpoint_dir) / "model.ckpt"
                 if args.checkpoint_dir else None)
    try:
        state = trainer.fit(
            state, train_pipe, val_pipe, epochs=args.max_epochs,
            logger=logger, checkpoint_path=ckpt_path,
            checkpoint_every=25 if ckpt_path else 0,
        )
    except Preempted as p:
        where = (f"resume with --resume {ckpt_path}" if ckpt_path
                 else "NO checkpoint was saved (no --checkpoint_dir)")
        print(f"{p}; {where}")
        logger.close()
        return None
    if ckpt_path:
        trainer.save(ckpt_path, state)
    return state


def run_2d(args, mixup: bool) -> None:
    data_dir = Path(args.data_dir or (Path(DEFAULT_DATA_STORAGE) / "miccai_2d"))
    train = PackedDataset2D.load(data_dir / "train_packed.npz")
    valid = PackedDataset2D.load(data_dir / "valid_packed.npz")
    if args.use_full_data:
        train = PackedDataset2D.concatenate(train, valid)

    if args.resume:
        trainer, state = Trainer.restore(args.resume, args.device)
    else:
        trainer = Trainer(_config_from_args(args, mixup), args.device)
        state = trainer.init_state()
    config = trainer.config
    logger = MetricLogger(
        log_dir=args.checkpoint_dir or "logs", use_wandb=args.use_wandb,
        experiment_name=args.experiment_name, config=config.as_dict(),
    )
    train_pipe = DevicePipeline2D(
        train, min(config.batch_size, len(train)), args.device
    )
    val_pipe = None if args.use_full_data else DevicePipeline2D(
        valid, min(config.batch_size, len(valid)), args.device
    )
    state = fit_and_finalize(trainer, state, train_pipe, val_pipe, args,
                             logger)
    if state is None:  # preempted; the logger is closed
        return
    if args.use_full_data:
        # The final model and its test score (reference
        # base_trainer.py:244-246), named after the trained config: a preset
        # or a resumed checkpoint may differ from the subcommand.
        name = "model_mixup" if config.mixup else "model_large"
        out = Path(DEFAULT_DATA_STORAGE) / f"{name}.ckpt"
        trainer.save(out, state)
        test = PackedDataset2D.load(data_dir / "test_packed.npz")
        metrics = trainer.eval_epoch(
            state.model,
            DevicePipeline2D(test, min(config.batch_size, len(test)),
                             args.device),
            "test", logger, step=state.step,
        )
        print({k: round(v, 4) for k, v in metrics.items()})
    logger.close()


def run_3d(args) -> None:
    """The `train_3d` subcommand: a 3D config from the flags (or --preset
    model_3d, or the --resume checkpoint's), PackedDataset3D splits, and
    the pipeline of its mode."""
    mode = args.volumetric_mode or "resize"
    patch_size = tuple(args.patch_size or DEFAULT_PATCH)
    resize_shape = tuple(args.resize_shape or RESIZE_SHAPE)
    dtype = "bfloat16" if args.bf16 else "float32"
    if args.preset:
        preset = PRESETS[args.preset]
        if preset.spatial_dims != 3:
            raise SystemExit(
                f"--preset {args.preset} is a 2D configuration; use the "
                "train/train_mixup subcommands for it")
        config = dataclasses.replace(
            preset, epochs=args.max_epochs or preset.epochs, seed=args.seed,
            compute_dtype=dtype)
        mode = config.volumetric_mode or "resize"
        patch_size = tuple(config.input_shape)
    else:
        config = TrainConfig(
            filters=tuple(args.filters),
            num_res_units=2,
            transform_degree=0,
            lr=args.lr,
            batch_size=args.batch_size,
            loss_fx=tuple(args.loss_fx),
            exclude_missing=args.exclude_missing,
            epochs=args.max_epochs or 200,
            seed=args.seed,
            spatial_dims=3,
            input_shape=patch_size if mode == "patch" else resize_shape,
            in_channels=1,
            plateau_patience=10_000,
            compute_dtype=dtype,
            steps_per_epoch=((args.steps_per_epoch or 100)
                             if mode == "patch" else None),
        )
    # Data loads after the flags are checked, so a bad --preset fails fast.
    data_dir = Path(args.data_dir or (Path(DEFAULT_DATA_STORAGE) / "miccai_3d"))
    train = PackedDataset3D.load(data_dir / "train_packed.npz")
    valid = PackedDataset3D.load(data_dir / "valid_packed.npz")
    if args.resume:
        # The transforms follow the checkpoint's volumetric_mode.
        trainer, state = Trainer.restore(args.resume, args.device)
        mode = trainer.config.volumetric_mode or "resize"
    else:
        trainer = make_trainer_3d(config, mode=mode, patch_size=patch_size,
                                  device=args.device)
        state = trainer.init_state()
    # make_trainer_3d stamps volumetric_mode into its copy of the config:
    # log and use that one, so the record matches the checkpoint.
    config = trainer.config
    shape = tuple(config.input_shape)  # the patch or the resize grid
    logger = MetricLogger(
        log_dir=args.checkpoint_dir or "logs", use_wandb=args.use_wandb,
        experiment_name=args.experiment_name, config=config.as_dict(),
    )
    if mode == "patch":
        # The epoch schedule lives in the checkpoint (resume derives the
        # start epoch from step // steps_per_epoch): a conflicting flag on
        # resume is ignored.
        requested = args.steps_per_epoch
        steps = config.steps_per_epoch or requested or 100
        if requested and config.steps_per_epoch \
                and requested != config.steps_per_epoch:
            warnings.warn(
                f"--steps_per_epoch {requested} ignored: the checkpoint's "
                f"schedule is {config.steps_per_epoch} steps/epoch and the "
                "resume epoch is derived from it")
        train_pipe = PatchPipeline3D(train, config.batch_size, shape, steps,
                                     args.device)
        val_pipe = PatchPipeline3D(valid, config.batch_size, shape, steps,
                                   args.device)
    else:
        train_pipe = DevicePipeline3D(
            train, min(config.batch_size, len(train)), shape, args.device)
        val_pipe = DevicePipeline3D(
            valid, min(config.batch_size, len(valid)), shape, args.device)
    if fit_and_finalize(trainer, state, train_pipe, val_pipe, args,
                        logger) is not None:
        logger.close()


def main(argv=None):
    parser = ArgumentParser(description="ctseg_tpu_torch training")
    sub = parser.add_subparsers(dest="command", required=True)
    for name in ("train", "train_mixup", "train_3d"):
        _add_args(sub.add_parser(name))
    args = parser.parse_args(argv)
    if args.command == "train_3d":
        run_3d(args)
        return
    run_2d(args, mixup=args.command == "train_mixup")


if __name__ == "__main__":
    main()
