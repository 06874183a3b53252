"""Training CLI of the port (port of ctseg_tpu/training/cli.py, the 2D base
trainer).

    python -m ctseg_tpu_torch.training.cli train --data_dir <dir> \\
        --device cuda [--transform_degree 2 --use_res_units --exclude_missing]

reads `train_packed.npz` and `valid_packed.npz` (data/datasets.py) from
--data_dir (default $CTSEG_DATA_STORAGE/miccai_2d), trains with the
plateau LR on val/dice/mean, logs to <checkpoint_dir or logs>/metrics.jsonl
and saves <checkpoint_dir>/model.ckpt, a training checkpoint that --resume,
predict and serve all read. Flags follow the reference's trainer
(capstone/training/base_trainer.py:150-209). The train transform is degree
2's; `train_mixup` and `train_3d` wait for their slices.
"""

import dataclasses
from argparse import ArgumentParser
from pathlib import Path

from ctseg_tpu_torch.constants import EXPERIMENT_SEED
from ctseg_tpu_torch.data.datasets import PackedDataset2D
from ctseg_tpu_torch.data.pipeline import DevicePipeline2D
from ctseg_tpu_torch.paths import DEFAULT_DATA_STORAGE
from ctseg_tpu_torch.training.config import TrainConfig
from ctseg_tpu_torch.training.logging import MetricLogger
from ctseg_tpu_torch.training.trainer import Preempted, Trainer

# Model L (reference Report.pdf Table 1; ctseg_tpu/models/presets.py).
MODEL_L = TrainConfig(
    filters=(64, 128, 256, 512, 1024), num_res_units=2, transform_degree=2,
    lr=1e-3, batch_size=128, loss_fx=("Focal", "Dice"), exclude_missing=True,
    epochs=200,
)


def _add_args(parser: ArgumentParser) -> None:
    parser.add_argument("--batch_size", type=int, default=128)
    parser.add_argument("--transform_degree", type=int, default=2,
                        help="Augmentation degree; the port trains degree 2.")
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
                        choices=["model_l"],
                        help="Model L's published configuration; overrides "
                        "the model flags.")
    parser.add_argument("--resume", type=str, default=None,
                        help="A training checkpoint file (model, optimizer, "
                        "plateau and step restore) or a reference .ckpt.")
    parser.add_argument("--device", type=str, default="cuda")


def _config_from_args(args) -> TrainConfig:
    dtype = "bfloat16" if args.bf16 else "float32"
    if args.preset:
        return dataclasses.replace(MODEL_L, epochs=args.max_epochs or 200,
                                   seed=args.seed, compute_dtype=dtype)
    size_kw = {"input_size": args.input_size} if args.input_size else {}
    return TrainConfig(
        **size_kw,
        filters=tuple(args.filters),
        num_res_units=2 if args.use_res_units else 0,
        downsample=args.downsample,
        transform_degree=args.transform_degree,
        lr=args.lr,
        batch_size=args.batch_size,
        loss_fx=tuple(args.loss_fx),
        exclude_missing=args.exclude_missing,
        epochs=args.max_epochs or 200,
        seed=args.seed,
        compute_dtype=dtype,
    )


def run_2d(args) -> None:
    data_dir = Path(args.data_dir or (Path(DEFAULT_DATA_STORAGE) / "miccai_2d"))
    train = PackedDataset2D.load(data_dir / "train_packed.npz")
    valid = PackedDataset2D.load(data_dir / "valid_packed.npz")
    if args.use_full_data:
        train = PackedDataset2D.concatenate(train, valid)

    if args.resume:
        trainer, state = Trainer.restore(args.resume, args.device)
    else:
        trainer = Trainer(_config_from_args(args), args.device)
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
        return
    if ckpt_path:
        trainer.save(ckpt_path, state)
    if args.use_full_data:
        # The final model and its test score (reference base_trainer.py:244-246).
        out = Path(DEFAULT_DATA_STORAGE) / "model_large.ckpt"
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


def main(argv=None):
    parser = ArgumentParser(description="ctseg_tpu_torch training")
    sub = parser.add_subparsers(dest="command", required=True)
    for name in ("train", "train_mixup", "train_3d"):
        _add_args(sub.add_parser(name))
    args = parser.parse_args(argv)
    if args.command == "train_mixup":
        raise NotImplementedError(
            "mixup training waits for the Model M slice (ROADMAP.md, modules "
            "to port: Model M)"
        )
    if args.command == "train_3d":
        raise NotImplementedError(
            "3D training waits for the port's 3D slice (ROADMAP.md, modules "
            "to port: 3D)"
        )
    run_2d(args)


if __name__ == "__main__":
    main()
