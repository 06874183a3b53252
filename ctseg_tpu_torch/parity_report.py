"""Dice-parity report of the port (port of the repository's root
parity_report.py, the target of `python -m ctseg_tpu_torch parity`): train
Model L and Model M, or evaluate given or released checkpoints, and compare
the per-organ test Dice with the reference's published table (Report.pdf
Table 2, BASELINE.md) under the +-0.005 parity verdict.

The recipe is the reference's: the preset's 200 epochs, Adam lr 1e-3,
batch 128, degree-2 augmentation, exclude-missing masking, the final models
trained on train+valid (capstone/training/base_trainer.py:225-246,
mixup_trainer.py:131-190), then `evaluate_2d` on the whole test split
(dataset-level Dice, every slice).

    python -m ctseg_tpu_torch parity --data_dir DIR       # full recipe
    python -m ctseg_tpu_torch parity --synthetic --max_epochs 2
    python -m ctseg_tpu_torch parity --checkpoint model.ckpt --models model_l
    python -m ctseg_tpu_torch parity --from_released model_l model_m \
        --released_source DIR

`REFERENCE_DICE`, `REFERENCE_MEAN`, `PARITY_TOLERANCE` and
`comparison_table` are the root script's, pinned equal by
tests/test_torch_front_door.py. Launched by torchrun over N cards, it
trains and evaluates data-parallel over every rank, as the root script does
over every device (the batch rounded to a multiple of the ranks); rank 0
writes the report:

    torchrun --nproc_per_node N -m ctseg_tpu_torch parity --data_dir DIR
"""

import argparse
import dataclasses
import json
from pathlib import Path

from ctseg_tpu_torch.models.released import RELEASED_FILES, resolve_released

# Reference test-set Dice (%), Report.pdf Table 2 (see BASELINE.md).
REFERENCE_DICE = {
    "model_l": {
        "BrainStem": 86.37, "Chiasm": 57.52, "Mandible": 84.61,
        "OpticNerve_L": 66.00, "OpticNerve_R": 63.49, "Parotid_L": 80.33,
        "Parotid_R": 78.90, "Submandibular_L": 66.60,
        "Submandibular_R": 63.97,
    },
    "model_m": {
        "BrainStem": 85.53, "Chiasm": 55.05, "Mandible": 83.79,
        "OpticNerve_L": 65.87, "OpticNerve_R": 64.07, "Parotid_L": 80.24,
        "Parotid_R": 79.81, "Submandibular_L": 70.81,
        "Submandibular_R": 64.31,
    },
}
REFERENCE_MEAN = {"model_l": 71.98, "model_m": 72.16}
PARITY_TOLERANCE = 0.005  # absolute Dice (fraction), BASELINE.json


def run_model(name, data_dir, args):
    """Train the preset `name` on train+valid, save it, and evaluate it on
    the whole test split."""
    from ctseg_tpu_torch.data.datasets import PackedDataset2D
    from ctseg_tpu_torch.data.pipeline import DevicePipeline2D
    from ctseg_tpu_torch.models.presets import PRESETS
    from ctseg_tpu_torch.training.logging import MetricLogger
    from ctseg_tpu_torch.training.trainer import Trainer

    train = PackedDataset2D.load(data_dir / "train_packed.npz")
    valid = PackedDataset2D.load(data_dir / "valid_packed.npz")
    test = PackedDataset2D.load(data_dir / "test_packed.npz")
    # Final models train on train+valid (reference FullMiccaiDataModule2D,
    # capstone/data/data_module.py:74-88).
    full = PackedDataset2D.concatenate(train, valid)

    config = PRESETS[name]
    overrides = dict(
        epochs=args.max_epochs or config.epochs,
        compute_dtype="bfloat16" if args.bf16 else config.compute_dtype,
    )
    if args.synthetic:
        overrides.update(
            filters=(8, 16, 32, 64, 128),
            batch_size=min(config.batch_size, len(full)),
            input_size=args.synthetic_input_size,
        )
    config = dataclasses.replace(config, **overrides)
    mesh, device = args.mesh, args.rank_device
    if mesh is not None:
        from ctseg_tpu_torch.training.cli import _fit_batch

        config = dataclasses.replace(config, batch_size=_fit_batch(
            config.batch_size, len(full), mesh.size))

    trainer = Trainer(config, device, mesh=mesh)
    state = trainer.init_state()
    logger = MetricLogger(log_dir=args.out_dir / name, use_wandb=False,
                          experiment_name=f"parity-{name}",
                          config=config.as_dict()) if trainer.is_main else None
    pipe = DevicePipeline2D(full, min(config.batch_size, len(full)), device)
    state = trainer.fit(state, pipe, None, logger=logger)
    trainer.save(args.out_dir / name / "model.ckpt", state)
    if logger is not None:
        logger.close()
    return _evaluate(trainer, state.model, test)


def _evaluate(trainer, model, test):
    from ctseg_tpu_torch.inference.evaluate import evaluate_2d

    result = evaluate_2d(trainer, model, test,
                         batch_size=trainer.config.batch_size,
                         mesh=trainer.mesh)
    if result["num_slices"] != len(test):
        raise RuntimeError(f"evaluated {result['num_slices']} of "
                           f"{len(test)} test slices")
    return result


def evaluate_checkpoint(ckpt_path, name, data_dir, args):
    """Evaluate a checkpoint (the port's, or a reference .ckpt) instead of
    retraining."""
    from ctseg_tpu_torch.data.datasets import PackedDataset2D
    from ctseg_tpu_torch.training.trainer import Trainer

    trainer, state = Trainer.restore(ckpt_path, args.rank_device,
                                     mesh=args.mesh)
    test = PackedDataset2D.load(data_dir / "test_packed.npz")
    return _evaluate(trainer, state.model, test)


def comparison_table(name, result):
    ref = REFERENCE_DICE[name]
    rows = [f"### {name}", "",
            "| Structure | Reference | Ours | Delta | Parity (±0.5pp) |",
            "|---|---|---|---|---|"]
    ok_all = True
    for s, ref_pct in ref.items():
        ours_pct = result["per_structure_dice"][s] * 100.0
        delta = ours_pct - ref_pct
        ok = abs(delta) <= PARITY_TOLERANCE * 100.0
        ok_all = ok_all and ok
        rows.append(
            f"| {s} | {ref_pct:.2f} | {ours_pct:.2f} | {delta:+.2f} | "
            f"{'PASS' if ok else 'FAIL'} |"
        )
    ours_mean = result["mean_dice"] * 100.0
    delta_mean = ours_mean - REFERENCE_MEAN[name]
    rows.append(
        f"| **Mean** | **{REFERENCE_MEAN[name]:.2f}** | **{ours_mean:.2f}** "
        f"| **{delta_mean:+.2f}** | **{'PASS' if ok_all else 'FAIL'}** |"
    )
    return "\n".join(rows), ok_all


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--data_dir", type=str, default=None,
                        help="directory with {train,valid,test}_packed.npz")
    parser.add_argument("--models", nargs="+", default=["model_l", "model_m"],
                        choices=["model_l", "model_m"])
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="evaluate a checkpoint (the port's or a "
                        "reference .ckpt) instead of training; applies to "
                        "the first model in --models")
    parser.add_argument("--from_released", nargs="+", default=None,
                        choices=sorted(RELEASED_FILES),
                        help="evaluate the reference's RELEASED checkpoints "
                        "for these models instead of retraining (overrides "
                        "--models; resolved via --released_source, the same "
                        "flag pair as predict/serve/evaluate/gradcam)")
    parser.add_argument("--released_source", type=str, default="github",
                        help="where the released .ckpt files live: a "
                        "directory holding model_large.ckpt/model_mixup.ckpt,"
                        " a .ckpt file, a URL prefix, or 'github' (the "
                        "release URLs; needs egress)")
    parser.add_argument("--max_epochs", type=int, default=None)
    parser.add_argument("--bf16", action="store_true", default=False)
    parser.add_argument("--synthetic", action="store_true", default=False,
                        help="small-model mode for synthetic-data smoke runs")
    parser.add_argument("--synthetic_input_size", type=int, default=64)
    parser.add_argument("--out_dir", type=str, default="parity_runs")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    args.out_dir = Path(args.out_dir)
    args.out_dir.mkdir(parents=True, exist_ok=True)
    from ctseg_tpu_torch.parallel.distributed import mesh_from_flags

    args.mesh, args.rank_device = mesh_from_flags(device=args.device)
    main_rank = args.mesh is None or args.mesh.rank == 0

    from ctseg_tpu_torch.paths import DEFAULT_DATA_STORAGE

    data_dir = Path(args.data_dir or (Path(DEFAULT_DATA_STORAGE) / "miccai_2d"))

    report = ["# Dice parity report vs Report.pdf Table 2", ""]
    if args.synthetic:
        report.append(
            "> **SYNTHETIC-DATA RUN** — verdicts are not meaningful; this "
            "mode only proves the recipe runs end-to-end. Use real packed "
            "PDDCA data for the actual parity claim.\n"
        )
    payload = {"synthetic": args.synthetic, "models": {}}
    names = args.from_released if args.from_released else args.models
    for name in names:
        if args.from_released:
            ckpt = resolve_released(args.released_source, name, args.out_dir)
            result = evaluate_checkpoint(str(ckpt), name, data_dir, args)
        elif args.checkpoint and name == args.models[0]:
            result = evaluate_checkpoint(args.checkpoint, name, data_dir, args)
        else:
            result = run_model(name, data_dir, args)
        table, ok = comparison_table(name, result)
        report.extend([table, ""])
        payload["models"][name] = {
            "result": result,
            "parity_pass": bool(ok) and not args.synthetic,
        }
        if main_rank:
            print(table)

    if not main_rank:
        return
    (args.out_dir / "parity_report.md").write_text("\n".join(report))
    (args.out_dir / "parity_report.json").write_text(
        json.dumps(payload, indent=2)
    )
    print(f"\nwritten: {args.out_dir}/parity_report.md|.json")


if __name__ == "__main__":
    main()
