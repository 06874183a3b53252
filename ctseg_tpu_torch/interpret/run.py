"""Interpretability run (port of ctseg_tpu/interpret/run.py; the
reference's capstone/interpretability.py).

Loads a checkpoint (a port checkpoint, a reference Lightning .ckpt, or a
released one by name), walks the test split, keeps the samples with at
least `min_structures` annotated structures (interpretability.py:76-78),
and writes per sample the prediction and the 9 structures' GradCAM maps:
.npy always, an overlay PNG when matplotlib imports, and an upload to an
active W&B run (`--use_wandb`), falling back to disk on any upload error.

Samples run in batches: one test transform, one forward and 9 backward
passes per batch (interpret/gradcam.py), the predictions taken from the
same forward's logits. The last batch is simply shorter (the JAX script
pads it for its jit cache); each sample's artifacts are the same.

Usage:
    python -m ctseg_tpu_torch.interpret.run --checkpoint CKPT [--data_dir DIR]
        [--out_dir DIR] [--max_samples 20] [--layer feat_down1] [--device cuda]
"""

from argparse import ArgumentParser
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from ctseg_tpu_torch.constants import NUM_STRUCTURES, STRUCTURES
from ctseg_tpu_torch.data.datasets import PackedDataset2D
from ctseg_tpu_torch.interpret.gradcam import class_activation_maps
from ctseg_tpu_torch.models.layers import channels_last
from ctseg_tpu_torch.models.released import (
    add_released_args,
    resolve_checkpoint_arg,
)
from ctseg_tpu_torch.ops.masks import squash_predictions
from ctseg_tpu_torch.paths import DEFAULT_DATA_STORAGE
from ctseg_tpu_torch.training.config import (
    TrainConfig,
    load_checkpoint,
    model_dtype,
)
from ctseg_tpu_torch.transforms.pipelines import get_transform


def _write_sample(out_dir: Path, name: str, img0: np.ndarray,
                  preds: np.ndarray, cams: np.ndarray) -> None:
    """Artifacts for ONE sample: .npy always, overlay PNG when possible,
    and — reference parity (interpretability.py:34-48 logs overlays to a
    W&B project) — upload to an ACTIVE wandb run if one exists."""
    np.save(out_dir / f"{name}_gradcam.npy", cams)
    np.save(out_dir / f"{name}_pred.npy", preds)
    # Upload failures must degrade to disk-only artifacts, matching the
    # CLI's init-failure contract: a transient CommError (or any payload
    # serialization error) on sample k must not abort the remaining
    # samples' .npy/PNG writes. Hence Exception, not just ImportError.
    try:
        import wandb

        if wandb.run is not None:
            base01 = (img0 - img0.min()) / max(
                float(img0.max() - img0.min()), 1e-8
            )
            semantic = wandb.Image(
                np.repeat(base01[..., None], 3, -1),
                masks={
                    "predictions": {
                        "mask_data": preds,
                        "class_labels": {
                            i + 1: s for i, s in enumerate(STRUCTURES)
                        },
                    }
                },
            )
            wandb.log(
                {
                    f"interpret/{name}": semantic,
                    **{
                        f"interpret/{name}_cam_{s}": wandb.Image(cams[s_idx])
                        for s_idx, s in enumerate(STRUCTURES)
                    },
                }
            )
    except Exception as e:
        if not isinstance(e, ImportError):
            print(f"wandb upload failed for {name} ({e!r}); disk-only")
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    fig, axes = plt.subplots(2, 5, figsize=(20, 8))
    axes = axes.ravel()
    axes[0].imshow(img0, cmap="gray")
    axes[0].set_title(f"{name} (pred overlay)")
    axes[0].imshow(preds, alpha=0.4, cmap="tab10", vmin=0, vmax=9)
    for s_idx, s in enumerate(STRUCTURES):
        ax = axes[s_idx + 1]
        ax.imshow(img0, cmap="gray")
        ax.imshow(cams[s_idx], alpha=0.5, cmap="jet")
        ax.set_title(s)
        ax.axis("off")
    fig.savefig(out_dir / f"{name}_gradcam.png", dpi=80)
    plt.close(fig)


def run_interpretability(config: TrainConfig, model: torch.nn.Module,
                         dataset: PackedDataset2D, out_dir: Path,
                         max_samples: int = 20, min_structures: int = 5,
                         layer: str = "feat_down1", batch_size: int = 8) -> int:
    """Batched, on the model's device: per batch the test transform,
    one forward and the 9 structures' GradCAM. Returns the samples done."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    device = next(model.parameters()).device
    transform = get_transform(config.transform_degree, train=False,
                              size=(config.input_size,) * 2)
    keep = [
        i for i in range(len(dataset))
        if dataset.indicators[i].sum() >= min_structures
    ][:max_samples]
    done = 0
    for lo in range(0, len(keep), batch_size):
        idxs = keep[lo : lo + batch_size]
        raw = torch.from_numpy(
            np.stack([dataset.images[i] for i in idxs]).astype(np.float32)
        ).to(device)
        img, _ = transform(raw)  # (B, S, S, C)
        x = channels_last(img.to(model_dtype(config)).permute(0, 3, 1, 2))
        cams, logits = class_activation_maps(
            model, x, range(1, NUM_STRUCTURES + 1), layer)
        preds = squash_predictions(logits, dim=1).to(torch.int32)
        img = img[..., 0].cpu().numpy()
        preds = preds.cpu().numpy()
        cams = cams.movedim(0, 1).cpu().numpy()  # (B, 9, S, S)
        for j, i in enumerate(idxs):
            _write_sample(out_dir, dataset.names[i], img[j], preds[j], cams[j])
            done += 1
    return done


def main(argv: Optional[Sequence[str]] = None):
    parser = ArgumentParser()
    parser.add_argument(
        "--checkpoint",
        type=str,
        default=None,
        help="a port checkpoint or a reference Lightning .ckpt file",
    )
    add_released_args(parser)
    parser.add_argument("--data_dir", type=str, default=None)
    parser.add_argument("--out_dir", type=str, default="interpretability")
    parser.add_argument("--max_samples", type=int, default=20)
    parser.add_argument("--min_structures", type=int, default=5)
    parser.add_argument("--layer", type=str, default="feat_down1")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument(
        "--use_wandb", action="store_true", default=False,
        help="upload overlays/heatmaps to a W&B run (reference "
        "interpretability.py:34-48)",
    )
    parser.add_argument("--experiment_name", type=str, default="interpret")
    args = parser.parse_args(argv)

    wandb_run = None
    if args.use_wandb:
        # Any init failure degrades to disk-only artifacts: not just a
        # missing package, but also offline/unauthenticated environments
        # (wandb raises CommError/UsageError there, not ImportError).
        try:
            import wandb

            wandb_run = wandb.init(
                project="ct-image-segmentation", name=args.experiment_name
            )
        except Exception as e:
            print(f"wandb unavailable ({e!r}); writing artifacts to disk only")

    config, model = load_checkpoint(resolve_checkpoint_arg(args), args.device)
    data_dir = Path(args.data_dir or (Path(DEFAULT_DATA_STORAGE) / "miccai_2d"))
    dataset = PackedDataset2D.load(data_dir / "test_packed.npz")
    try:
        done = run_interpretability(
            config, model, dataset, Path(args.out_dir),
            max_samples=args.max_samples, min_structures=args.min_structures,
            layer=args.layer, batch_size=args.batch_size,
        )
    finally:
        if wandb_run is not None:
            wandb_run.finish()  # flush uploads even on mid-run failure
    print(f"wrote interpretability artifacts for {done} samples to {args.out_dir}")


if __name__ == "__main__":
    main()
