"""Training callbacks: periodic example-overlay logging (port of
ctseg_tpu/training/callbacks.py).

Capability parity with the reference's ExamplesLoggingCallback
(capstone/training/callbacks.py:9-105): every `every_n_epochs` epochs, run
the model on a fixed random subset of validation samples and write
prediction/ground-truth overlay panels: `.npy` arrays always, PNG files
where matplotlib imports, and, when a W&B run is active, semantic
segmentation images with per-class mask layers and class labels
({0: "Void", 1..9: STRUCTURES}).
"""

from pathlib import Path

import numpy as np
import torch

from ctseg_tpu_torch.constants import STRUCTURES
from ctseg_tpu_torch.utils.visualize import overlay_labels

# {0: "Void", 1: "BrainStem", ...}: capstone/training/callbacks.py:84-85.
CLASS_LABELS = {0: "Void", **{i + 1: s for i, s in enumerate(STRUCTURES)}}


class ExamplesLoggingCallback:
    def __init__(self, dataset, out_dir, every_n_epochs: int = 25,
                 max_examples: int = 8, seed: int = 12342):
        self.dataset = dataset
        self.out_dir = Path(out_dir)
        self.every = every_n_epochs
        rng = np.random.default_rng(seed)
        n = min(max_examples, len(dataset))
        self.indices = rng.choice(len(dataset), size=n, replace=False)

    def __call__(self, trainer, state, epoch: int) -> None:
        if (epoch + 1) % self.every != 0:
            return
        out = self.out_dir / f"epoch_{epoch + 1:04d}"
        out.mkdir(parents=True, exist_ok=True)

        device = trainer.device
        images = torch.as_tensor(self.dataset.images[self.indices],
                                 dtype=torch.float32, device=device)
        labels = torch.as_tensor(self.dataset.labels[self.indices],
                                 dtype=torch.int32, device=device)
        indicators = torch.as_tensor(self.dataset.indicators[self.indices],
                                     dtype=torch.float32, device=device)
        model = state.model
        was_training = model.training
        with torch.no_grad():
            img_t, lab_t = trainer.test_inputs(images, labels)
            # With exclude_missing, the logits of structures absent from
            # the annotation are zeroed before the argmax (the reference's
            # display path, capstone/training/callbacks.py:70-75).
            preds = trainer._predictions(
                trainer._logits(model.eval(), img_t), indicators)
        model.train(was_training)
        preds = preds.cpu().numpy()
        img_np = img_t.float().cpu().numpy()
        lab_np = lab_t.cpu().numpy()

        for j, idx in enumerate(self.indices):
            base = img_np[j, ..., 0]
            base01 = (base - base.min()) / max(base.max() - base.min(), 1e-8)
            panel = np.concatenate(
                [
                    np.repeat(base01[..., None], 3, -1),
                    overlay_labels(base01, preds[j]),
                    overlay_labels(base01, lab_np[j]),
                ],
                axis=1,
            )
            name = self.dataset.names[idx]
            np.save(out / f"{name}.npy", panel)
            self._to_wandb(name, base01, preds[j], lab_np[j], panel,
                           state.step)
            self._to_png(out / f"{name}.png", name, panel)

    @staticmethod
    def _to_wandb(name, base01, pred, label, panel, step) -> None:
        try:
            import wandb
        except ImportError:
            return
        if wandb.run is None:
            return
        semantic = wandb.Image(
            np.repeat(base01[..., None], 3, -1),
            masks={
                "predictions": {"mask_data": pred,
                                "class_labels": CLASS_LABELS},
                "ground_truth": {"mask_data": label,
                                 "class_labels": CLASS_LABELS},
            },
        )
        wandb.log({f"examples/{name}": semantic,
                   f"examples/{name}_panel": wandb.Image(panel)}, step=step)

    @staticmethod
    def _to_png(path, name, panel) -> None:
        try:
            import matplotlib
        except ImportError:
            return
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(12, 4))
        ax.imshow(panel)
        ax.set_title(f"{name}: input | prediction | ground truth")
        ax.axis("off")
        fig.savefig(path, dpi=80, bbox_inches="tight")
        plt.close(fig)
