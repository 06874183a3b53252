"""Metric logging: JSONL on disk, stdout, optional Weights & Biases (port of
ctseg_tpu/training/logging.py).

wandb is used only when requested and importable, as the reference's
`--use_wandb`.
"""

import json
import sys
import time
from pathlib import Path
from typing import Dict, Optional, Union


class MetricLogger:
    def __init__(
        self,
        log_dir: Optional[Union[str, Path]] = None,
        use_wandb: bool = False,
        project: str = "ct-image-segmentation",
        experiment_name: str = "UNet 2D",
        config: Optional[Dict] = None,
        stdout: bool = True,
    ):
        self.stdout = stdout
        self._file = None
        if log_dir is not None:
            log_dir = Path(log_dir)
            log_dir.mkdir(parents=True, exist_ok=True)
            self._file = open(log_dir / "metrics.jsonl", "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb.init(
                    project=project, name=experiment_name, config=config or {}
                )
            except ImportError:
                print("wandb not installed; logging locally only")

    def log(self, metrics: Dict[str, float], step: int) -> None:
        record = {"step": step, "time": time.time()}
        record.update({k: float(v) for k, v in metrics.items()})
        if self._file is not None:
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)
        if self.stdout:
            parts = ", ".join(
                f"{k}={float(v):.4f}" for k, v in sorted(metrics.items())
            )
            print(f"[step {step}] {parts}", file=sys.stderr)

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
        if self._wandb is not None:
            self._wandb.finish()
