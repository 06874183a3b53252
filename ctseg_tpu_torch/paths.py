"""Environment-based path configuration (a copy of ctseg_tpu/paths.py,
pinned equal by tests/test_torch_port_imports.py).

Mirrors the capability of the reference's capstone/paths.py:22-49 (repo-root
storage locally, `$BEEGFS` on the NYU cluster) with a generic env override:
set `CTSEG_DATA_STORAGE` to relocate all datasets/checkpoints.
"""

import os
from pathlib import Path

REPOSITORY_ROOT = Path(__file__).resolve().parent.parent


def is_cluster() -> bool:
    """True when running inside a managed cluster environment."""
    return os.environ.get("CLUSTER", "") != "" or os.environ.get("BEEGFS", "") != ""


def _default_storage() -> Path:
    env = os.environ.get("CTSEG_DATA_STORAGE")
    if env:
        return Path(env)
    beegfs = os.environ.get("BEEGFS")
    if beegfs:
        return Path(beegfs) / "CT-image-segmentation" / "storage"
    return REPOSITORY_ROOT / "storage"


DEFAULT_DATA_STORAGE = _default_storage()

# Published reference checkpoints (reference capstone/paths.py:46-49). Kept as
# documentation; this framework trains and serializes its own checkpoints.
TRAINED_MODELS = {
    "large": "https://github.com/MrinalJain17/CT-image-segmentation/releases/download/trained-models/model_large.ckpt",
    "mixup": "https://github.com/MrinalJain17/CT-image-segmentation/releases/download/trained-models/model_mixup.ckpt",
}
