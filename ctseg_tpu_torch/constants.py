"""Canonical constants shared across the framework.

A copy of ctseg_tpu/constants.py: the PyTorch port never imports the JAX
package, so it carries its own copies of the host-side modules it needs
(tests/test_torch_port_imports.py pins the two copies equal).

The structure list order is load-bearing everywhere (class ids 1..9),
mirroring the reference contract (reference capstone/utils/miccai.py:13-24).
All derived statistics below were published in the reference's notebooks and
baked into its source; we adopt the same values for output parity:
  - WINDOWING_CONFIG:   reference capstone/transforms/transforms_2d.py:6
  - STACKED_WINDOW_MEAN/STD: reference capstone/transforms/predefined.py:5
  - CLASS_WEIGHT:       reference capstone/models/losses.py:10-21
  - ANNOTATION_COUNT:   reference capstone/training/utils.py:10
  - CROP_* boundaries:  reference capstone/utils/miccai.py:193-197
"""

from typing import Dict, List, Tuple

STRUCTURES: List[str] = [
    "BrainStem",
    "Chiasm",
    "Mandible",
    "OpticNerve_L",
    "OpticNerve_R",
    "Parotid_L",
    "Parotid_R",
    "Submandibular_L",
    "Submandibular_R",
]

NUM_STRUCTURES = len(STRUCTURES)
NUM_CLASSES = NUM_STRUCTURES + 1  # + background (class 0)

# (window_width, window_level) in Hounsfield units.
WINDOWING_CONFIG: Dict[str, Tuple[int, int]] = {
    "brain": (80, 40),
    "soft_tissue": (350, 20),
    "bone": (2800, 600),
}
WINDOW_ORDER = ("brain", "soft_tissue", "bone")

# Per-channel stats of the 3 stacked windows over the training set.
STACKED_WINDOW_MEAN = (0.107, 0.135, 0.085)
STACKED_WINDOW_STD = (0.271, 0.267, 0.152)

# Inverse pixel-frequency class weights (background effectively unweighted).
CLASS_WEIGHT: Dict[str, float] = {
    "Background": 1e-10,
    "BrainStem": 0.007,
    "Chiasm": 0.3296,
    "Mandible": 0.0046,
    "OpticNerve_L": 0.2619,
    "OpticNerve_R": 0.3035,
    "Parotid_L": 0.0068,
    "Parotid_R": 0.0065,
    "Submandibular_L": 0.0374,
    "Submandibular_R": 0.0426,
}

# Number of annotated training slices per structure.
ANNOTATION_COUNT = (601, 44, 601, 94, 88, 535, 549, 280, 253)

# Empirically derived anatomical crop box (fractions for z).
CROP_BOUNDARY_X = (120, 400)
CROP_BOUNDARY_Y = (55, 335)
CROP_BOUNDARY_Z = (0.32, 0.99)

# Seeds used by the reference (download split / experiments).
SPLIT_SEED = 42
EXPERIMENT_SEED = 12342
