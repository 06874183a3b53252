"""ctseg_tpu_torch — the PyTorch + CUDA port of ctseg_tpu for NVIDIA Hopper.

A second package beside the JAX one, with ctseg_tpu's module layout and
names so each counterpart is easy to find. It imports torch and numpy and
never JAX or `ctseg_tpu`; the JAX package is the reference its tests hold it
against (tests/test_torch_port_*.py).

Ported: the 2D and 3D serving, training and evaluation paths, and the
reference's default 2D workflow from raw patient directories (data
preparation, every train transform degree, the train CLI at degree 0).
The hand-written CUDA kernels (csrc/) are the InstanceNorm+PReLU sites
forward and backward, the stride-1 conv3x3+InstanceNorm+PReLU units forward
and their norm backward, the degree-2 transform, and the exact EDT's
min-plus pass with its row scan and signed map; on a CPU tensor each runs
its plain PyTorch version instead.

Layout:
  constants.py  copy of ctseg_tpu.constants (paths.py: of ctseg_tpu.paths)
  utils/        NRRD IO, PDDCA volumes and patients, visualization (copies),
                profiling
  testing/      synthetic PDDCA patients
  data/         the split, conversion, packing and statistics CLIs
                (copies), packed datasets (a copy), the device pipeline
  transforms/   HU windowing, resize, the test and train transforms
  ops/          argmax, EDT, the kernels' wrappers and their nvcc loader
  csrc/         CUDA C++ sources of the kernels (sm_90a)
  models/       MONAI-layout 2D/3D UNet, presets, JAX parameter converter
  losses/       the segmentation losses
  metrics/      Dice, HD95
  training/     TrainConfig, Trainer, Adam, plateau, mixup, checkpoints,
                callbacks, CLI
  volumetric/   the 3D pipelines and trainer
  inference/    predict, serve, sliding windows, evaluation
"""

__version__ = "0.1.0"
