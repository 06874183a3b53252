"""ctseg_tpu_torch — the PyTorch + CUDA port of ctseg_tpu for NVIDIA Hopper.

A second package beside the JAX one, with ctseg_tpu's module layout and
names so each counterpart is easy to find. It imports torch and numpy and
never JAX or `ctseg_tpu`; the JAX package is the reference its tests hold it
against (tests/test_torch_port_*.py).

Two slices are ported: the 2D serving path (NRRD in, test transform, the
MONAI-layout UNet, argmax, NRRD out) and the 2D Model L training step
(degree-2 transform, Focal+Dice, backward, Adam, Trainer, train CLI). Their
hand-written CUDA kernels (csrc/) are the InstanceNorm+PReLU sites forward
and backward, the stride-1 conv3x3+InstanceNorm+PReLU units forward and
their norm backward, and the degree-2 transform; on a CPU tensor each runs
its plain PyTorch version instead.

Layout:
  constants.py  copy of ctseg_tpu.constants (paths.py: of ctseg_tpu.paths)
  utils/        NRRD IO, Volume/CropBox
  testing/      synthetic PDDCA patients
  data/         packed datasets (a copy) and the device-resident pipeline
  transforms/   HU windowing, resize, the test and degree-2 transforms
  ops/          argmax, the kernels' wrappers and their nvcc/ctypes loader
  csrc/         CUDA C++ sources of the kernels (sm_90a)
  models/       MONAI-layout UNet, JAX parameter converter
  losses/       the segmentation losses
  metrics/      Dice
  training/     TrainConfig, Trainer, Adam, plateau, checkpoints, CLI
  inference/    predict_scan and the HTTP server
"""

__version__ = "0.1.0"
