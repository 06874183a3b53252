"""ctseg_tpu_torch — the PyTorch + CUDA port of ctseg_tpu for NVIDIA Hopper.

A second package beside the JAX one, with ctseg_tpu's module layout and
names so each counterpart is easy to find. It imports torch and numpy and
never JAX or `ctseg_tpu`; the JAX package is the reference its tests hold it
against (tests/test_torch_port_*.py).

The first slice is the 2D serving path: NRRD in, test transform, the
MONAI-layout UNet, argmax, NRRD out. Its two hand-written CUDA kernels
(csrc/) are the model's InstanceNorm+PReLU sites and its stride-1
conv3x3+InstanceNorm+PReLU units; on a CPU tensor each runs its plain
PyTorch version instead.

Layout:
  constants.py  copy of ctseg_tpu.constants
  utils/        NRRD IO, Volume/CropBox
  testing/      synthetic PDDCA patients
  transforms/   HU windowing, resize, the test transform
  ops/          argmax, the kernels' wrappers and their nvcc/ctypes loader
  csrc/         CUDA C++ sources of the kernels (sm_90a)
  models/       MONAI-layout UNet, JAX parameter converter
  training/     TrainConfig and checkpoint loading
  inference/    predict_scan and the HTTP server
"""

__version__ = "0.1.0"
