"""Device-resident 3D volume pipelines (port of
ctseg_tpu/volumetric/pipeline3d.py).

Two modes:
  - "resize" (the reference's parity mode): every volume nearest-resized
    once, on the device, to a fixed (H, W, D) grid when the pipeline is
    built (`DevicePipeline3D`).
  - "patch": volumes kept at native resolution, depth-padded to the
    deepest and stacked; each batch is `batch_size` random fixed-size
    patches gathered on the device (`PatchPipeline3D`).

Layout: images (N, H, W, D) float32 raw HU, labels (N, H, W, D) uint8, the
reference's channel-last form of its B x 1 x 256 x 256 x 96 batches; host
volumes are (D, H, W). `jax.image.resize(..., "nearest")` is
F.interpolate's "nearest-exact" (transforms/augment.py says why).

A patch batch's random parameters (volume, top, left, front) are drawn from
an explicit torch.Generator (`PatchPipeline3D.draw`, the distributions of
the reference's calls, pipeline3d.py:146-154) and can be fed to `gather`
instead, as `Degree2Draws` are in 2D. The patches are gathered by plain
indexing: the reference's `fori_loop` of dynamic_update_slice copies is a
TPU workaround.
"""

from typing import Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ctseg_tpu_torch.data.datasets import PackedDataset3D
from ctseg_tpu_torch.data.pipeline import DevicePipeline2D

RESIZE_SHAPE = (256, 256, 96)  # (H, W, D), the reference's volumetric grid

Batch = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def nearest_resize_3d(vol: torch.Tensor, shape: Tuple[int, int, int]
                      ) -> torch.Tensor:
    """Nearest-neighbour resize of one (H, W, D) volume (the reference's
    F.interpolate nearest for image and mask, volumetric/transforms.py)."""
    return F.interpolate(vol[None, None], size=tuple(shape),
                         mode="nearest-exact")[0, 0]


class DevicePipeline3D(DevicePipeline2D):
    """Whole volumes resized once to `shape` (resize mode); epochs as
    DevicePipeline2D's (shuffled gathers, the incomplete trailing batch
    dropped; `padded_epoch` covers every volume once)."""

    def __init__(self, dataset: PackedDataset3D, batch_size: int = 1,
                 shape: Tuple[int, int, int] = RESIZE_SHAPE, device="cuda"):
        self.batch_size = batch_size
        self.size = len(dataset)
        if self.size < batch_size:
            raise ValueError(
                f"dataset of {self.size} volumes is smaller than one batch "
                f"of {batch_size}")
        self.device = torch.device(device)
        images, labels = [], []
        for img, lab in zip(dataset.images, dataset.labels):
            # host (D, H, W) -> device (H, W, D); labels resize as floats
            img = torch.as_tensor(np.asarray(img, np.float32),
                                  device=self.device).movedim(0, -1)
            lab = torch.as_tensor(np.asarray(lab, np.float32),
                                  device=self.device).movedim(0, -1)
            images.append(nearest_resize_3d(img, shape))
            labels.append(nearest_resize_3d(lab, shape).to(torch.uint8))
        self.images = torch.stack(images)
        self.labels = torch.stack(labels)
        self.indicators = torch.as_tensor(
            np.stack(dataset.indicators), dtype=torch.float32,
            device=self.device)
        self.spacings = None


class PatchDraws(NamedTuple):
    """One patch batch's parameters, each (B,) int64."""

    volume: torch.Tensor  # index of the volume
    top: torch.Tensor     # first H row, in [0, H - ph]
    left: torch.Tensor    # first W column, in [0, W - pw]
    front: torch.Tensor   # first D slice, in [0, max(depth - pd, 0)]


def front_from_uniform(u: torch.Tensor, depths: torch.Tensor, pd: int
                       ) -> torch.Tensor:
    """floor(u * (max(depth - pd, 0) + 1)) in float32, as the reference
    rounds it (pipeline3d.py:150-153): a uniform front over the slices a
    patch can start at without leaving the volume's own depth."""
    dmax = torch.clamp_min(depths - pd, 0).to(torch.float32)
    return (u.to(torch.float32) * (dmax + 1.0)).to(torch.int64)


class PatchPipeline3D:
    """Random native-resolution patches (patch mode).

    Volumes are depth-padded (with zeros) to the deepest and stacked on the
    device; every batch draws `batch_size` (volume, corner) pairs, the front
    chosen inside the volume's own depth where it is deeper than the patch.
    """

    def __init__(self, dataset: PackedDataset3D, batch_size: int,
                 patch_size: Tuple[int, int, int] = (128, 128, 48),
                 steps_per_epoch: int = 100, device="cuda"):
        self.batch_size = batch_size
        self.patch_size = tuple(int(p) for p in patch_size)
        self.size = len(dataset)
        self.steps_per_epoch = steps_per_epoch
        self.device = torch.device(device)

        shapes = np.array([img.shape for img in dataset.images])  # (N, 3) DHW
        self.max_d = int(shapes[:, 0].max())
        h, w = int(shapes[0, 1]), int(shapes[0, 2])
        if not ((shapes[:, 1] == h).all() and (shapes[:, 2] == w).all()):
            raise ValueError("patch mode expects one H, W for every volume "
                             "(crop first)")
        ph, pw, pd = self.patch_size
        if ph > h or pw > w or pd > self.max_d:
            raise ValueError(f"patch {self.patch_size} exceeds the volumes' "
                             f"({h}, {w}, {self.max_d})")
        self.shape = (h, w)
        imgs = np.zeros((self.size, h, w, self.max_d), np.float32)
        labs = np.zeros((self.size, h, w, self.max_d), np.uint8)
        for i, (img, lab) in enumerate(zip(dataset.images, dataset.labels)):
            d = img.shape[0]
            imgs[i, :, :, :d] = np.moveaxis(img, 0, -1)
            labs[i, :, :, :d] = np.moveaxis(lab, 0, -1)
        self.images = torch.from_numpy(imgs).to(self.device)
        self.labels = torch.from_numpy(labs).to(self.device)
        self.depths = torch.as_tensor(shapes[:, 0], dtype=torch.int64,
                                      device=self.device)
        self.indicators = torch.as_tensor(
            np.stack(dataset.indicators), dtype=torch.float32,
            device=self.device)

    def num_batches(self, steps_per_epoch: Optional[int] = None) -> int:
        return steps_per_epoch or self.steps_per_epoch

    def draw(self, generator: Optional[torch.Generator]) -> PatchDraws:
        """One batch's (volume, top, left, front), on the pipeline's
        device, from `generator` (on that device)."""
        (h, w), (ph, pw, pd) = self.shape, self.patch_size
        kw = {"generator": generator, "device": self.device}
        b = self.batch_size
        volume = torch.randint(0, self.size, (b,), **kw)
        top = torch.randint(0, h - ph + 1, (b,), **kw)
        left = torch.randint(0, w - pw + 1, (b,), **kw)
        u = torch.rand((b,), **kw)
        return PatchDraws(volume, top, left,
                          front_from_uniform(u, self.depths[volume], pd))

    def gather(self, draws: PatchDraws) -> Batch:
        """(images (B, ph, pw, pd), labels, indicators (B, 9)) at `draws`."""
        ph, pw, pd = self.patch_size

        def span(start, n):
            return start.long()[:, None] + torch.arange(n, device=self.device)

        v = draws.volume.long()
        idx = (v[:, None, None, None],
               span(draws.top, ph)[:, :, None, None],
               span(draws.left, pw)[:, None, :, None],
               span(draws.front, pd)[:, None, None, :])
        return self.images[idx], self.labels[idx], self.indicators[v]

    def epoch(self, generator: Optional[torch.Generator] = None,
              steps: Optional[int] = None) -> Iterator[Batch]:
        """`steps` (default steps_per_epoch) random batches; without a
        generator, the fixed one seeded 0 (the reference's key 0)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        for _ in range(steps or self.steps_per_epoch):
            yield self.gather(self.draw(generator))

    def padded_epoch(self, generator: Optional[torch.Generator] = None,
                     steps: Optional[int] = None) -> Iterator:
        """Every random patch is a real sample: row_valid is all True."""
        valid = torch.ones((self.batch_size,), dtype=torch.bool,
                           device=self.device)
        for batch in self.epoch(generator, steps):
            yield batch + (valid,)
