"""Device-resident input pipeline (port of ctseg_tpu/data/pipeline.py).

The whole split is copied to the device once; every epoch is a permutation
and on-device gathers. No dataloader workers and no per-step host-to-device
copies (the reference used `num_workers=cpu_count()` DataLoaders,
capstone/data/data_module.py:46-71).
"""

from typing import Iterator, Optional, Tuple

import torch

from ctseg_tpu_torch.data.datasets import PackedDataset2D

Batch = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def shard_rows(rows: torch.Tensor, shard: Tuple[int, int]) -> torch.Tensor:
    """Share `index` of `parts` equal shares of a global batch's rows."""
    index, parts = shard
    if rows.shape[0] % parts:
        raise ValueError(f"a batch of {rows.shape[0]} does not split into "
                         f"{parts} equal shares")
    k = rows.shape[0] // parts
    return rows[index * k:(index + 1) * k]


class DevicePipeline2D:
    """Raw-HU slice batches gathered on the device.

    `epoch` yields (images (B, H, W) float32, labels (B, H, W) uint8,
    indicators (B, 9) float32) and drops the incomplete trailing batch;
    `padded_epoch` covers every sample exactly once, padding the last batch
    with index-0 rows marked False in a fourth tensor, `row_valid` (B,)
    bool; `padded_indices` yields the same batches as sample indices, for a
    caller that needs per-sample side data (`spacings`, (N, 2) float32 when
    the split carries them). Windowing and augmentation happen later, in
    the train step. On a mesh every rank holds the whole split and walks
    the same global order; `shard=(index, parts)` makes each call yield
    rank `index`'s equal share of the rows of every global batch.
    """

    def __init__(self, dataset: PackedDataset2D, batch_size: int,
                 device="cuda"):
        self.batch_size = batch_size
        self.size = len(dataset)
        if self.size < batch_size:
            raise ValueError(
                f"dataset of {self.size} slices is smaller than one batch "
                f"of {batch_size}"
            )
        self.device = torch.device(device)
        self.images = torch.as_tensor(dataset.images, dtype=torch.float32,
                                      device=self.device).contiguous()
        self.labels = torch.as_tensor(dataset.labels, dtype=torch.uint8,
                                      device=self.device)
        self.indicators = torch.as_tensor(dataset.indicators,
                                          dtype=torch.float32,
                                          device=self.device)
        self.spacings = None if dataset.spacings is None else torch.as_tensor(
            dataset.spacings, dtype=torch.float32, device=self.device)

    def num_batches(self, drop_remainder: bool = True) -> int:
        if drop_remainder:
            return self.size // self.batch_size
        return -(-self.size // self.batch_size)

    def _order(self, generator: Optional[torch.Generator]) -> torch.Tensor:
        if generator is None:
            return torch.arange(self.size, device=self.device)
        return torch.randperm(self.size, generator=generator,
                              device=self.device)

    def gather(self, idx: torch.Tensor) -> Batch:
        return (self.images[idx], self.labels[idx], self.indicators[idx])

    def epoch(self, generator: Optional[torch.Generator] = None,
              shard: Tuple[int, int] = (0, 1)) -> Iterator[Batch]:
        """One epoch of batches, shuffled by `generator` (on the pipeline's
        device) when one is given."""
        perm = self._order(generator)
        for b in range(self.num_batches()):
            yield self.gather(shard_rows(
                perm[b * self.batch_size:(b + 1) * self.batch_size], shard))

    def padded_indices(self, generator: Optional[torch.Generator] = None,
                       shard: Tuple[int, int] = (0, 1)
                       ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        """(sample indices (B,), row_valid (B,)) batches covering every
        sample exactly once; padding rows point at sample 0."""
        n_batches = self.num_batches(drop_remainder=False)
        total = n_batches * self.batch_size
        perm = torch.zeros(total, dtype=torch.long, device=self.device)
        perm[: self.size] = self._order(generator)
        row_valid = torch.arange(total, device=self.device) < self.size
        for b in range(n_batches):
            sl = slice(b * self.batch_size, (b + 1) * self.batch_size)
            yield shard_rows(perm[sl], shard), shard_rows(row_valid[sl], shard)

    def padded_epoch(self, generator: Optional[torch.Generator] = None,
                     shard: Tuple[int, int] = (0, 1)
                     ) -> Iterator[Tuple[torch.Tensor, ...]]:
        """(images, labels, indicators, row_valid) batches covering every
        sample exactly once; for evaluation."""
        for idx, row_valid in self.padded_indices(generator, shard):
            yield self.gather(idx) + (row_valid,)
