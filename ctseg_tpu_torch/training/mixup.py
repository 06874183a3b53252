"""Weighted mixup on the device (port of ctseg_tpu/training/mixup.py).

Contract from reference capstone/training/utils.py:23-56: the partner of
each sample is drawn from a multinomial over the inverse of the samples'
mean annotation counts (rare structures are picked more), one lambda ~
Beta(alpha, alpha) per batch, mix = lambda * x + (1 - lambda) * x[index].

Split so that the tests can feed the reference's own draws:
`mixup_probability` is the deterministic part, `draw_mixup` draws (index,
lambda) from an explicit torch.Generator, `mixup_tensors` mixes. Lambda stays
a device scalar: nothing here waits for the device. Only the distribution of
the draws is that of the JAX package, not its stream of numbers.

Structure presence comes from the label map (class s + 1 anywhere in the
sample), as in the JAX package.

On a mesh (`batch`, parallel/collectives.py::GlobalBatch) the draws are the
global batch's, as the JAX package's under pjit: the probabilities come
from every rank's presence rows, gathered; the index (over the global
batch) and lambda are drawn from a generator that is the same on every
rank; each rank's rows take their partners from the gathered batch
(`take_partners`).
"""

import functools
from typing import Optional, Tuple

import torch

from ctseg_tpu_torch.constants import ANNOTATION_COUNT, NUM_CLASSES
from ctseg_tpu_torch.parallel.collectives import LOCAL, GlobalBatch


@functools.lru_cache(maxsize=None)
def _annotation_count(device: torch.device) -> torch.Tensor:
    """Kept per device: a copy to the card per step would wait for it."""
    return torch.tensor(ANNOTATION_COUNT, dtype=torch.float32, device=device)


def structure_presence(labels: torch.Tensor) -> torch.Tensor:
    """(N, *spatial) label map -> (N, 9) float32 presence indicator."""
    flat = labels.flatten(1)
    return torch.stack(
        [torch.any(flat == c, dim=1) for c in range(1, NUM_CLASSES)], dim=1
    ).to(torch.float32)


def mixup_probability(labels: torch.Tensor, batch: GlobalBatch = LOCAL
                      ) -> torch.Tensor:
    """(N,) partner probabilities of weighted mixup over the global batch,
    summing to 1."""
    count = _annotation_count(labels.device)
    presence = structure_presence(labels)
    if batch.n_space > 1:  # present in any depth slab
        presence = (batch.spatial_counts(presence) > 0).to(torch.float32)
    indicator = batch.gather_rows(presence) * count  # (N, 9)
    # A sample with no structure gets the full count row, so its
    # probability stays finite (reference utils.py:31-36).
    empty = torch.sum(indicator, dim=1, keepdim=True) == 0
    indicator = indicator + empty * torch.sum(count)
    nonzero = torch.sum(indicator > 0, dim=1)
    probability = 1.0 / (torch.sum(indicator, dim=1) / nonzero)
    return probability / torch.sum(probability)


def sample_beta(generator: Optional[torch.Generator], alpha: float,
                shape=(), device=None) -> torch.Tensor:
    """Beta(alpha, alpha) draws, float32, from `generator`: g1 / (g1 + g2)
    of two Gamma(alpha, 1) draws (torch.distributions takes no generator).
    The gammas are float64 and kept above the smallest normal number: at
    alpha = 0.2 a float32 gamma underflows to 0 about once in 1e9 draws."""
    conc = torch.full((2,) + tuple(shape), alpha, dtype=torch.float64,
                      device=device)
    g = torch._standard_gamma(conc, generator=generator)
    g = torch.clamp_min(g, torch.finfo(torch.float64).tiny)
    return (g[0] / (g[0] + g[1])).to(torch.float32)


def draw_mixup(generator: Optional[torch.Generator],
               probability: torch.Tensor, alpha: float = 0.2
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(partner index (N,) int64, lambda () float32), both on the
    probabilities' device."""
    lam = sample_beta(generator, alpha, device=probability.device)
    index = torch.multinomial(probability, probability.shape[0],
                              replacement=True, generator=generator)
    return index, lam


def mixup_tensors(a: torch.Tensor, b: torch.Tensor, lam: torch.Tensor
                  ) -> torch.Tensor:
    return lam * a + (1.0 - lam) * b


def take_partners(index: torch.Tensor, batch: GlobalBatch, *tensors):
    """The partners of this rank's rows: `index` (N_global,) is over the
    global batch, each of `tensors` holds this rank's rows. The rows are
    gathered from every rank (the whole transformed batch: simple, and a
    copy of the global batch per rank)."""
    mine = batch.local_rows(index)
    return tuple(None if t is None else batch.gather_rows(t)[mine]
                 for t in tensors)


def weighted_mixup(generator: Optional[torch.Generator], images: torch.Tensor,
                   labels: torch.Tensor, alpha: float = 0.2,
                   batch: GlobalBatch = LOCAL
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (mixed_images, partner_index over the global batch,
    lambda)."""
    index, lam = draw_mixup(generator, mixup_probability(labels, batch),
                            alpha)
    partner, = take_partners(index, batch, images)
    return mixup_tensors(images, partner, lam), index, lam


def plain_mixup(generator: Optional[torch.Generator], images: torch.Tensor,
                alpha: float = 0.2, batch: GlobalBatch = LOCAL
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Uniform-permutation mixup (reference mixup_data, utils.py:45-52) over
    the global batch."""
    lam = sample_beta(generator, alpha, device=images.device)
    index = torch.randperm(images.shape[0] * batch.n_data,
                           generator=generator, device=images.device)
    partner, = take_partners(index, batch, images)
    return mixup_tensors(images, partner, lam), index, lam
