"""The plain reference of a training step, written from the reference
trainer's stated contracts (capstone/training/base_trainer.py,
capstone/models/losses.py, capstone/volumetric/trainer3d.py):

  - the 2D degree-2 train transform: three HU windows (brain, soft tissue,
    bone), a random 256 crop, rot90 by k, a horizontal flip, per-channel
    normalisation; the labels take the same moves;
  - the 3D patch transform: the patch at (volume, top, left, front), the
    soft-tissue window, H and W flips;
  - the losses: MONAI's DiceLoss (softmax, one-hot, background left out,
    per (sample, class) 1 - (2I + 1e-5) / (T + P + 1e-5)), FocalLoss
    (gamma 2, one-hot, per (sample, class) voxel mean), CrossEntropy (mean
    over voxels); with exclude_missing AnatomyNet's masking: each
    structure weighted by 1 / its annotations in the batch (all ones when
    one is missing from the whole batch), normalised to sum 1, Focal with a
    background column present where every structure is;
  - Adam (the loss summed over the named losses), its bias corrections.

The step runs in blocks of rows so that it fits beside nothing: every loss
above is a sum over samples over the batch's size, with the masking's
weights taken from the whole batch first, so the blocks' gradients add up
to the batch's. Imports nothing of the program.
"""

import math
from typing import Dict, List, NamedTuple

import torch
import torch.nn.functional as F

from benchmark.reference.unet import Model

# (width, level) in HU, and the stacked windows' per-channel statistics
# (reference transforms_2d.py:6, predefined.py:5).
WINDOWS = ((80, 40), (350, 20), (2800, 600))
SOFT_TISSUE = (350, 20)
MEAN = (0.107, 0.135, 0.085)
STD = (0.271, 0.267, 0.152)


def window(x: torch.Tensor, width_level) -> torch.Tensor:
    width, level = width_level
    lo, hi = level - width // 2, level + width // 2
    den = torch.tensor(hi - lo + 1e-8, dtype=torch.float32, device=x.device)
    return (torch.clamp(x, lo, hi) - lo) / den


def degree2(images, labels, draws, size: int):
    """(N, H, W) HU, (N, H, W) labels, draws (top, left, k, flip) ->
    (N, 3, S, S) float32, (N, S, S) int64."""
    ar = torch.arange(size, device=images.device)
    n = torch.arange(images.shape[0], device=images.device)[:, None, None]
    rows = (draws.top.long()[:, None] + ar)[:, :, None]
    cols = (draws.left.long()[:, None] + ar)[:, None, :]
    img = torch.stack([window(images, w) for w in WINDOWS], -1)
    img, lab = img[n, rows, cols], labels[n, rows, cols].long()
    k, flip = draws.k.long(), draws.flip.bool()
    out_i, out_l = img.clone(), lab.clone()
    for i in range(img.shape[0]):
        a = torch.rot90(img[i], int(k[i]), dims=(0, 1))
        b = torch.rot90(lab[i], int(k[i]), dims=(0, 1))
        if flip[i]:
            a, b = torch.flip(a, dims=(1,)), torch.flip(b, dims=(1,))
        out_i[i], out_l[i] = a, b
    mean = torch.tensor(MEAN, device=img.device)
    std = torch.tensor(STD, device=img.device)
    return ((out_i - mean) / std).movedim(-1, 1).contiguous(), out_l


def patches(volumes, labels, draws, patch):
    """volumes/labels: lists of (D, H, W) tensors; draws (volume, top,
    left, front) -> (N, ph, pw, pd) HU and labels."""
    ph, pw, pd = patch
    imgs, labs = [], []
    for v, t, l, f in zip(*(d.tolist() for d in draws)):
        sl = (slice(f, f + pd), slice(t, t + ph), slice(l, l + pw))
        imgs.append(volumes[v][sl].permute(1, 2, 0))
        labs.append(labels[v][sl].permute(1, 2, 0))
    return torch.stack(imgs), torch.stack(labs)


def patch_transform(images, labels, flips):
    """(N, H, W, D) HU -> (N, 1, H, W, D) soft-tissue window, then the
    drawn H and W flips; labels alike."""
    img, lab = window(images, SOFT_TISSUE), labels.long()
    h = flips.h.bool().view(-1, 1, 1, 1)
    w = flips.w.bool().view(-1, 1, 1, 1)
    img = torch.where(h, img.flip(1), img)
    lab = torch.where(h, lab.flip(1), lab)
    img = torch.where(w, img.flip(2), img)
    lab = torch.where(w, lab.flip(2), lab)
    return img[:, None].contiguous(), lab


def _one_hot(labels, c):
    return F.one_hot(labels, c).movedim(-1, 1).to(torch.float32)


def dice_matrix(logits, labels):
    """(n, C-1): 1 - (2I + s) / (T + P + s) per sample and structure."""
    p = torch.softmax(logits, 1)
    t = _one_hot(labels, logits.shape[1])
    ax = tuple(range(2, logits.ndim))
    inter, tsum, psum = (t * p).sum(ax), t.sum(ax), p.sum(ax)
    return (1.0 - (2.0 * inter + 1e-5) / (tsum + psum + 1e-5))[:, 1:]


def focal_matrix(logits, labels, gamma=2.0):
    """(n, C): the voxel mean of -(1 - p_y)^gamma log p_y in each class."""
    logp = torch.log_softmax(logits, 1)
    t = _one_hot(labels, logits.shape[1])
    logp_y = (t * logp).sum(1, keepdim=True)
    fl = -((1.0 - logp_y.exp()) ** gamma) * logp_y
    return (t * fl).mean(tuple(range(2, logits.ndim)))


def cross_entropy_sum(logits, labels):
    return F.cross_entropy(logits, labels, reduction="sum")


def mask_weights(indicators, n_classes, focal: bool):
    """AnatomyNet's per-(sample, class) mask and class weights from the
    whole batch's indicators (N, C-1)."""
    m = indicators.to(torch.float32)
    if focal:
        bg = (m.sum(1, keepdim=True) == n_classes - 1).to(torch.float32)
        m = torch.cat([bg, m], 1)
    counts = m.sum(0)
    w = 1.0 / counts
    if torch.isinf(w).any():
        w = torch.ones_like(w)
    return m, w / w.sum()


def block_loss(config, logits, labels, indicators, rows, n_total):
    """{loss name: this block's share of the batch's loss}."""
    c = config["out_channels"]
    out = {}
    for name in config["loss"]:
        if name == "CrossEntropy":
            vox = labels[0].numel()
            out[name] = cross_entropy_sum(logits, labels) / (n_total * vox)
            continue
        f = dice_matrix(logits, labels) if name == "Dice" \
            else focal_matrix(logits, labels)
        if config["exclude_missing"]:
            m, w = mask_weights(indicators, c, name == "Focal")
            out[name] = (f * w * m[rows]).sum() / n_total
        else:
            out[name] = f.sum() / (n_total * f.shape[1])
    return out


class StepInput(NamedTuple):
    """What one step is fed: the transformed images (N, C, *spatial), the
    labels (N, *spatial) and the indicators (N, C-1)."""

    images: torch.Tensor
    labels: torch.Tensor
    indicators: torch.Tensor


class Trajectory(NamedTuple):
    losses: List[float]                # each step's summed loss
    grad_norms: Dict[str, float]       # step 1's gradient, per leaf
    change_norms: Dict[str, float]     # the change over the steps, per leaf


def run_steps(config, weights: Dict[str, torch.Tensor], inputs, block: int,
              device, tf32: bool = False,
              dtype: torch.dtype = torch.float32) -> Trajectory:
    """Adam over `inputs` (a sequence of callables returning StepInput,
    so each step's batch lives only while it runs) from `weights`, in
    float32 with TF32 off (on with `tf32`: the control; float64 with
    `dtype`, a referee for the readings)."""
    cudnn, matmul = torch.backends.cudnn.allow_tf32, \
        torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        return _run_steps(config, weights, inputs, block, device, dtype)
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.backends.cuda.matmul.allow_tf32 = matmul


def _run_steps(config, weights, inputs, block, device, dtype):
    model = Model(config).to(device=device, dtype=dtype)
    model.load_state_dict(weights)
    params = dict(model.named_parameters())
    b1, b2 = config["adam_betas"]
    lr, eps = config["lr"], config["adam_eps"]
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    losses, grad_norms = [], {}
    for t, make in enumerate(inputs, start=1):
        x = make()
        n = x.images.shape[0]
        model.zero_grad(set_to_none=True)
        total = 0.0
        for lo in range(0, n, block):
            rows = slice(lo, min(lo + block, n))
            logits = model(x.images[rows].to(dtype))
            parts = block_loss(config, logits, x.labels[rows],
                               x.indicators, rows, n)
            loss = sum(parts.values())
            loss.backward()
            total += float(loss.detach().double())
            del logits, parts, loss
        losses.append(total)
        with torch.no_grad():
            if t == 1:
                grad_norms = {k: float(p.grad.double().norm())
                              for k, p in params.items()}
            c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
            for k, p in params.items():
                g = p.grad
                m[k].mul_(b1).add_(g, alpha=1.0 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                denom = (v[k].sqrt() / math.sqrt(c2)).add_(eps)
                p.addcdiv_(m[k], denom, value=-lr / c1)
        del x
    with torch.no_grad():
        change = {k: float((p.detach().double()
                            - weights[k].double()).norm())
                  for k, p in params.items()}
    return Trajectory(losses, grad_norms, change)
