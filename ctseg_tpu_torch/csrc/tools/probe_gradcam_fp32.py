"""Where GradCAM's float32 error comes from: full-width Model L (random
weights from seed 0) on 2 random 280x280 slices, the maps at feat_down1 of
the 9 structures on the card (twice), on a CPU copy in float32 and on a
CPU copy in float64 (the referee). Not part of the library: run it alone
on the card, from the repository root,

    python3 ctseg_tpu_torch/csrc/tools/probe_gradcam_fp32.py

It prints the card's name and power limit, then for the layer's
activation, the logits, the gradient at the layer, and the maps before
their ReLU, the (worst, median) over the maps of |path - referee| / the
referee's max for the CPU's float32 path and the card, and the card's
spread between two runs; then each map's error after the ReLU, for both
paths; and the card's errors again with cuDNN's deterministic algorithms.
"""

import copy
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[3]))

import chip_smoke  # noqa: E402
from ctseg_tpu_torch.interpret.gradcam import (  # noqa: E402
    class_activation_maps,
)
from ctseg_tpu_torch.models.layers import channels_last  # noqa: E402
from ctseg_tpu_torch.training.config import (  # noqa: E402
    TrainConfig,
    build_model,
)
from ctseg_tpu_torch.transforms.pipelines import get_transform  # noqa: E402

LAYER = "feat_down1"


def parts(model, x):
    """(activation, logits, gradients (9, N, C, h, w), maps before the
    ReLU (9, N, h, w)) of the library's GradCAM, in float64 on the CPU."""
    _, logits, got = class_activation_maps(model, x, range(1, 10), LAYER,
                                           with_parts=True)
    return tuple(t.double().cpu() for t in (
        got["activation"], logits, got["gradients"], got["maps"]))


def rel(a, b, dims):
    """(worst, median) over the leading `dims` axes of |a - b| / max |b|."""
    err = (a - b).abs().flatten(dims).amax(-1)
    scale = b.abs().flatten(dims).amax(-1)
    return float((err / scale).max()), float((err / scale).median())


def main():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.card_label())
    cfg = TrainConfig(filters=chip_smoke.FILTERS, num_res_units=2,
                      transform_degree=2)
    model = build_model(cfg, "cpu",
                        generator=torch.Generator().manual_seed(0)).eval()
    raw = np.random.default_rng(0).normal(40, 300, (2, 280, 280))
    img, _ = get_transform(2, False)(torch.from_numpy(raw.astype(np.float32)))
    x = channels_last(img.permute(0, 3, 1, 2))

    f64 = copy.deepcopy(model).to(torch.float64)
    f64.compute_dtype = torch.float64
    ref = parts(f64, x.double())
    cpu = parts(copy.deepcopy(model), x)
    card_model = copy.deepcopy(model).to("cuda")
    card = parts(card_model, x.cuda())
    again = parts(card_model, x.cuda())
    for i, name in enumerate(("activation", "logits", "gradient",
                              "maps before the ReLU")):
        dims = 2 if i >= 2 else 1
        print(f"{name}: CPU float32 {rel(cpu[i], ref[i], dims)}; card "
              f"{rel(card[i], ref[i], dims)}; card run to run "
              f"{rel(card[i], again[i], dims)}")
    scale = F.relu(ref[3]).flatten(2).amax(-1)
    for name, path in (("CPU float32", cpu), ("card", card)):
        err = (F.relu(path[3]) - F.relu(ref[3])).abs().flatten(2).amax(-1)
        print(f"maps, {name}, of each map's max:",
              (err / scale).numpy().round(6).tolist())
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    det = parts(card_model, x.cuda())
    print("card, cuDNN deterministic: gradient", rel(det[2], ref[2], 2),
          "maps", rel(F.relu(det[3]), F.relu(ref[3]), 2))


if __name__ == "__main__":
    main()
