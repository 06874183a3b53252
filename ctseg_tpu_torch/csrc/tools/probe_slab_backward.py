"""Time one rank's work at the two routed sites of the depth-sharded
bench_3d step (the top decoder's 10 -> 10 conv and 128 -> 10 transposed
conv, full width) on one card, the two ways a slab can take them: the
library convs under autograd (`F.conv3d` on the slab with its halo rows,
unpadded along D; `F.conv_transpose3d` on the slab and the row after it,
its 2m rows kept), whose backward is cuDNN's dx and dW in one call, and
the routed Functions of ops/shallow_grad.py (`conv_smallc`,
`conv_transpose_smallc(depth=2m)`), whose backward is cuDNN's dx and the
hand-written kernel's dW and db. Each layout of `time_depth_sharded.py`
that shards depth gives a rank batch 128 / data and slabs of 16 / space
rows at the top level (8 / space below it).

    python3 ctseg_tpu_torch/csrc/tools/probe_slab_backward.py [--reps 10]

For each layout, site and type it prints device ms (CUDA events, the mean
of --reps calls after a warm-up) of the forward and of the backward alone,
each way, with the torch.profiler sum of device time by kernel name of
one backward each way (the names that take most of it), and a last line
of JSON {"card", "rows": [...]}. Layouts as the step hands them over:
the slab with its halo rows contiguous (N, C, H, W, D), as `_Halo`'s
concatenation of the channels_last slab and the received rows makes it;
the cotangent channels_last, as the norm's backward makes it.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[3]))

import chip_smoke  # noqa: E402

LAYOUTS = {"data 2 x space 2": (64, 2), "data 1 x space 4": (128, 4)}
# (name, transposed, x's spatial extents of the whole volume, cin, cout)
SITES = (("10 -> 10 conv", False, (128, 128, 16), 10, 10),
         ("128 -> 10 transposed conv", True, (64, 64, 8), 128, 10))


def _tensors(n, spatial, cin, cout, transposed, slabs, dtype, gen):
    import torch
    from ctseg_tpu_torch.models.layers import channels_last

    m = spatial[-1] // slabs
    xd = m + 1 if transposed else m + 2
    x = torch.randn((n, cin) + spatial[:-1] + (xd,), generator=gen,
                    device="cuda").to(dtype)
    shape = (cin, cout, 3, 3, 3) if transposed else (cout, cin, 3, 3, 3)
    w = (torch.randn(shape, generator=gen, device="cuda") * 0.05)
    b = torch.zeros(cout, device="cuda")
    out = tuple(2 * e for e in spatial[:-1]) + (2 * m,) if transposed \
        else spatial[:-1] + (m,)
    g = channels_last(torch.randn((n, cout) + out, generator=gen,
                                  device="cuda").to(dtype))
    return x, w, b, g


def _ways(transposed, m):
    import torch.nn.functional as F
    from ctseg_tpu_torch.ops import shallow_grad as sg

    if transposed:
        return {
            "library": lambda x, w, b: F.conv_transpose3d(
                x, w, b, 2, 1, 1).narrow(-1, 0, 2 * m),
            "routed": lambda x, w, b: sg.conv_transpose_smallc(
                x, w, b, 2, 3, 2 * m)}
    return {"library": lambda x, w, b: F.conv3d(x, w, b, 1, (1, 1, 0)),
            "routed": lambda x, w, b: sg.conv_smallc(x, w, b, (1, 1, 1),
                                                      (1, 1, 0))}


def _by_kernel(fn):
    """Device ms by kernel name of one call of fn (torch.profiler's kernel
    events, as chip_smoke.py::profile_step reads them), largest first."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key[:70], e.self_device_time_total / 1e3)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return sorted(rows, key=lambda r: -r[1])[:6]


def main():
    import torch
    from ctseg_tpu_torch.ops import _build
    from ctseg_tpu_torch.training.config import use_float32_convs

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    use_float32_convs()
    _build.library()
    label = chip_smoke.card_label()
    print(label)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for layout, (n, slabs) in LAYOUTS.items():
        for name, transposed, spatial, cin, cout in SITES:
            m = spatial[-1] // slabs
            for dtype in (torch.float32, torch.bfloat16):
                dname = str(dtype).removeprefix("torch.")
                x, w, b, g = _tensors(n, spatial, cin, cout, transposed,
                                      slabs, dtype, gen)
                x.requires_grad_()
                w.requires_grad_()
                b.requires_grad_()
                for way, fn in _ways(transposed, m).items():
                    def fwd():
                        return fn(x, w.to(dtype), b.to(dtype))

                    def bwd(y):
                        torch.autograd.grad(y, (x, w, b), g)

                    y = fwd()
                    fwd_ms = chip_smoke.time_ms(fwd, args.reps)
                    # Each backward on a fresh graph: forwards queued
                    # between them are subtracted.
                    both = chip_smoke.time_ms(lambda: bwd(fwd()), args.reps)
                    kernels = _by_kernel(lambda: bwd(fwd()))
                    row = {"layout": layout, "site": name, "dtype": dname,
                           "way": way, "batch": n, "slab_rows": m,
                           "fwd_ms": fwd_ms, "bwd_ms": both - fwd_ms,
                           "by_kernel": kernels}
                    rows.append(row)
                    print(f"[{label}] {layout}, {name}, {dname}, {way}: "
                          f"forward {fwd_ms:.3f} ms, backward "
                          f"{both - fwd_ms:.3f} ms; one forward and backward"
                          " by kernel: " + "; ".join(
                              f"{k} {v:.3f}" for k, v in kernels), flush=True)
                    del y
                del x, w, b, g
                torch.cuda.empty_cache()
    print(json.dumps({"card": label, "rows": rows}))


if __name__ == "__main__":
    main()
