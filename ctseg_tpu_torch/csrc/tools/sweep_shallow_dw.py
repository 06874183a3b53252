"""Time csrc/shallow_dw.cu at chip_smoke.py's four routed sites (phase 16b)
for each strip size the kernel's plan could take (ops/shallow_grad.py::
STRIPS: voxels of the base operand a block stages at a time), float32 and
bfloat16, each result held to the plan's own strip's within float32
round-off (bfloat16: one rounding). Not part of the library: run it alone
on the card, from the repository root,

    python3 ctseg_tpu_torch/csrc/tools/sweep_shallow_dw.py [--strips 128 256 512 1024]

A strip whose shared memory exceeds a block's is skipped. The last line is
one JSON object: {"card", "rows": [{"site", "dtype", "strip", "t1",
"groups", "smem_bytes", "ms"}]}.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--strips", type=int, nargs="+",
                        default=[128, 256, 512, 1024])
    args = parser.parse_args()

    import torch
    from ctseg_tpu_torch.models.layers import channels_last
    from ctseg_tpu_torch.ops import shallow_grad as sg

    if not torch.cuda.is_available():
        sys.exit("sweep_shallow_dw: no CUDA card")
    label = chip_smoke.card_label()
    print(label)
    default = dict(sg.STRIPS)
    gen = torch.Generator(device=chip_smoke.DEVICE).manual_seed(0)
    rows = []
    for name, transposed, n, spatial, cin, cout in chip_smoke.SHALLOW_SITES:
        osp = tuple(e * (2 if transposed else 1) for e in spatial)
        for dtype in (torch.float32, torch.bfloat16):
            x = channels_last(torch.randn((n, cin) + spatial, generator=gen,
                                          device=chip_smoke.DEVICE).to(dtype))
            dy = channels_last(torch.randn((n, cout) + osp, generator=gen,
                                           device=chip_smoke.DEVICE).to(dtype))
            sg.STRIPS = dict(default)
            ref, _ = sg.shallow_dw(x, dy, transposed)
            scale = float(ref.float().abs().max())
            for strip in args.strips:
                sg.STRIPS = {2: (strip,), 4: (strip,)}
                plan = sg.dw_plan(n, spatial, cin, cout, transposed,
                                  x.element_size())
                if plan["smem_bytes"] > sg.MAX_SHARED:
                    print(f"[{label}] {name} {dtype} strip {strip}: "
                          f"{plan['smem_bytes']} bytes of shared memory, "
                          "skipped")
                    continue
                dw, _ = sg.shallow_dw(x, dy, transposed)
                err = float((dw.float() - ref.float()).abs().max())
                tol = (1e-5 if dtype == torch.float32 else 2.0 ** -7) * scale
                if not err <= tol:
                    raise AssertionError(f"{name} {dtype} strip {strip}: "
                                         f"{err} from the default strip's")
                ms = chip_smoke.time_ms(
                    lambda: sg.shallow_dw(x, dy, transposed), 5)
                row = {"site": name, "dtype": str(dtype).removeprefix(
                    "torch."), "strip": strip, "t1": plan["t1"],
                    "groups": plan["groups"],
                    "smem_bytes": plan["smem_bytes"], "ms": ms}
                rows.append(row)
                print(f"[{label}] {name} {row['dtype']} strip {strip} (t1 "
                      f"{plan['t1']}, {plan['groups']} groups, "
                      f"{plan['smem_bytes']} bytes): {ms:.3f} ms")
            del x, dy, ref
            torch.cuda.empty_cache()
    sg.STRIPS = default
    print(json.dumps({"card": label, "rows": rows}))


if __name__ == "__main__":
    main()
