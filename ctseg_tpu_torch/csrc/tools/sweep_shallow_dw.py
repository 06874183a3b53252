"""Time the shallow weight-gradient kernels at chip_smoke.py's four routed
sites (phase 16b): csrc/shallow_dw.cu at the stride-1 conv for each strip
(voxels a step stages, ops/shallow_grad.py::STRIPS), each count of ring
slots past the hspan + 1 a step needs (--ring-extra, the plan's RING_EXTRA)
and each bound on a launch's blocks (--max-grid: the plan's MAX_GRID, each
other than it built from a copy of csrc/ with that kMaxGrid; at the
SHALLOW_ROUTED convs too, at their plan's strip),
csrc/shallow_dwt.cu at the transposed convs for each of its strips
(DWT_STRIPS), for each ring depth (--dwt-stages: the kernel's kStages, each
other than DWT_STAGES built from a copy of csrc/ with that one constant
changed) and each count of groups (--dwt-groups-per-sm: the plan's groups
for that many blocks an SM, by SMS), float32 and bfloat16, each result
held to the plan's own strip's within float32 round-off (bfloat16: one
rounding). With --parent, the parent tree's kernel too, built from that
checkout's csrc/ and called through its own ops/shallow_grad.py, on the
same tensors, in turns with this tree's plan: parent, this, this, parent,
at the four sites and at chip_smoke.py's SHALLOW_ROUTED convs (where the
parent raises on a conv, this tree's alone).
Not part of the library: run it alone on the card, from the repository
root,

    python3 ctseg_tpu_torch/csrc/tools/sweep_shallow_dw.py
        [--maps stride1 transposed] [--strips 128 256 512]
        [--ring-extra 0] [--max-grid 1056] [--dwt-strips 16 32 64 128]
        [--dwt-stages 3] [--dwt-groups-per-sm 1] [--parent DIR]

A geometry whose shared memory exceeds a block's is skipped. The last line
is one JSON object: {"card", "rows": [{"site", "dtype", "kernel", "strip",
"ring_extra", "max_grid", "stages", "groups_per_sm", "t1", "groups",
"smem_bytes", "ms"}], "parent": [{"site", "dtype", "k", "ms_parent" (null where the
parent raises), "ms_this"}]}
("groups": the stride-1 plan's blocks, the transposed plan's groups).
"""

import argparse
import importlib.util
import json
import re
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_parent(root: Path):
    """The parent checkout's ops/shallow_grad.py, launching from its own
    kernel library (its ops/_build.py, built from its csrc/)."""
    pkg = root / "ctseg_tpu_torch" / "ops"
    build = _load("parent_build", pkg / "_build.py")
    build.library()
    sg = _load("parent_shallow_grad", pkg / "shallow_grad.py")
    sg._build = build
    return sg


def constant_libraries(values, default, source, name):
    """{value: kernel library}: this tree's for `default`, else one built
    from a copy of csrc/ whose `source` has `constexpr int name = value`."""
    variants = _load("variants_shallow_dw",
                     Path(__file__).with_name("variants_shallow_dw.py"))
    text = (variants._build.CSRC / source).read_text()
    line = re.search(rf"constexpr int {name} = \d+;", text).group(0)

    def one(v):
        if v == default:
            return variants.build("this tree", None)
        return variants.build(f"{name} {v}", text.replace(
            line, f"constexpr int {name} = {v};"), source=source)

    with ThreadPoolExecutor(len(values)) as pool:
        return dict(zip(values, pool.map(one, values)))


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--maps", nargs="+", default=["stride1", "transposed"],
                        choices=["stride1", "transposed"])
    parser.add_argument("--strips", type=int, nargs="+",
                        default=[128, 256, 512])
    parser.add_argument("--ring-extra", type=int, nargs="+", default=[0])
    parser.add_argument("--max-grid", type=int, nargs="+", default=None)
    parser.add_argument("--dwt-strips", type=int, nargs="+",
                        default=[16, 32, 64, 128])
    parser.add_argument("--dwt-stages", type=int, nargs="+", default=None)
    parser.add_argument("--dwt-groups-per-sm", type=int, nargs="+",
                        default=[1])
    parser.add_argument("--parent", type=Path, default=None)
    args = parser.parse_args()

    import torch
    from ctseg_tpu_torch.models.layers import channels_last
    from ctseg_tpu_torch.ops import _build
    from ctseg_tpu_torch.ops import shallow_grad as sg

    if not torch.cuda.is_available():
        sys.exit("sweep_shallow_dw: no CUDA card")
    label = chip_smoke.card_label()
    print(label)
    parent = load_parent(args.parent.resolve()) if args.parent else None
    default, default_t = dict(sg.STRIPS), dict(sg.DWT_STRIPS)
    default_extra = sg.RING_EXTRA
    default_stages, sms = sg.DWT_STAGES, sg.SMS
    default_grid = sg.MAX_GRID
    libs = constant_libraries(args.dwt_stages or [default_stages],
                              default_stages, "shallow_dwt.cu", "kStages")
    grids = args.max_grid or [default_grid]
    grid_libs = constant_libraries(grids, default_grid, "shallow_dw.cu",
                                   "kMaxGrid")
    gen = torch.Generator(device=chip_smoke.DEVICE).manual_seed(0)
    rows, vs_parent = [], []
    cases = [(True, *site, 3) for site in chip_smoke.SHALLOW_SITES]
    if parent is not None or args.max_grid:
        cases += [(False, *site) for site in chip_smoke.SHALLOW_ROUTED]
    for main, name, transposed, n, spatial, cin, cout, k in cases:
        if ("transposed" if transposed else "stride1") not in args.maps:
            continue
        osp = tuple(e * (2 if transposed else 1) for e in spatial)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).removeprefix("torch.")
            x = channels_last(torch.randn((n, cin) + spatial, generator=gen,
                                          device=chip_smoke.DEVICE).to(dtype))
            dy = channels_last(torch.randn((n, cout) + osp, generator=gen,
                                           device=chip_smoke.DEVICE).to(dtype))
            sg.STRIPS, sg.DWT_STRIPS = dict(default), dict(default_t)
            ref, _ = sg.shallow_dw(x, dy, transposed, k)
            scale = float(ref.float().abs().max())
            tol = (1e-5 if dtype == torch.float32 else 2.0 ** -7) * scale

            def held(dw, what):
                err = float((dw.float() - ref.float()).abs().max())
                if not err <= tol:
                    raise AssertionError(f"{name} {dname} {what}: {err} from "
                                         "this tree's default plan")

            if parent is not None:
                try:
                    held(parent.shallow_dw(x, dy, transposed, k)[0],
                         "parent")
                    fns = (parent.shallow_dw, sg.shallow_dw, sg.shallow_dw,
                           parent.shallow_dw)
                except ValueError as exc:  # a conv the parent did not take
                    print(f"[{label}] {name} {dname}: the parent raises "
                          f"({exc})", flush=True)
                    fns = (None, sg.shallow_dw, sg.shallow_dw, None)
                t = [fn and chip_smoke.time_ms(
                    lambda: fn(x, dy, transposed, k), 5) for fn in fns]
                vs_parent.append({"site": name, "dtype": dname, "k": k,
                                  "ms_parent": [t[0], t[3]],
                                  "ms_this": [t[1], t[2]]})
                print(f"[{label}] {name} {dname}: parent {t[0]} ms, this "
                      f"{t[1]:.4f}, this {t[2]:.4f}, parent {t[3]}",
                      flush=True)
            # stride-1: (ring slots past hspan + 1, MAX_GRID, strip; at a
            # SHALLOW_ROUTED conv its plan's ring and strip); transposed:
            # (ring depth, groups an SM, strip).
            if transposed:
                geoms = [(s, f, strip) for s in libs
                         for f in args.dwt_groups_per_sm
                         for strip in args.dwt_strips] if main else []
            elif main:
                geoms = [(e, mg, strip) for e in args.ring_extra
                         for mg in grids for strip in args.strips]
            else:
                geoms = [(default_extra, mg, None) for mg in args.max_grid
                         or ()]
            for ring, per_sm, strip in geoms:
                if transposed:
                    _build.use(libs[ring])
                    sg.DWT_STAGES, sg.SMS = ring, per_sm * sms
                    sg.DWT_STRIPS = {2: (strip,), 4: (strip,)}
                    plan = sg.dwt_plan(n, spatial, cin, cout,
                                       x.element_size())
                    what = (f"{name} {dname} strip {strip}, {ring} stages, "
                            f"{per_sm} a SM")
                else:
                    _build.use(grid_libs[per_sm])
                    sg.RING_EXTRA, sg.MAX_GRID = ring, per_sm
                    if strip is not None:
                        sg.STRIPS = {2: (strip,), 4: (strip,)}
                    plan = sg.dw_plan(n, spatial, cin, cout,
                                      x.element_size(), k)
                    strip = plan["strip"]
                    what = (f"{name} {dname} strip {strip}, ring extra "
                            f"{ring} ({plan['stages']} slots), MAX_GRID "
                            f"{per_sm} ({plan['launches']} launches)")
                if plan["smem_bytes"] > sg.MAX_SHARED:
                    print(f"[{label}] {what}: {plan['smem_bytes']} bytes of "
                          "shared memory, skipped")
                    continue
                held(sg.shallow_dw(x, dy, transposed, k)[0], what)
                ms = chip_smoke.time_ms(
                    lambda: sg.shallow_dw(x, dy, transposed, k), 5)
                groups = plan["groups"] if transposed else plan["blocks"]
                rows.append({
                    "site": name, "dtype": dname,
                    "kernel": "shallow_dwt" if transposed else "shallow_dw",
                    "strip": strip, "ring_extra": None if transposed else ring,
                    "max_grid": None if transposed else per_sm,
                    "stages": plan.get("stages", ring),
                    "groups_per_sm": per_sm if transposed else None,
                    "t1": plan["t1"],
                    "groups": groups, "smem_bytes": plan["smem_bytes"],
                    "ms": ms})
                print(f"[{label}] {what} (t1 {plan['t1']}, {groups} groups "
                      f"or blocks, {plan['smem_bytes']} bytes): {ms:.3f} ms",
                      flush=True)
            sg.STRIPS, sg.DWT_STRIPS = default, default_t
            sg.RING_EXTRA, sg.MAX_GRID = default_extra, default_grid
            sg.DWT_STAGES, sg.SMS = default_stages, sms
            _build.use(None)
            del x, dy, ref
            torch.cuda.empty_cache()
    print(json.dumps({"card": label, "rows": rows, "parent": vs_parent}))


if __name__ == "__main__":
    main()
