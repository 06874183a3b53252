"""Find what holds a shallow weight-gradient kernel back: time variants of
it, each built from a copy of csrc/ with one text edit that asks one
question, beside the kernel as it is, on the same inputs. Not part of the
library: run it alone on the card, from the repository root,

    python3 ctseg_tpu_torch/csrc/tools/variants_shallow_dw.py [--rounds 2]
        [--map transposed|stride1|step0] [--parent DIR]
        [--variants NAME ...]

--map transposed (the default): csrc/shallow_dwt.cu at chip_smoke.py's
transposed SHALLOW_SITES (DWT_VARIANTS):
  - "this tree": the kernel as it is;
  - "staging only": the copies of every strip, no products;
  - "compute only": the products on whatever the buffers hold, no copies;
  - "no db": no warp sums db from its dy fragments;
  - "no products": each tensor-core product replaced by one add;
  - "no dy loads" (bfloat16): the dy fragments not loaded.
--map stride1: csrc/shallow_dw.cu at the stride-1 site (S1_VARIANTS):
  - "this tree";
  - "staging only": the stagers fill the ring, the computing warps take no
    product and no db;
  - "compute only": the stagers copy nothing, the products and db run on
    whatever the ring holds;
  - "no db": no block sums db;
  - "unroll 2", "unroll 16": float32's voxel loop unrolled by 2 or 16
    instead of 8;
  - "outside rows skipped": the stagers skip the x rows outside the
    tensor's w and d and the dy rows past the unit, which then hold the
    zeros written when the block started (right only where a block owns
    one unit, as at the site), instead of writing them as zeros;
  - "a field after rpl", "divisors first": the kernel's parameter struct
    (Geom) laid out otherwise, its work unchanged (one int more after
    `rpl`; the FastDiv divisors first): how much of a time is code
    generation;
  - "one unit a block": the stagers' and computing warps' walks end after
    the block's first unit (right only where a block owns one unit).
--variants NAME ...: only these variants of the map (with the first, the
kernel as it is, whose dW each is held to).
--map step0 --parent DIR, DIR a checkout of the tree whose
csrc/shallow_dw.cu is the first stride-1 kernel (the commit before the
ring-of-planes kernel, e.g. `git archive` of it unpacked under
ctseg_tpu_torch/_build/parent): that
kernel's variants (S1_STEP0_VARIANTS), built from DIR's csrc/ by DIR's
ops/_build.py and called through DIR's ops/shallow_grad.py, the diagnosis
that preceded this tree's kernel (PERF.md):
  - "as it is"; "staging only"; "compute only";
  - "one kh block stages": of the 3 blocks (one a kh) that stage each strip,
    only kh 0's copy; the others compute on what their buffers hold;
  - "no db";
  - "float32 tile 10 x 6": the 10 -> 10 conv's float32 warps take 10 x 6
    accumulators a lane instead of 10 x 10 (two Cin tiles; the plan's
    `tiles` patched to match), the instance without spills.

Every variant but "this tree" / "as it is" gives wrong sums; it is for
timing only. It prints the card's name and power limit, ptxas's registers
and spill bytes of every instance of the map's kernels in each variant's
build, then for each round one line a variant, site and type: device
milliseconds (`chip_smoke.time_ms`, 5 calls after a warm-up) at the site's
own batch, and whether the variant still equals the unedited kernel's dW.
The last line is one JSON object: {"card", "ptxas": {variant: [{"kernel",
"registers", "spill_stores", "spill_loads"}]}, "rows": [{"variant", "site",
"dtype", "round", "ms", "equal"}]}. It stops before it builds anything if
an edit no longer matches the source: each variant asks its question of
the kernel as it is, so an edit that moves a variant's text must carry the
variant along.
"""

import argparse
import importlib.util
import json
import re
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from ctseg_tpu_torch.ops import _build  # noqa: E402

DWT_SOURCE = "shallow_dwt.cu"
DWT_VARIANTS = {
    "this tree": [],
    # the strips' copies alone: the consumers take no k-step
    "staging only": [("    const int nk = (nq + 15) >> 4;\n",
                      "    const int nk = 0 * nq;\n")],
    # the products alone, on whatever the buffers hold
    "compute only": [("  const Strip st = strip_at(g, qb);\n  const int nq16",
                      "  if (g.n > 0) return;\n"
                      "  const Strip st = strip_at(g, qb);\n  const int nq16")],
    # db's sums
    "no db": [("  const int npair = db_block ? kWarps / g.n_ct : 0;\n",
               "  const int npair = 0;\n")],
    # the tensor-core products, each replaced by one add of its operands
    "no products": [
        ("          mma_bf16(acc[t], a, b[t][0], b[t][1]);\n"
         "          mma_bf16(acc[t] + 4, a, b[t][2], b[t][3]);\n",
         "          acc[t][0] += __uint_as_float(a[0] ^ b[t][0] ^ b[t][1]);"
         "\n"
         "          acc[t][4] += __uint_as_float(a[1] ^ b[t][2] ^ b[t][3]);"
         "\n"),
        ("              mma_tf32(acc[t] + 4 * n8, as[h], bb0, bb1);\n"
         "              mma_tf32(acc[t] + 4 * n8, ab[h], bs0, bs1);\n"
         "              mma_tf32(acc[t] + 4 * n8, ab[h], bb0, bb1);\n",
         "              acc[t][4 * n8] += __uint_as_float(\n"
         "                  as[h][0] ^ ab[h][1] ^ bb0 ^ bb1 ^ bs0 ^ bs1);\n")],
    # the dy fragments' shared-memory loads (bfloat16: ldmatrix), each
    # replaced by a copy of the x fragment
    "no dy loads": [(
        "          ldmatrix_x4_trans(brow + toff[t], b[t]);\n",
        "          b[t][0] = a[0] ^ toff[t];\n          b[t][1] = a[1];\n"
        "          b[t][2] = a[2] + (brow != ds);\n          b[t][3] = a[3];\n")],
}
S1_SOURCE = "shallow_dw.cu"
S1_UNROLL = "#pragma unroll 8\n      for (int v = warp * slots + j;"
S1_UNIT_END = ("    release_tail(g, empty, it);\n  }\n  bar_sync(1, kConsumers);  "
               "// every computing warp is done with the ring\n")
S1_VARIANTS = {
    "this tree": [],
    # the ring filled, nothing computed from it
    "staging only": [("      const int nq = u.nq;\n",
                      "      const int nq = 0 * u.nq;\n"),
                     ("      const int nk = (u.nq + 15) >> 4;\n",
                      "      const int nk = 0 * u.nq;\n")],
    # the products and db on whatever the ring holds, no copies
    "compute only": [("  const int m = u.h_lo - g.p + r.kh0 + i;\n",
                      "  if (g.n > 0) return;\n"
                      "  const int m = u.h_lo - g.p + r.kh0 + i;\n")],
    # no block sums db
    "no db": [("  r.db = r.role < g.n_cot;\n", "  r.db = false;\n")],
    # float32's voxel loop unrolled by 2 or 16 instead of 8
    "unroll 2": [(S1_UNROLL, S1_UNROLL.replace("unroll 8", "unroll 2"))],
    "unroll 16": [(S1_UNROLL, S1_UNROLL.replace("unroll 8", "unroll 16"))],
    # the rows outside the tensor left as the block's start zeroed them
    "outside rows skipped": [
        ("    const size_t vox = in ? (plane0 + w) * g.xd + d : 0;\n",
         "    if (static_cast<unsigned>(w) >= static_cast<unsigned>(g.e1) ||\n"
         "        static_cast<unsigned>(d) >= static_cast<unsigned>(g.xd))\n"
         "      continue;\n"
         "    const size_t vox = in ? (plane0 + w) * g.xd + d : 0;\n"),
        ("      off = c * g.e2 + j;\n    }\n    copy_row",
         "      off = c * g.e2 + j;\n    }\n    if (!in) continue;\n"
         "    copy_row")],
    # Geom laid out with a 4-byte field more after rpl (unused)
    "a field after rpl": [
        ("  int role0, rpl;           // this launch's first role and its roles\n",
         "  int role0, rpl;           // this launch's first role and its roles\n"
         "  int unused;\n")],
    # Geom's divisors before its pointers
    "divisors first": [
        ("  FastDiv div_td, div_dpx;\n};", "};"),
        ("struct Geom {\n", "struct Geom {\n  FastDiv div_td, div_dpx;\n")],
    # one unit a block: each walk ends after its first unit
    "one unit a block": [
        (S1_UNIT_END + "  float* mine",
         S1_UNIT_END.replace("  }\n", "    break;\n  }\n", 1)
         + "  float* mine"),
        (S1_UNIT_END + "  // The accumulators'",
         S1_UNIT_END.replace("  }\n", "    break;\n  }\n", 1)
         + "  // The accumulators'"),
        ("        }\n      }\n    }\n    ctseg::cp_async_wait<0>();",
         "        }\n      }\n      break;\n    }\n"
         "    ctseg::cp_async_wait<0>();")],
}
# Edits of the first stride-1 kernel's csrc/shallow_dw.cu (`--map step0
# --parent DIR`), and the
# plan's tiles a variant needs ((s_tile, t_tile) for the float32 10 -> 10
# conv).
S1_STEP0_VARIANTS = {
    "as it is": [],
    "staging only": [("    if (live) {\n      const uint32_t* sb_buf",
                      "    if (false) {\n      const uint32_t* sb_buf")],
    "compute only": [("  const Strip st = strip_at(g, qb);\n"
                      "  const uint32_t* bsrc = g.dy;\n",
                      "  if (g.n > 0) return;\n"
                      "  const Strip st = strip_at(g, qb);\n"
                      "  const uint32_t* bsrc = g.dy;\n")],
    "one kh block stages": [("  const Strip st = strip_at(g, qb);\n"
                             "  const uint32_t* bsrc = g.dy;\n",
                             "  if (kh != 0) return;\n"
                             "  const Strip st = strip_at(g, qb);\n"
                             "  const uint32_t* bsrc = g.dy;\n")],
    "no db": [("  w.db = w.live && w.ct == 0 && w.tap == g.taps / 2;\n",
               "  w.db = false;\n")],
    "float32 tile 10 x 6": [
        ("(s_tile == 10 && t_tile == 10)", "(s_tile == 10 && t_tile == 6)"),
        ("    case 10: return launch(shallow_dw_kernel<10, 10>, g, smem, st);",
         "    case 10: return launch(shallow_dw_kernel<10, 6>, g, smem, st);")],
}
STEP0_TILES = {"float32 tile 10 x 6": (10, 6)}


def edited(name, edits, csrc=_build.CSRC, source=DWT_SOURCE):
    """csrc/`source`'s text with `edits` applied; SystemExit if one no
    longer matches it exactly once."""
    text = (csrc / source).read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"variant {name!r}: its edit no longer matches "
                             f"{csrc / source} once; bring it up to date")
        text = text.replace(old, new)
    return text


def build(name, text, build_mod=_build, source=DWT_SOURCE):
    """A copy of build_mod's csrc/ under this tree's _build/ with `source`
    replaced by `text`, built by build_mod and loaded; build_mod's own
    library when `text` is None."""
    if text is None:
        return build_mod.library()
    tag = "".join(ch if ch.isalnum() else "_" for ch in f"{source} {name}")
    csrc = _build.BUILD_ROOT / "variants" / tag / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(build_mod.CSRC, csrc)
    (csrc / source).write_text(text)
    return build_mod.build(csrc.parent / "lib", csrc)


def ptxas(log, source):
    """[{kernel, registers, spill_stores, spill_loads}] of the kernels of
    `source` (shallow_dw.cu or shallow_dwt.cu) in an nvcc -Xptxas=-v log."""
    stem = Path(source).stem
    rows, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1) if re.search(rf"\d{stem}_", m.group(1)) else None
            if name and stem == "shallow_dw" and "shallow_dwt" in name:
                name = None
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            rows.append({"kernel": name, "spill_stores": int(m.group(1)),
                         "spill_loads": int(m.group(2))})
        m = re.search(r"Used (\d+) registers", line)
        if m and rows and rows[-1]["kernel"] == name:
            rows[-1]["registers"] = int(m.group(1))
            name = None
    return rows


def load_checkout(root):
    """(ops/_build.py, ops/shallow_grad.py) of the checkout `root`, the
    second launching from the first's library."""
    def load(name, path):
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    ops = root / "ctseg_tpu_torch" / "ops"
    build_mod = load("parent_build", ops / "_build.py")
    sg = load("parent_shallow_grad", ops / "shallow_grad.py")
    sg._build = build_mod
    return build_mod, sg


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--map", choices=("transposed", "stride1", "step0"),
                        default="transposed")
    parser.add_argument("--parent", type=Path, default=None,
                        help="with --map step0: a checkout of the tree "
                        "with the first stride-1 kernel")
    parser.add_argument("--variants", nargs="+", default=None,
                        help="only these variants of the map")
    args = parser.parse_args()

    import torch
    from ctseg_tpu_torch.models.layers import channels_last

    if not torch.cuda.is_available():
        sys.exit("variants_shallow_dw: no CUDA card")
    transposed = args.map == "transposed"
    if args.map == "step0":
        if args.parent is None:
            sys.exit("variants_shallow_dw: --map step0 needs --parent DIR")
        build_mod, sg = load_checkout(args.parent.resolve())
        source, variants = S1_SOURCE, S1_STEP0_VARIANTS
    else:
        from ctseg_tpu_torch.ops import shallow_grad as sg
        build_mod = _build
        source, variants = ((DWT_SOURCE, DWT_VARIANTS) if transposed
                            else (S1_SOURCE, S1_VARIANTS))
    if args.variants:
        unknown = set(args.variants) - set(variants)
        if unknown:
            sys.exit(f"variants_shallow_dw: no variants {sorted(unknown)}")
        first = next(iter(variants))
        variants = {n: e for n, e in variants.items()
                    if n == first or n in args.variants}
    texts = {n: edited(n, e, build_mod.CSRC, source) if e else None
             for n, e in variants.items()}
    label = chip_smoke.card_label()
    print(label, flush=True)
    with ThreadPoolExecutor(len(texts)) as pool:
        libs = dict(zip(texts, pool.map(
            lambda nt: build(*nt, build_mod, source), texts.items())))
    regs = {name: ptxas(lib.log, source) for name, lib in libs.items()}
    for name, rows in regs.items():
        for r in rows:
            print(f"[{label}] ptxas {name}: {r['kernel']}: "
                  f"{r.get('registers')} registers, {r['spill_stores']} "
                  f"bytes spill stores, {r['spill_loads']} bytes spill "
                  "loads", flush=True)
    first = next(iter(libs))
    tiles = sg.tiles
    gen = torch.Generator(device=chip_smoke.DEVICE).manual_seed(0)
    rows = []
    for name, tr, n, spatial, cin, cout in chip_smoke.SHALLOW_SITES:
        if tr != transposed:
            continue
        osp = tuple(e * (2 if tr else 1) for e in spatial)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).removeprefix("torch.")
            x = channels_last(torch.randn((n, cin) + spatial, generator=gen,
                                          device=chip_smoke.DEVICE).to(dtype))
            dy = channels_last(torch.randn((n, cout) + osp, generator=gen,
                                           device=chip_smoke.DEVICE).to(dtype))
            build_mod.use(libs[first])
            ref, _ = sg.shallow_dw(x, dy, tr)
            for rnd in range(args.rounds):
                for variant, lib in libs.items():
                    build_mod.use(lib)
                    if variant in STEP0_TILES and args.map == "step0":
                        sg.tiles = (lambda ci, co, bf16=False, v=variant:
                                    tiles(ci, co, bf16) if bf16 or co != 10
                                    else STEP0_TILES[v])
                    dw, _ = sg.shallow_dw(x, dy, tr)
                    same = torch.equal(dw, ref)
                    ms = chip_smoke.time_ms(lambda: sg.shallow_dw(x, dy, tr),
                                            5)
                    sg.tiles = tiles
                    rows.append({"variant": variant, "site": name,
                                 "dtype": dname, "round": rnd, "ms": ms,
                                 "equal": same})
                    print(f"[{label}] round {rnd} {variant}: {name}, {dname}:"
                          f" {ms:.3f} ms, equal {same}", flush=True)
            del x, dy, ref, dw
            torch.cuda.empty_cache()
    build_mod.use(None)
    print(json.dumps({"card": label, "ptxas": regs, "rows": rows}))


if __name__ == "__main__":
    main()
