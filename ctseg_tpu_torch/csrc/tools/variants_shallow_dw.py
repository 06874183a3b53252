"""Find what holds the transposed conv's weight gradient back: time
variants of its kernel, each built from a copy of csrc/ with one text edit
that asks one question, beside this tree's build, on the same inputs. Not
part of the library: run it alone on the card, from the repository root,

    python3 ctseg_tpu_torch/csrc/tools/variants_shallow_dw.py [--rounds 2]
        [--old-map DIR]

The variants of csrc/shallow_dwt.cu (DWT_VARIANTS):
  - "this tree": the kernel as it is;
  - "staging only": the copies of every strip, no products;
  - "compute only": the products on whatever the buffers hold, no copies;
  - "no db": no warp sums db from its dy fragments;
  - "no products": each tensor-core product replaced by one add;
  - "no dy loads" (bfloat16): the dy fragments not loaded.
With --old-map DIR, DIR a checkout of the tree before csrc/shallow_dwt.cu
(whose csrc/shallow_dw.cu still had the transposed map), the variants of
that kernel instead (OLD_MAP_VARIANTS), built from DIR's csrc/ by DIR's
ops/_build.py and called through DIR's ops/shallow_grad.py: the diagnosis
that preceded csrc/shallow_dwt.cu (PERF.md). As it is, staging only,
compute only, and "window once per strip": only the blocks of the first
Cin tile stage the dy window, the others compute on the window they last
held.

Every variant but "this tree" gives wrong sums; it is for timing only. It
prints the card's name and power limit, then for each round one line a
variant, site and type: device milliseconds (`chip_smoke.time_ms`, 5 calls
after a warm-up) at chip_smoke.py's transposed SHALLOW_SITES, each at its
own batch, and whether the variant still equals this tree's dW. The last
line is one JSON object: {"card", "rows": [{"variant", "site", "dtype",
"round", "ms", "equal"}]}. It stops before it builds anything if an edit no
longer matches the source: each variant asks its question of the kernel as
it is, so an edit that moves a variant's text must carry the variant along.
"""

import argparse
import importlib.util
import json
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
OLD_MAP_SOURCE = "shallow_dw.cu"
OLD_MAP_VARIANTS = {
    "this tree": [],
    # the strips' copies alone: no warp hands a strip to its products
    "staging only": [("    if (live) {\n      const uint32_t* sb_buf",
                      "    if (false) {\n      const uint32_t* sb_buf")],
    # the products alone, on whatever the buffers hold
    "compute only": [("  const Strip st = strip_at<kTiled>(g, qb);\n",
                      "  if (g.n > 0) return;\n"
                      "  const Strip st = strip_at<kTiled>(g, qb);\n")],
    # the dy window staged once a strip (by the first Cin tile's blocks)
    # instead of once a Cin tile
    "window once per strip": [(
        "  const int rows = g.tb0 * g.r1max * g.w2;\n",
        "  const int rows = c0x != 0 ? 0 : g.tb0 * g.r1max * g.w2;\n")],
}


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


def load_checkout(root):
    """(ops/_build.py, ops/shallow_grad.py) of the checkout `root`, the
    second launching from the first's library."""
    def load(name, path):
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    ops = root / "ctseg_tpu_torch" / "ops"
    build_mod = load("old_map_build", ops / "_build.py")
    sg = load("old_map_shallow_grad", ops / "shallow_grad.py")
    sg._build = build_mod
    return build_mod, sg


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--old-map", type=Path, default=None,
                        help="a checkout of the tree before "
                        "csrc/shallow_dwt.cu: time its transposed map")
    args = parser.parse_args()

    import torch
    from ctseg_tpu_torch.models.layers import channels_last

    if not torch.cuda.is_available():
        sys.exit("variants_shallow_dw: no CUDA card")
    if args.old_map is None:
        from ctseg_tpu_torch.ops import shallow_grad as sg
        build_mod, source, variants = _build, DWT_SOURCE, DWT_VARIANTS
    else:
        build_mod, sg = load_checkout(args.old_map.resolve())
        source, variants = OLD_MAP_SOURCE, OLD_MAP_VARIANTS
    texts = {n: edited(n, e, build_mod.CSRC, source) if e else None
             for n, e in variants.items()}
    label = chip_smoke.card_label()
    print(label, flush=True)
    with ThreadPoolExecutor(len(texts)) as pool:
        libs = dict(zip(texts, pool.map(
            lambda nt: build(*nt, build_mod, source), texts.items())))
    gen = torch.Generator(device=chip_smoke.DEVICE).manual_seed(0)
    rows = []
    for name, transposed, n, spatial, cin, cout in chip_smoke.SHALLOW_SITES:
        if not transposed:
            continue
        osp = tuple(2 * e for e in spatial)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).removeprefix("torch.")
            x = channels_last(torch.randn((n, cin) + spatial, generator=gen,
                                          device=chip_smoke.DEVICE).to(dtype))
            dy = channels_last(torch.randn((n, cout) + osp, generator=gen,
                                           device=chip_smoke.DEVICE).to(dtype))
            build_mod.use(libs["this tree"])
            ref, _ = sg.shallow_dw(x, dy, True)
            for rnd in range(args.rounds):
                for variant, lib in libs.items():
                    build_mod.use(lib)
                    dw, _ = sg.shallow_dw(x, dy, True)
                    same = torch.equal(dw, ref)
                    ms = chip_smoke.time_ms(lambda: sg.shallow_dw(x, dy, True),
                                            5)
                    rows.append({"variant": variant, "site": name,
                                 "dtype": dname, "round": rnd, "ms": ms,
                                 "equal": same})
                    print(f"[{label}] round {rnd} {variant}: {name}, {dname}:"
                          f" {ms:.3f} ms, equal {same}", flush=True)
            del x, dy, ref, dw
            torch.cuda.empty_cache()
    build_mod.use(None)
    print(json.dumps({"card": label, "rows": rows}))


if __name__ == "__main__":
    main()
