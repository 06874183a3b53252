"""Find what holds the EDT row scan and K4 back: time variants of the two
kernels, each built from a copy of csrc/ with one text edit that asks one
question, beside this tree's build, on the same inputs. Not part of the
library: run it alone on the card, from the repository root,

    python3 ctseg_tpu_torch/csrc/tools/variants_scan_k4.py

It prints the card's name and power limit, a fill of K4's output and a copy
of the crop's bytes (the memory's own pace), then two rounds of one line per
variant: device milliseconds (CUDA events, mean of 20 launches after a
warm-up) of K4 from (128, 280, 280) to 256 with train-step draws, or of the
label scan of the Model M step's 128 label maps (C = 9) and the mask scan of
one evaluation batch's 1,152 surfaces (chip_smoke.py's inputs), and whether
the variant still equals the plain version. It stops before it builds
anything if an edit no longer matches the sources: each variant asks its
question of the kernels as they are, so an edit to either kernel that moves
a variant's text must carry the variant along.
"""

import shutil
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[3]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from ctseg_tpu_torch.ops import _build, edt  # noqa: E402
from ctseg_tpu_torch.ops import preprocess as k4  # noqa: E402
from ctseg_tpu_torch.transforms import augment  # noqa: E402

DIV = "  const float q0 = __fmul_rn(a, y);\n"
K4_VARIANTS = {
    "this tree": [],
    # the IEEE division (a reciprocal and a range check on the slow pipe)
    "ieee division": [(DIV, "  return __fdiv_rn(a, b);\n" + DIV)],
    # what the divisions cost at all
    "products, no division": [(DIV, "  return a * y;\n" + DIV)],
    # what the tile's moves cost: the value, no window
    "no arithmetic": [(
        "          win[ch] = div_rn(shifted - mean[ch], sd[ch], rsd[ch]);",
        "          win[ch] = v;")],
    # the range check in every division: the compiler predicates the
    # inlined IEEE division, so every pixel pays both
    "range check inline": [(DIV, "  if (!(fabsf(a) >= 0x1p-64f && fabsf(a) "
                                 "<= 0x1p64f)) return __fdiv_rn(a, b);\n"
                            + DIV)],
    # the clamp by compares and selects instead of max.NaN / min.NaN
    "clamp by selects": [("  float r;\n  asm(", "  return v < lo ? lo : "
                          "(v > hi ? hi : v);\n  float r;\n  asm(")],
}
SCANS = '''  int last = s != 0u ? j0 + 31 - __clz(s) : -kFar;  // the lane's own
  int first = s != 0u ? j0 + __ffs(s) - 1 : kFar;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {  // inclusive scans across the lanes
    const int up = __shfl_up_sync(kFull, last, o);
    const int down = __shfl_down_sync(kFull, first, o);
    if (lane >= o) last = max(last, up);
    if (lane < 32 - o) first = min(first, down);
  }
  const int seg_last = max(__shfl_sync(kFull, last, 31), last_in);
  // The nearest sites in the lanes before and after this one.
  int before = __shfl_up_sync(kFull, last, 1);
  int after = __shfl_down_sync(kFull, first, 1);
  before = lane == 0 ? last_in : max(before, last_in);
  after = lane == 31 ? next_in : min(after, next_in);
'''
BALLOT = '''  const unsigned lanes = __ballot_sync(kFull, s != 0u);
  const unsigned below = lanes & ((1u << lane) - 1u);
  const unsigned above = lanes & ~(kFull >> (31 - lane));
  const int lb = 31 - __clz(below), la = __ffs(above) - 1;
  const int lh = 31 - __clz(lanes);
  const unsigned sb = __shfl_sync(kFull, s, lb & 31);
  const unsigned sa = __shfl_sync(kFull, s, la & 31);
  const unsigned sh = __shfl_sync(kFull, s, lh & 31);
  const int base = j0 - lane * kV;
  int before = below != 0u ? base + lb * kV + 31 - __clz(sb) : last_in;
  int after = above != 0u ? base + la * kV + __ffs(sa) - 1 : next_in;
  const int seg_last = lanes != 0u ? base + lh * kV + 31 - __clz(sh) : last_in;
'''
STORES = ("      o[0] = make_float4(d2[0], d2[1], d2[2], d2[3]);\n"
          "      o[1] = make_float4(d2[4], d2[5], d2[6], d2[7]);")
SCAN_VARIANTS = {
    "this tree": [],
    # a ballot and three shuffles in place of the two 5-step scans
    "ballot": [(SCANS, BALLOT)],
    # streaming (evict-first) stores
    "streaming stores": [(STORES, STORES.replace(
        "o[0] = make_float4(", "__stcs(o, make_float4(").replace(
        "o[1] = make_float4(", "__stcs(o + 1, make_float4(").replace(
        "]);", "]));"))],
    # two classes at a time for the scheduler
    "classes unrolled by 2": [(
        "  for (int c = 0; c < classes; ++c) {",
        "#pragma unroll 2\n  for (int c = 0; c < classes; ++c) {")],
    # at most 40 registers, 6 blocks (48 warps) an SM
    "6 blocks an SM": [(
        "__launch_bounds__(32 * kScanWarps)\n    row_scan_kernel",
        "__launch_bounds__(32 * kScanWarps, 6)\n    row_scan_kernel")],
    # blocks of 4 warps
    "4 warps a block": [("constexpr int kScanWarps = 8;",
                         "constexpr int kScanWarps = 4;")],
}


def edited(name, source, edits):
    """`source`'s text with `edits` applied; SystemExit if one no longer
    matches it exactly once."""
    text = (_build.CSRC / source).read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"variant {name!r}: its edit no longer matches "
                             f"csrc/{source} once; bring it up to date")
        text = text.replace(old, new)
    return text


def build(name, source, text):
    """A copy of csrc/ under _build/ with `source` replaced by `text`,
    built and loaded; this tree's own build for the variant "this tree"."""
    if text is None:
        return _build.library()
    tag = "".join(ch if ch.isalnum() else "_" for ch in name)
    csrc = _build.BUILD_ROOT / "variants" / tag / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(_build.CSRC, csrc)
    (csrc / source).write_text(text)
    return _build.build(csrc.parent / "lib", csrc)


def main():
    texts = [(n, "preprocess.cu", edited(n, "preprocess.cu", e) if e else None)
             for n, e in K4_VARIANTS.items()]
    texts += [(n, "edt.cu", edited(n, "edt.cu", e) if e else None)
              for n, e in SCAN_VARIANTS.items()]
    print(chip_smoke.card_label())
    libs = [build(n, src, text) for n, src, text in texts]
    k4_libs = dict(zip(K4_VARIANTS, libs[:len(K4_VARIANTS)]))
    scan_libs = dict(zip(SCAN_VARIANTS, libs[len(K4_VARIANTS):]))
    n, raw, size = chip_smoke.TRAIN_BATCH, chip_smoke.RAW, chip_smoke.SIZE
    gen = torch.Generator(device="cuda").manual_seed(0)
    images = torch.randn((n, raw, raw), generator=gen, device="cuda") * 600 + 100
    draws = augment.draw_degree2(gen, n, raw, raw, size)
    k4_plain = k4.window_normalize_degree2_plain(images, draws, size)
    labels = chip_smoke._step_labels()
    surfaces, spacing = chip_smoke._eval_surfaces(5)
    masks = surfaces.reshape(-1, size, size).contiguous()
    scale = spacing.expand(2, chip_smoke.EVAL_BATCH, 9, 2).reshape(-1, 2)
    scale = scale[:, 1].contiguous()
    d2_plain = edt.label_scan_plain(labels, 10)[0]
    masks_plain = edt.row_scan_plain(masks, scale)
    out = torch.empty_like(k4_plain)
    crop = images[:, :size, :size].contiguous()
    t = chip_smoke.time_ms
    print(f"fill of K4's output {t(lambda: out.fill_(1.0), 20):.4f} ms, copy "
          f"of the crop's bytes "
          f"{t(lambda: torch.empty_like(crop).copy_(crop), 20):.4f} ms")
    for rnd in range(2):
        for name, lib in k4_libs.items():
            _build.use(lib)
            same = torch.equal(
                k4.window_normalize_degree2(images, draws, size), k4_plain)
            ms = t(lambda: k4.window_normalize_degree2(images, draws, size), 20)
            print(f"round {rnd} K4 {name}: {ms:.4f} ms, equal {same}",
                  flush=True)
        for name, lib in scan_libs.items():
            _build.use(lib)
            same = (torch.equal(edt.label_scan(labels, 10)[0], d2_plain)
                    and torch.equal(edt.row_scan(masks, scale), masks_plain))
            ms9 = t(lambda: edt.label_scan(labels, 10), 20)
            msm = t(lambda: edt.row_scan(masks, scale), 20)
            print(f"round {rnd} scan {name}: labels {ms9:.4f} ms, masks "
                  f"{msm:.4f} ms, equal {same}", flush=True)
    _build.use(None)


if __name__ == "__main__":
    main()
