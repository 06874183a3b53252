"""The arithmetic of the redesigned EDT row scan and K4, and the two faults
repaired beside them.

The CUDA kernels run only on the card (chip_smoke.py holds them to their
plain versions there, K4 at every float32 input value). What they compute
differently from the plain versions is modelled in plain PyTorch beside
them, and held here, on the CPU, with inputs made by numpy from a seed:

  - `edt.row_scan_lanes_model` / `label_scan_lanes_model` (segments of 32
    lanes x LANE_ELEMS elements, the lanes' last and first sites, the two
    5-step warp scans, the carries between segments, d as a float from the
    mantissa of 2^23 + d) against `row_scan_plain`, `label_scan_plain` and
    the JAX package's `_scan_distance_1d` / `edt_squared`: equal bit for
    bit at widths 1 to MAX_W, for every label type, with a class missing,
    an empty map, a class filling rows, sites only at the rows' ends and
    per-map spacings.
  - `preprocess.tile_origin` and `window_normalize_tiles_model` (the square
    of the crop a tile reads, the padded buffer, the mapped reads, the
    staged rows) against `window_normalize_degree2_plain` and the JAX
    degree-2 chain, over all 8 (k, flip) pairs, ragged and whole tiles,
    identity draws and draws that leave the slice.
  - `preprocess.div_rn_model`, K4's quotient from the correctly rounded
    reciprocal and two fused corrections, against the true division, and
    the fused multiply-add model against exact rational arithmetic.
  - the text edits of csrc/tools/variants_scan_k4.py, each still matching
    the kernel it edits.
"""

import functools
import importlib.util
import re
from argparse import ArgumentParser
from fractions import Fraction
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctseg_tpu.ops import edt as jax_edt
from ctseg_tpu.ops.pallas import preprocess as jax_preprocess
from ctseg_tpu.training import cli as jax_cli
from ctseg_tpu.transforms import pipelines as jax_pipelines
from ctseg_tpu_torch.ops import edt
from ctseg_tpu_torch.ops import preprocess as k4
from ctseg_tpu_torch.training import cli
from ctseg_tpu_torch.transforms.augment import Degree2Draws
from ctseg_tpu_torch.transforms.pipelines import get_transform

BIG32 = float(np.float32(1e12))
CSRC = Path(edt.__file__).resolve().parent.parent / "csrc"
CHANGES = Path(__file__).resolve().parent.parent / "CHANGES.md"


def _rng(seed):
    return np.random.default_rng(seed)


# ------------------------------------------------------------ the row scan
def _sites(seed, rows, w, density):
    sites = _rng(seed).random((rows, w)) < density
    sites[0] = False                      # a row with no site
    if rows > 1:
        sites[1] = True                   # a row of sites only
    if rows > 2:
        sites[2] = False
        sites[2, [0, w - 1]] = True       # sites at the two ends only
    return torch.from_numpy(sites)


def _jax_d2(sites, scale=None):
    """The JAX package's squared distances along the rows."""
    g = np.asarray(jax_edt._scan_distance_1d(jnp.asarray(sites.numpy())))
    if scale is not None:
        g = g * scale.numpy()[:, None]
    return np.minimum(g * g, np.float32(BIG32))


WIDTHS = [1, 7, 31, 32, 33, 255, 256, 257, 1000]


@pytest.mark.parametrize("density", [0.002, 0.05, 0.5])
@pytest.mark.parametrize("w", WIDTHS)
def test_row_scan_model_is_bit_equal_to_plain_and_jax(w, density):
    sites = _sites(w, 6, w, density)
    ours = edt.row_scan_lanes_model(sites)
    assert ours.dtype == torch.float32 and ours.shape == (6, w)
    assert torch.equal(ours, edt.row_scan_plain(~sites[None])[0])
    np.testing.assert_array_equal(ours.numpy(), _jax_d2(sites))
    assert float(ours[0].min()) == BIG32 and float(ours[1].max()) == 0.0


@pytest.mark.parametrize("w", [33, 256, 1000])
def test_row_scan_model_with_per_map_spacings_matches_jax(w):
    rng = _rng(w)
    sites = _sites(w + 1, 5, w, 0.03)
    scale = torch.from_numpy(rng.uniform(0.3, 3.0, 5).astype(np.float32))
    ours = edt.row_scan_lanes_model(sites, scale)
    plain = edt.row_scan_plain((~sites)[:, None], scale)[:, 0]
    assert torch.equal(ours, plain)
    for i in range(5):
        ref = np.asarray(jax_edt.edt_squared(
            jnp.asarray(~sites[i].numpy()), jnp.asarray(scale[i:i + 1].numpy())))
        np.testing.assert_array_equal(ours[i].numpy(), ref)


def test_row_scan_model_at_the_longest_row():
    sites = _sites(3, 4, edt.MAX_W, 0.0005)
    ours = edt.row_scan_lanes_model(sites)
    assert torch.equal(ours, edt.row_scan_plain(~sites[None])[0])
    # sites at the two ends only: the carries cross all 96 segments
    d = np.float32(edt.MAX_W // 2 - 1)
    assert float(ours[2, edt.MAX_W // 2 - 1]) == float(d * d)


def _label_maps(seed, shape):
    labels = _rng(seed).integers(0, 10, size=shape).astype(np.uint8)
    labels[1][labels[1] == 3] = 0    # a class missing from one sample
    labels[2] = 0                    # a sample with background only
    labels[0, 2:4] = 7               # a class that fills rows
    labels[3] = 0
    labels[3, :, [0, -1]] = 5        # sites at the rows' ends only
    return labels


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32, torch.int64,
                                   torch.bool])
@pytest.mark.parametrize("w", [31, 256, 257, 600])
def test_label_scan_model_is_bit_equal_to_plain(w, dtype):
    labels = torch.from_numpy(_label_maps(w, (4, 6, w)))
    labels = labels == 7 if dtype == torch.bool else labels.to(dtype)
    d2, nonempty = edt.label_scan_lanes_model(labels, 10)
    pd2, pnonempty = edt.label_scan_plain(labels, 10)
    assert d2.shape == (2, 4, 9, 6, w)
    assert torch.equal(d2, pd2) and torch.equal(nonempty, pnonempty)
    if dtype != torch.bool:
        assert not nonempty[2].any() and not nonempty[1, 2]
        assert float(d2[0, 0, 6, 2].max()) == 0.0       # rows 7 fills
        assert float(d2[1, 0, 6, 2].min()) == BIG32


def test_label_scan_model_matches_jax_step_counts():
    labels = _label_maps(9, (4, 5, 300))
    d2, _ = edt.label_scan_lanes_model(torch.from_numpy(labels), 10)
    for c in range(9):
        pos = torch.from_numpy(labels == c + 1).reshape(-1, 300)
        for sign, sites in enumerate((pos, ~pos)):
            np.testing.assert_array_equal(
                d2[sign, :, c].reshape(-1, 300).numpy(), _jax_d2(sites))


def _cuda_constant(source, name):
    m = re.search(rf"constexpr int {name} = ([^;]+);", source)
    return eval(m.group(1), {"kV": edt.LANE_ELEMS})  # noqa: S307


def test_scan_model_constants_are_the_kernels():
    source = (CSRC / "edt.cu").read_text()
    assert _cuda_constant(source, "kV") == edt.LANE_ELEMS
    assert _cuda_constant(source, "kSeg") == edt.SEGMENT == 256
    assert _cuda_constant(source, "kMaxW") == edt.MAX_W
    assert edt.MAX_W % edt.SEGMENT == 0
    assert _cuda_constant(source, "kFar") == edt._FAR
    assert _cuda_constant(source, "kNoSite") == edt._NO_SITE
    # every row the wrapper takes stays clear of the sentinels
    assert edt._FAR + edt.MAX_W < 2**31 and edt.MAX_W < edt._NO_SITE


# -------------------------------------------------------------------- K4
def _images(seed, n, h, w):
    return torch.from_numpy(
        _rng(seed).uniform(-1200, 2200, size=(n, h, w)).astype(np.float32))


def _every_pair_draws(seed, n, h, size):
    rng = _rng(seed)
    i = torch.arange(n, dtype=torch.int32)
    return Degree2Draws(
        torch.from_numpy(rng.integers(0, h - size + 1, n).astype(np.int32)),
        torch.from_numpy(rng.integers(0, h - size + 1, n).astype(np.int32)),
        i % 4, (i // 4) % 2)


@pytest.mark.parametrize("size", [256, 200, 64, 37, 1])
@pytest.mark.parametrize("k,flip", [(k, f) for k in range(4) for f in (0, 1)])
def test_tile_origin_bounds_every_tile_source(k, flip, size):
    """A tile's sources are one tile x tile square at tile_origin: every
    pixel of the tile, ragged ones too, reads inside the square (so the
    kernel's buffer read never leaves it), and a whole tile reads all of
    it once."""
    tile = k4.TILE
    a = torch.arange(tile)
    for i0 in range(0, size, tile):
        for j0 in range(0, size, tile):
            r0, c0 = k4.tile_origin(k, flip, i0, j0, size, tile)
            r, c = k4.source_pixel(k, flip, i0 + a[:, None], j0 + a[None, :],
                                   size)
            dr, dc = r - r0, c - c0
            assert int(dr.min()) == 0 and int(dr.max()) == tile - 1
            assert int(dc.min()) == 0 and int(dc.max()) == tile - 1
            cells = (dr * tile + dc).flatten()
            assert len(set(cells.tolist())) == tile * tile
            valid = ((i0 + a[:, None] < size) & (j0 + a[None, :] < size))
            inside = (r >= 0) & (r < size) & (c >= 0) & (c < size)
            assert bool(inside[valid].all())


@pytest.mark.parametrize("size,h", [(256, 280), (200, 230), (64, 64),
                                    (37, 50)])
def test_k4_tiles_model_is_bit_equal_to_plain(size, h):
    images = _images(size, 8, h, h)
    draws = _every_pair_draws(size + 1, 8, h, size)
    ours = k4.window_normalize_tiles_model(images, draws, size)
    plain = k4.window_normalize_degree2_plain(images, draws, size)
    assert ours.shape == (8, size, size, 3)
    assert torch.equal(ours, plain)


def test_k4_tiles_model_matches_the_jax_degree2_chain():
    n, h, w, size = 16, 40, 40, 32
    images = _images(7, n, h, w)
    keys = jax.random.split(jax.random.key(12), n)
    draws = []
    for key in keys:  # the parameters pipelines._degree_2 draws (augment.py)
        k1, k2, k3 = jax.random.split(key, 3)
        kh, kw = jax.random.split(k1)
        kp, kk = jax.random.split(k2)
        draws.append((
            int(jax.random.randint(kh, (), 0, h - size + 1)),
            int(jax.random.randint(kw, (), 0, w - size + 1)),
            int(jnp.where(jax.random.bernoulli(kp, 0.5),
                          jax.random.randint(kk, (), 0, 4), 0)),
            int(jax.random.bernoulli(k3, 0.5))))
    draws = Degree2Draws(*(torch.tensor(v, dtype=torch.int32)
                           for v in zip(*draws)))
    ref, _ = jax.vmap(functools.partial(jax_pipelines._degree_2,
                                        size=(size, size)))(
        keys, jnp.asarray(images.numpy()),
        jnp.zeros((n, h, w), jnp.int32))
    ours = k4.window_normalize_tiles_model(images, draws, size)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=2e-7,
                               atol=2e-7)


def test_k4_tiles_model_with_identity_draws_is_fused_window_normalize():
    images = _images(8, 3, 48, 48)
    ours = k4.window_normalize_tiles_model(images, k4.identity_draws(3), 48)
    assert torch.equal(ours, k4.window_normalize_degree2_plain(
        images, k4.identity_draws(3), 48))
    ref = np.asarray(jax_preprocess.fused_window_normalize(
        jnp.asarray(images.numpy()), interpret=True))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=2e-7, atol=2e-7)


def test_k4_tiles_model_gives_nan_where_a_draw_leaves_the_slice():
    n, h, size = 8, 40, 32
    images = _images(9, n, h, h)
    i = torch.arange(n, dtype=torch.int32)
    draws = Degree2Draws(torch.full_like(i, h - size + 5),
                         torch.full_like(i, -3), i % 4, (i // 4) % 2)
    ours = k4.window_normalize_tiles_model(images, draws, size)
    padded = torch.full((n, h + 5, h + 3), float("nan"))
    padded[:, :h, 3:] = images
    want = k4.window_normalize_degree2_plain(
        padded, draws._replace(left=draws.left + 3), size)
    nan = torch.isnan(want)
    assert bool(nan.any()) and torch.equal(torch.isnan(ours), nan)
    assert torch.equal(ours[~nan], want[~nan])


def test_k4_model_takes_ieee_divisions_below_two_to_the_minus_64():
    tiny = torch.tensor([1e-45, -1e-45, 2.0 ** -70, 1e-30, 0.0, -0.0, 2.0 ** -64,
                         float("nan"), float("inf"), -float("inf")] * 103,
                        dtype=torch.float32)[:1024].reshape(1, 32, 32)
    ours = k4.window_normalize_tiles_model(tiny, k4.identity_draws(1), 32)
    plain = k4.window_normalize_degree2_plain(tiny, k4.identity_draws(1), 32)
    same = (ours == plain) | (torch.isnan(ours) & torch.isnan(plain))
    assert bool(same.all())


def _numerators(seed, lo, hi):
    """Random float32 bit patterns in [lo, hi] of both signs, and random
    values of that span."""
    rng = _rng(seed)
    bits = np.array([lo, hi], np.float32).view(np.int32)
    a = rng.integers(bits[0], bits[1], 400_000).astype(np.int32).view(
        np.float32)
    b = rng.uniform(-hi, hi, 200_000).astype(np.float32)
    return torch.from_numpy(np.concatenate(
        [a, -a, b, [0.0, -0.0, lo, hi]]).astype(np.float32))


@pytest.mark.parametrize("window", range(3))
@pytest.mark.parametrize("which", ["den", "std"])
def test_div_rn_model_is_the_true_division(window, which):
    p = k4._params(torch.device("cpu"))[window]
    b, y = (p[2], p[5]) if which == "den" else (p[4], p[6])
    assert float(y) == float(torch.tensor(1.0) / b)  # RN(1 / b)
    a = _numerators(window * 2 + (which == "std"), 2.0 ** -64, 2.0 ** 64)
    assert torch.equal(k4.div_rn_model(a, b, y), a / b)
    # the numerators K4 meets: v - lo over the window, shifted - mean
    span = _numerators(7, 2.0 ** -24, float(p[1] - p[0]) if which == "den"
                       else 2.0)
    assert torch.equal(k4.div_rn_model(span, b, y), span / b)


def test_fma_model_rounds_once():
    rng = _rng(11)
    a = (rng.normal(size=3000) * 1000).astype(np.float32)
    b = rng.normal(size=3000).astype(np.float32)
    c = (-(a.astype(np.float64) * b) * (1 + rng.normal(size=3000) * 1e-7)
         ).astype(np.float32)  # near-cancelling sums: where rounding twice errs
    got = k4._fma_model(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    for x, y, z, g in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        near = np.float32(float(exact))
        cands = [np.nextafter(near, np.float32(-np.inf)), near,
                 np.nextafter(near, np.float32(np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(np.array(v).view(np.int32)) & 1))
        assert g == best


def test_k4_params_refuse_constants_the_division_cannot_take(monkeypatch):
    params = k4._params.__wrapped__(torch.device("cpu"))
    assert params.shape == (3, 7)
    assert torch.equal(params[:, 5], 1.0 / params[:, 2])
    monkeypatch.setattr(k4, "STACKED_WINDOW_MEAN", (0.107, 0.0, 0.085))
    with pytest.raises(ValueError, match="cannot divide exactly"):
        k4._params.__wrapped__(torch.device("cpu"))


def test_k4_params_refuse_a_mean_that_lifts_a_numerator_past_2_64(
        monkeypatch):
    monkeypatch.setattr(k4, "STACKED_WINDOW_MEAN", (0.107, 2.0 ** 31, 0.085))
    with pytest.raises(ValueError, match="cannot divide exactly"):
        k4._params.__wrapped__(torch.device("cpu"))


@pytest.mark.parametrize("name,source,variants", [
    ("K4", "preprocess.cu", "K4_VARIANTS"),
    ("scan", "edt.cu", "SCAN_VARIANTS")])
def test_the_variants_tools_edits_match_the_kernels(name, source, variants):
    """csrc/tools/variants_scan_k4.py times kernels built from text edits of
    the sources; each edit must still find its text exactly once."""
    spec = importlib.util.spec_from_file_location(
        "variants_scan_k4", CSRC / "tools" / "variants_scan_k4.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    table = getattr(tool, variants)
    assert len(table) > 1
    for variant, edits in table.items():
        if edits:
            assert tool.edited(variant, source, edits) != (
                CSRC / source).read_text()


def test_k4_constants_are_the_kernels():
    source = (CSRC / "preprocess.cu").read_text()
    assert _cuda_constant(source, "kParams") == k4._params(
        torch.device("cpu")).shape[1] == 7
    assert _cuda_constant(source, "kTile") == k4.TILE


# --------------------------------------------------- the repaired faults
@pytest.mark.parametrize("degree", [0, 1, 3, 4])
def test_other_train_degrees_name_their_changes_entry(degree):
    """The train transforms of degrees 0, 1, 3 and 4 are ported, and the
    CHANGES.md entry that ported them (append-only, where ROADMAP.md is
    rewritten) says so."""
    transform = get_transform(degree, train=True, size=(16, 16))
    images = torch.zeros((2, 20, 20))
    draws = transform.draw(torch.Generator().manual_seed(0), images.shape)
    img, lab = transform(images, torch.zeros((2, 20, 20), dtype=torch.uint8),
                         draws)
    assert img.shape == (2, 16, 16, 1 if degree == 0 else 3)
    assert lab.shape == (2, 16, 16)
    assert re.search(r"^- PR \d+ \(bring_up\): .*Train transforms of degrees "
                     r"0, 1, 3 and 4 \(`transforms/augment\.py`",
                     CHANGES.read_text(), re.MULTILINE)


def test_train_cli_help_says_its_degree_default_differs(capsys):
    """It no longer differs: the port's default degree is the reference's
    0, and the help has lost its note that only degree 2 trains."""
    ours, ref = ArgumentParser(), ArgumentParser()
    cli._add_args(ours)
    jax_cli._add_common_args(ref)
    assert ours.parse_args([]).transform_degree == 0
    assert ref.parse_args([]).transform_degree == 0
    with pytest.raises(SystemExit):
        cli.main(["train", "--help"])
    text = " ".join(capsys.readouterr().out.split())
    assert "degree 2 only" not in text and "the reference's is 0" not in text
    assert "--transform_degree" in text
