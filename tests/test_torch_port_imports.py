"""The port stands alone: no JAX, no flax, no `ctseg_tpu` inside it, and its
copies of the JAX package's host modules are still equal to the originals.
"""

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import ctseg_tpu
import ctseg_tpu.constants as jax_constants
import ctseg_tpu_torch
import ctseg_tpu_torch.constants as port_constants
from ctseg_tpu.data.datasets import pack_slices as jax_pack_slices
from ctseg_tpu_torch.data.datasets import PackedDataset2D, pack_slices
from ctseg_tpu.testing.synth import make_patient as jax_make_patient
from ctseg_tpu.utils import nrrd_io as jax_nrrd_io
from ctseg_tpu.utils.miccai import CropBox as JaxCropBox
from ctseg_tpu.utils.miccai import Volume as JaxVolume
from ctseg_tpu_torch.testing.synth import make_patient
from ctseg_tpu_torch.utils import nrrd_io
from ctseg_tpu_torch.utils.miccai import CropBox, Volume

PKG = Path(ctseg_tpu_torch.__file__).resolve().parent
REPO = PKG.parent

_PROBE = """
import json, pkgutil, sys
before = set(sys.modules)
import ctseg_tpu_torch
import ctseg_tpu_torch.inference.serve
import ctseg_tpu_torch.training.cli
for m in pkgutil.walk_packages(ctseg_tpu_torch.__path__, "ctseg_tpu_torch."):
    __import__(m.name)
new = set(sys.modules) - before
print(json.dumps(sorted(new)))
"""


def test_importing_the_port_loads_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
        text=True, timeout=300, check=True,
    ).stdout
    new = json.loads(out.strip().splitlines()[-1])
    for module in ("inference.serve", "training.cli", "training.trainer",
                   "ops.preprocess", "losses.segmentation", "metrics.dice",
                   "data.pipeline", "data.datasets", "paths", "ops.min_plus",
                   "ops.edt", "metrics.hd95", "training.mixup",
                   "models.presets", "inference.evaluate",
                   "data.process_miccai", "data.stats", "training.callbacks",
                   "utils.profiling", "utils.visualize", "ops.custom_ops",
                   "inference.export", "interpret.gradcam", "interpret.run",
                   "models.released", "parity_report", "__main__"):
        assert f"ctseg_tpu_torch.{module}" in new
    bad = [
        m for m in new
        if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "ctseg_tpu")
    ]
    assert bad == []


_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|ctseg_tpu)(\.|\s|$)", re.M
)


def test_no_source_file_imports_jax_or_the_jax_package():
    # _build/ is the git-ignored build cache, not the package
    sources = sorted(p for p in PKG.rglob("*.py") if "_build" not in p.parts)
    assert len(sources) > 15
    offenders = [
        str(p.relative_to(REPO)) for p in sources
        if _FORBIDDEN.search(p.read_text())
    ]
    assert offenders == []
    # the pattern is not fooled by the port's own name
    assert not _FORBIDDEN.search("from ctseg_tpu_torch.ops import _build\n")
    assert _FORBIDDEN.search("from ctseg_tpu.ops import masks\n")


def test_constants_equal_the_jax_package():
    names = [n for n in dir(jax_constants) if n.isupper()]
    assert names == [n for n in dir(port_constants) if n.isupper()]
    for n in names:
        assert getattr(port_constants, n) == getattr(jax_constants, n), n


@pytest.mark.parametrize("dtype", [np.int16, np.uint8, np.float32])
def test_nrrd_io_reads_what_the_jax_package_writes(tmp_path, dtype):
    arr = (np.random.default_rng(0).normal(size=(6, 5, 4)) * 100).astype(dtype)
    header = {"space directions": np.diag([1.1, 1.2, 3.0]),
              "space origin": np.array([1.0, -2.0, 3.5])}
    jax_nrrd_io.write(tmp_path / "a.nrrd", arr, header)
    ours, h1 = nrrd_io.read(tmp_path / "a.nrrd")
    theirs, h2 = jax_nrrd_io.read(tmp_path / "a.nrrd")
    np.testing.assert_array_equal(ours, theirs)
    assert ours.dtype == theirs.dtype
    np.testing.assert_array_equal(h1["space directions"], h2["space directions"])
    # and the other way round
    nrrd_io.write(tmp_path / "b.nrrd", arr, header)
    np.testing.assert_array_equal(jax_nrrd_io.read(tmp_path / "b.nrrd")[0], arr)


@pytest.mark.parametrize("n", [12, 80, 120, 163])
def test_crop_box_matches(n):
    ours, theirs = CropBox.anatomical(n), JaxCropBox.anatomical(n)
    assert (ours.z, ours.x, ours.y) == (theirs.z, theirs.x, theirs.y)


def test_synthetic_patient_and_volume_match(tmp_path):
    a = make_patient(tmp_path / "port", shape=(6, 40, 44), seed=5)
    b = jax_make_patient(tmp_path / "jax", shape=(6, 40, 44), seed=5)
    va, vb = Volume.from_nrrd(a / "img.nrrd"), JaxVolume.from_nrrd(b / "img.nrrd")
    np.testing.assert_array_equal(va.as_numpy(), vb.as_numpy())
    np.testing.assert_array_equal(va.as_numpy(True), vb.as_numpy(True))
    for mask in (b / "structures").iterdir():
        np.testing.assert_array_equal(
            nrrd_io.read(a / "structures" / mask.name)[0],
            nrrd_io.read(mask)[0],
        )
    assert (a / "landmarks.fcsv").read_text() == (b / "landmarks.fcsv").read_text()


def _code(path: Path, rename: bool) -> str:
    """The module's AST without its docstring, the port's package name
    written as the JAX package's."""
    text = path.read_text()
    if rename:
        text = text.replace("ctseg_tpu_torch", "ctseg_tpu")
    tree = ast.parse(text)
    body = tree.body
    if body and isinstance(body[0], ast.Expr) \
            and isinstance(body[0].value, ast.Constant):
        tree.body = body[1:]
    return ast.dump(tree)


@pytest.mark.parametrize("module", ["data/datasets.py", "paths.py",
                                    "models/released.py"])
def test_copied_modules_equal_the_jax_package(module):
    jax_pkg = Path(ctseg_tpu.__file__).resolve().parent
    assert _code(PKG / module, rename=True) == _code(jax_pkg / module, False)


def _functions(path: Path, names) -> dict:
    """The AST of each named top-level function of a module."""
    tree = ast.parse(path.read_text())
    found = {n.name: ast.dump(n) for n in tree.body
             if isinstance(n, ast.FunctionDef) and n.name in names}
    assert sorted(found) == sorted(names)
    return found


def test_host_hd95_functions_equal_the_jax_package():
    """metrics/hd95.py keeps the scipy host path (the oracle) as a copy; its
    device half is the port's own."""
    jax_pkg = Path(ctseg_tpu.__file__).resolve().parent
    names = ("_surface", "hd95", "hd95_per_structure")
    assert _functions(PKG / "metrics/hd95.py", names) == _functions(
        jax_pkg / "metrics/hd95.py", names)


def test_pack_slices_matches_the_jax_package(tmp_path):
    rng = np.random.default_rng(1)
    for i in range(3):
        masks = rng.integers(0, 2, size=(9, 6, 5)).astype(np.uint8)
        np.savez(tmp_path / f"0522c0001_{i}.npz",
                 image=rng.normal(size=(1, 6, 5)).astype(np.float32),
                 masks=masks, mask_indicator=masks.any(axis=(1, 2)),
                 spacing=np.array([1.1, 1.2], np.float32))
    ours, theirs = pack_slices(tmp_path), jax_pack_slices(tmp_path)
    for name in ("images", "labels", "indicators", "spacings"):
        np.testing.assert_array_equal(getattr(ours, name), getattr(theirs, name))
    assert ours.names == theirs.names
    ours.save(tmp_path / "packed.npz")
    again = PackedDataset2D.load(tmp_path / "packed.npz")
    np.testing.assert_array_equal(again.labels, theirs.labels)
