"""The port's host-side data preparation against the JAX package.

  - The copies `utils/{miccai,visualize}.py` and `data/{download,
    process_miccai,distance,stats}.py` keep the code of their originals
    (the port's package name written as the JAX package's, module
    docstrings aside).
  - `convert_to_2d`/`pack_2d` and `convert_to_3d`/`pack_3d` on
    `testing.synth.make_patient` directories (96x96, no crop) write the
    same npz files as the JAX package's, and `derive_all` gives the same
    statistics; `split_patient_ids` splits made-up ids the same way and
    `prepare_miccai(download=False)` moves the same directories.
  - The CLIs (`download miccai --no_download`, `process_miccai convert_2d
    --no_crop`, `pack_2d`, `stats`) run end to end in subprocesses with
    CTSEG_DATA_STORAGE pointing at a temporary storage.
  - The patient domain model and the visualization arrays agree.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import ctseg_tpu
import ctseg_tpu_torch
from ctseg_tpu.data import download as jax_download
from ctseg_tpu.data import process_miccai as jax_process
from ctseg_tpu.data import stats as jax_stats
from ctseg_tpu.data.datasets import PackedDataset2D as JaxPacked2D
from ctseg_tpu.data.distance import compute_distance_map as jax_distance
from ctseg_tpu.utils import miccai as jax_miccai
from ctseg_tpu.utils import visualize as jax_visualize
from ctseg_tpu_torch.data import download, process_miccai, stats
from ctseg_tpu_torch.data.datasets import PackedDataset2D, PackedDataset3D
from ctseg_tpu_torch.data.distance import compute_distance_map
from ctseg_tpu_torch.testing.synth import make_patient
from ctseg_tpu_torch.utils import miccai, visualize
from test_torch_port_imports import _code

PKG = Path(ctseg_tpu_torch.__file__).resolve().parent
JAX_PKG = Path(ctseg_tpu.__file__).resolve().parent
REPO = PKG.parent
# The 48 PDDCA patient ids: 33 of 1-479 (train/valid), 15 of 555-878 (test).
IDS = list(range(1, 34)) + list(range(555, 570))


@pytest.mark.parametrize("module", [
    "utils/miccai.py", "utils/visualize.py", "data/download.py",
    "data/process_miccai.py", "data/distance.py", "data/stats.py"])
def test_copied_modules_equal_the_jax_package(module):
    assert _code(PKG / module, rename=True) == _code(JAX_PKG / module, False)


@pytest.fixture(scope="module")
def patients(tmp_path_factory):
    """Four patients, one of them missing two structures, 96x96, 12 deep."""
    root = tmp_path_factory.mktemp("raw")
    for i, pid in enumerate((1, 2, 3, 555)):
        make_patient(root / "train" / f"0522c{pid:04d}", shape=(12, 96, 96),
                     seed=i, structures=None if i else
                     ["BrainStem", "Mandible", "Parotid_L", "Parotid_R",
                      "OpticNerve_L", "Submandibular_L", "Chiasm"])
    return root


def _npz_equal(a: Path, b: Path):
    names = sorted(p.name for p in a.glob("*.npz"))
    assert names and names == sorted(p.name for p in b.glob("*.npz"))
    for name in names:
        with np.load(a / name) as x, np.load(b / name) as y:
            assert sorted(x.files) == sorted(y.files)
            for k in x.files:
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)
                assert x[k].dtype == y[k].dtype, k


@pytest.mark.parametrize("dims", [2, 3])
def test_convert_and_pack_write_the_jax_packages_files(patients, tmp_path,
                                                       dims):
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    convert = process_miccai.convert_to_2d if dims == 2 else \
        process_miccai.convert_to_3d
    jax_convert = jax_process.convert_to_2d if dims == 2 else \
        jax_process.convert_to_3d
    convert(patients, ours, "train", crop=False)
    jax_convert(patients, theirs, "train", crop=False)
    _npz_equal(ours / "train", theirs / "train")
    pack = process_miccai.pack_2d if dims == 2 else process_miccai.pack_3d
    jax_pack = jax_process.pack_2d if dims == 2 else jax_process.pack_3d
    pack(ours)
    jax_pack(theirs)
    with np.load(ours / "train_packed.npz") as x, \
            np.load(theirs / "train_packed.npz") as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    packed = (PackedDataset2D if dims == 2 else PackedDataset3D).load(
        ours / "train_packed.npz")
    assert len(packed) > 0 and packed.spacings is not None


def test_derive_all_gives_the_jax_packages_statistics(patients, tmp_path):
    process_miccai.convert_to_2d(patients, tmp_path, "train", crop=False)
    process_miccai.pack_2d(tmp_path)
    raw = patients / "train"
    ours = stats.derive_all(PackedDataset2D.load(tmp_path / "train_packed.npz"),
                            raw_dir=raw)
    theirs = jax_stats.derive_all(
        JaxPacked2D.load(tmp_path / "train_packed.npz"), raw_dir=raw)
    assert json.dumps(ours, sort_keys=True) == json.dumps(theirs,
                                                         sort_keys=True)
    ours = stats.derive_all(PackedDataset2D.load(tmp_path / "train_packed.npz"),
                            per_item=False)
    theirs = jax_stats.derive_all(
        JaxPacked2D.load(tmp_path / "train_packed.npz"), per_item=False)
    assert ours == theirs


def test_split_patient_ids_is_equal():
    rng = np.random.default_rng(3)
    for ids in (IDS, sorted(rng.choice(np.arange(1, 900), 60, replace=False))):
        ids = [int(i) for i in ids]
        assert download.split_patient_ids(ids) == \
            jax_download.split_patient_ids(ids)
    split = download.split_patient_ids(IDS)
    assert [len(split[k]) for k in ("train", "valid", "test")] == [25, 8, 15]


def test_prepare_miccai_moves_the_same_directories(tmp_path):
    for side in ("port", "jax"):
        for pid in IDS:
            (tmp_path / side / f"0522c{pid:04d}").mkdir(parents=True)
    download.prepare_miccai(str(tmp_path / "port"), download=False)
    jax_download.prepare_miccai(str(tmp_path / "jax"), download=False)
    for split in ("train", "valid", "test"):
        assert sorted(p.name for p in (tmp_path / "port" / split).iterdir()) \
            == sorted(p.name for p in (tmp_path / "jax" / split).iterdir())
    with pytest.raises(AssertionError, match="48 patient directories"):
        download.prepare_miccai(str(tmp_path / "empty"), download=False)


def _run(args, storage):
    env = dict(os.environ, CTSEG_DATA_STORAGE=str(storage),
               PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-m"] + args, cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def test_data_preparation_clis_run_end_to_end(tmp_path):
    """48 small patients: split, convert without the crop, pack, derive."""
    storage = tmp_path / "storage"
    for i, pid in enumerate(IDS):
        make_patient(storage / "miccai" / f"0522c{pid:04d}", shape=(8, 24, 24),
                     seed=i, with_landmarks=pid < 480)
    _run(["ctseg_tpu_torch.data.download", "miccai", "--no_download"],
         storage)
    counts = {s: len(list((storage / "miccai" / s).iterdir()))
              for s in ("train", "valid", "test")}
    assert counts == {"train": 25, "valid": 8, "test": 15}
    _run(["ctseg_tpu_torch.data.process_miccai", "convert_2d", "--no_crop"],
         storage)
    out = _run(["ctseg_tpu_torch.data.process_miccai", "pack_2d"], storage)
    assert "packed train:" in out and "packed test:" in out
    train = PackedDataset2D.load(storage / "miccai_2d" / "train_packed.npz")
    assert train.images.shape[1:] == (24, 24)
    report = json.loads(_run(["ctseg_tpu_torch.data.stats", "--raw_dir",
                              str(storage / "miccai" / "train")], storage))
    assert set(report) == {"class_weights", "annotation_counts",
                           "stacked_window_stats", "crop_envelope"}
    # the same report as the JAX package's, through JSON
    theirs = jax_stats.derive_all(
        JaxPacked2D.load(storage / "miccai_2d" / "train_packed.npz"),
        raw_dir=str(storage / "miccai" / "train"))
    assert report == json.loads(json.dumps(theirs))


def test_patient_domain_model_matches(patients):
    path = patients / "train" / "0522c0001"
    ours, theirs = miccai.Patient(path), jax_miccai.Patient(path)
    assert ours.present_structures() == theirs.present_structures()
    assert len(ours.present_structures()) == 7
    assert ours.landmarks == theirs.landmarks and len(ours.landmarks) == 3
    np.testing.assert_array_equal(ours.image.spacing, theirs.image.spacing)
    np.testing.assert_array_equal(ours.image.as_grid(), theirs.image.as_grid())
    names = ["BrainStem", "Mandible"]
    np.testing.assert_array_equal(ours.combine_segmentation_masks(names),
                                  theirs.combine_segmentation_masks(names))
    a, b = ours.crop_data(), theirs.crop_data()
    assert (a.z, a.x, a.y) == (b.z, b.x, b.y)
    np.testing.assert_array_equal(ours.image.data, theirs.image.data)
    collection = miccai.PatientCollection(patients / "train")
    assert collection.patient_paths == \
        jax_miccai.PatientCollection(patients / "train").patient_paths
    assert len(collection) == 4


def test_distance_map_and_visualize_match():
    rng = np.random.default_rng(5)
    mask = rng.integers(0, 2, size=(3, 20, 24)).astype(np.uint8)
    mask[1] = 0
    np.testing.assert_array_equal(compute_distance_map(mask),
                                  jax_distance(mask))
    image = rng.uniform(-1000, 1500, size=(32, 32))
    labels = rng.integers(0, 10, size=(32, 32))
    np.testing.assert_array_equal(visualize.window_image(image, 400, 40),
                                  jax_visualize.window_image(image, 400, 40))
    base = visualize.window_image(image, 400, 40)
    np.testing.assert_array_equal(visualize.overlay_labels(base, labels),
                                  jax_visualize.overlay_labels(base, labels))


def test_the_copies_import_no_plotting_package_at_import():
    """matplotlib and ipywidgets stay lazy: the card's machine may lack
    them."""
    probe = ("import sys, ctseg_tpu_torch.utils.visualize, "
             "ctseg_tpu_torch.training.callbacks; "
             "print(sorted(m for m in ('matplotlib', 'ipywidgets', 'wandb') "
             "if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, text=True,
                         capture_output=True, timeout=300, check=True)
    assert out.stdout.strip() == "[]"
