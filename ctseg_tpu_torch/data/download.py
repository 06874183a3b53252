"""Download & split the MICCAI 2015 PDDCA dataset (a copy of
ctseg_tpu/data/download.py: the port never imports the JAX package;
tests/test_torch_data_prep.py pins the code of the two copies equal,
docstrings aside).

Split parity is exact with the reference (capstone/data/download.py:36-93):
test = patient ids 555-878, candidates = ids 1-479 sorted then shuffled with
numpy's default_rng(seed=42); first 8 -> valid, remaining 25 -> train. The
same Generator algorithm (PCG64 + Fisher-Yates) reproduces the identical
partition.

Usage:
    python -m ctseg_tpu_torch.data.download miccai [--root_dir DIR] [--no_download]
"""

import shutil
import urllib.request
import zipfile
from argparse import ArgumentParser
from pathlib import Path
from typing import Dict, List

import numpy as np

from ctseg_tpu_torch.constants import SPLIT_SEED
from ctseg_tpu_torch.paths import DEFAULT_DATA_STORAGE

PDDCA_URLS = {
    "part-1": "http://www.imagenglab.com/data/pddca/PDDCA-1.4.1_part1.zip",
    "part-2": "http://www.imagenglab.com/data/pddca/PDDCA-1.4.1_part2.zip",
    "part-3": "http://www.imagenglab.com/data/pddca/PDDCA-1.4.1_part3.zip",
}


def split_patient_ids(patient_ids: List[int]) -> Dict[str, List[int]]:
    """Deterministic train/valid/test partition of PDDCA patient ids."""
    patient_ids = sorted(patient_ids)
    train = [pid for pid in patient_ids if pid in range(1, 480)]
    test = [pid for pid in patient_ids if pid in range(555, 879)]
    rng = np.random.default_rng(seed=SPLIT_SEED)
    rng.shuffle(train)
    valid = train[:8]
    train = train[8:]
    return {"train": train, "valid": valid, "test": test}


def prepare_miccai(root_dir: str, download: bool = True) -> None:
    """Download (optionally) and move patient dirs into train/valid/test."""
    path = Path(root_dir)
    path.mkdir(parents=True, exist_ok=True)

    if download:
        for name, url in PDDCA_URLS.items():
            archive = path / f"{name}.zip"
            print(f"downloading {url} -> {archive}")
            urllib.request.urlretrieve(url, archive)
            with zipfile.ZipFile(archive) as zf:
                zf.extractall(path)
            archive.unlink()

    patients = sorted(path.glob("0522c*"))
    assert len(patients) == 48, (
        f"The required 48 patient directories of the MICCAI dataset were not "
        f"found at: {path.absolute()} (found {len(patients)})"
    )

    ids = [int(p.name[5:]) for p in patients]
    split = split_patient_ids(ids)
    id_to_split = {
        pid: name for name, pids in split.items() for pid in pids
    }
    for patient in patients:
        dest = path / id_to_split[int(patient.name[5:])]
        dest.mkdir(exist_ok=True)
        shutil.move(str(patient), str(dest / patient.name))


def main():
    parser = ArgumentParser(description="Download & prepare datasets")
    sub = parser.add_subparsers(dest="command", required=True)
    miccai = sub.add_parser("miccai", help="MICCAI 2015 Head and Neck dataset")
    miccai.add_argument("--root_dir", type=str, default=None)
    miccai.add_argument("--no_download", action="store_true", default=False)
    args = parser.parse_args()

    if args.command == "miccai":
        root = args.root_dir or (Path(DEFAULT_DATA_STORAGE) / "miccai").as_posix()
        prepare_miccai(root, not args.no_download)


if __name__ == "__main__":
    main()
