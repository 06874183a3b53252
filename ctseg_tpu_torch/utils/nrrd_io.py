"""Minimal pure-Python NRRD reader/writer.

The reference delegates NRRD IO to the `pynrrd` package
(reference capstone/utils/miccai.py:286-296). That package is not part of this
framework's dependency set, so we implement the subset of the NRRD4 format the
PDDCA dataset actually uses: raw / gzip encodings, scalar element types,
little/big endian, `space directions` / `space origin` metadata.

Arrays use NRRD's native index convention (first listed axis varies fastest),
matching pynrrd's default ``index_order='F'`` so the rest of the framework can
treat volumes exactly as the reference does: PDDCA files read as (H, W, D).
"""

import gzip
from pathlib import Path
from typing import Dict, Tuple, Union

import numpy as np

_NRRD_TYPE_TO_DTYPE = {
    "signed char": "i1", "int8": "i1", "int8_t": "i1",
    "uchar": "u1", "unsigned char": "u1", "uint8": "u1", "uint8_t": "u1",
    "short": "i2", "short int": "i2", "signed short": "i2",
    "signed short int": "i2", "int16": "i2", "int16_t": "i2",
    "ushort": "u2", "unsigned short": "u2", "unsigned short int": "u2",
    "uint16": "u2", "uint16_t": "u2",
    "int": "i4", "signed int": "i4", "int32": "i4", "int32_t": "i4",
    "uint": "u4", "unsigned int": "u4", "uint32": "u4", "uint32_t": "u4",
    "longlong": "i8", "long long": "i8", "long long int": "i8",
    "signed long long": "i8", "signed long long int": "i8",
    "int64": "i8", "int64_t": "i8",
    "ulonglong": "u8", "unsigned long long": "u8",
    "unsigned long long int": "u8", "uint64": "u8", "uint64_t": "u8",
    "float": "f4", "double": "f8",
}

_DTYPE_TO_NRRD_TYPE = {
    np.dtype(np.int8): "int8", np.dtype(np.uint8): "uint8",
    np.dtype(np.int16): "int16", np.dtype(np.uint16): "uint16",
    np.dtype(np.int32): "int32", np.dtype(np.uint32): "uint32",
    np.dtype(np.int64): "int64", np.dtype(np.uint64): "uint64",
    np.dtype(np.float32): "float", np.dtype(np.float64): "double",
}


class NrrdError(ValueError):
    """Malformed or unsupported NRRD content (subclass of ValueError so
    existing `except ValueError` callers keep working)."""


def _parse_vector(text: str) -> np.ndarray:
    text = text.strip()
    if text == "none":
        return None
    if not (text.startswith("(") and text.endswith(")")):
        raise NrrdError(f"bad NRRD vector (want '(a,b,...)'): {text!r}")
    try:
        return np.array([float(v) for v in text[1:-1].split(",")])
    except ValueError as e:
        raise NrrdError(f"bad NRRD vector components: {text!r}") from e


def _parse_space_directions(text: str) -> np.ndarray:
    vecs = [_parse_vector(part) for part in text.strip().split(" ")]
    dim = max(len(v) for v in vecs if v is not None)
    rows = [v if v is not None else np.full(dim, np.nan) for v in vecs]
    return np.stack(rows)


def read(path: Union[str, Path]) -> Tuple[np.ndarray, Dict]:
    """Read an NRRD file. Returns (array, header) like pynrrd's ``nrrd.read``."""
    path = Path(path)
    with open(path, "rb") as f:
        magic = f.readline()
        if not magic.startswith(b"NRRD"):
            raise ValueError(f"{path} is not an NRRD file (magic={magic!r})")

        header: Dict = {}
        while True:
            line = f.readline()
            if line in (b"\n", b"\r\n", b""):
                break
            text = line.decode("ascii", errors="replace").rstrip("\r\n")
            if text.startswith("#"):
                continue
            if ":=" in text:
                key, value = text.split(":=", 1)
                header[key.strip()] = value.strip()
            elif ": " in text or text.endswith(":"):
                key, _, value = text.partition(":")
                header[key.strip()] = value.strip()
            else:
                raise ValueError(f"unparseable NRRD header line: {text!r}")
        payload = f.read()

    if "data file" in header or "datafile" in header:
        raise NotImplementedError(
            f"{path}: detached NRRD data files (.nhdr) are not supported; "
            "convert to an attached-data .nrrd"
        )
    for required in ("sizes", "type"):
        if required not in header:
            raise NrrdError(f"{path}: NRRD header missing {required!r} field")
    try:
        sizes = np.array([int(v) for v in str(header["sizes"]).split()])
    except ValueError as e:
        raise NrrdError(
            f"{path}: unparseable sizes: {header['sizes']!r}"
        ) from e
    if sizes.size == 0 or (sizes <= 0).any():
        raise NrrdError(f"{path}: non-positive NRRD sizes: {sizes.tolist()}")
    header["sizes"] = sizes
    try:
        header["dimension"] = int(header.get("dimension", len(sizes)))
    except (TypeError, ValueError) as e:
        raise NrrdError(
            f"{path}: malformed 'dimension' header value "
            f"{header.get('dimension')!r} (expected an integer)"
        ) from e
    if header["dimension"] != len(sizes):
        raise NrrdError(
            f"{path}: dimension {header['dimension']} does not match "
            f"{len(sizes)} sizes"
        )
    if "space directions" in header and isinstance(header["space directions"], str):
        header["space directions"] = _parse_space_directions(header["space directions"])
    if "space origin" in header and isinstance(header["space origin"], str):
        header["space origin"] = _parse_vector(header["space origin"])

    type_name = str(header["type"]).lower()
    if type_name not in _NRRD_TYPE_TO_DTYPE:
        raise NrrdError(
            f"{path}: unsupported NRRD element type {header['type']!r} "
            f"(supported: {sorted(set(_NRRD_TYPE_TO_DTYPE))})"
        )
    base = _NRRD_TYPE_TO_DTYPE[type_name]
    endian = str(header.get("endian", "little")).lower()
    dtype = np.dtype(("<" if endian == "little" else ">") + base)
    if dtype.itemsize == 1:
        dtype = np.dtype(base)

    encoding = str(header.get("encoding", "raw")).lower()
    if encoding in ("gzip", "gz"):
        try:
            payload = gzip.decompress(payload)
        except (OSError, EOFError) as e:
            raise NrrdError(
                f"{path}: corrupt gzip payload ({e}); the file may be "
                "truncated"
            ) from e
    elif encoding != "raw":
        raise NotImplementedError(f"NRRD encoding {encoding!r} not supported")

    count = int(np.prod(sizes))
    if len(payload) < count * dtype.itemsize:
        raise NrrdError(
            f"{path}: truncated NRRD payload: header promises "
            f"{count * dtype.itemsize} bytes "
            f"({'x'.join(map(str, sizes))} of {header['type']}), "
            f"file has {len(payload)}"
        )
    data = np.frombuffer(payload, dtype=dtype, count=count)
    # NRRD orders values with the first listed axis varying fastest.
    array = data.reshape(tuple(sizes), order="F")
    return array, header


def write(
    path: Union[str, Path],
    array: np.ndarray,
    header: Dict = None,
    encoding: str = "gzip",
) -> None:
    """Write an NRRD file (scalar arrays, raw or gzip encoding)."""
    path = Path(path)
    header = dict(header or {})
    array = np.asarray(array)
    native = array.dtype.newbyteorder("=")
    if native not in _DTYPE_TO_NRRD_TYPE:
        raise NrrdError(
            f"cannot write dtype {array.dtype} as NRRD (supported: "
            f"{sorted(str(d) for d in _DTYPE_TO_NRRD_TYPE)})"
        )
    nrrd_type = _DTYPE_TO_NRRD_TYPE[native]

    lines = ["NRRD0004", "# written by ctseg_tpu"]
    lines.append(f"type: {nrrd_type}")
    lines.append(f"dimension: {array.ndim}")
    lines.append("sizes: " + " ".join(str(s) for s in array.shape))
    if array.dtype.itemsize > 1:
        lines.append("endian: little")
    lines.append(f"encoding: {encoding}")
    if "space directions" in header:
        sd = header["space directions"]
        parts = []
        for row in np.asarray(sd):
            if np.any(np.isnan(row)):
                parts.append("none")
            else:
                parts.append("(" + ",".join(f"{v:.17g}" for v in row) + ")")
        lines.append("space directions: " + " ".join(parts))
    if "space origin" in header:
        so = np.asarray(header["space origin"])
        lines.append("space origin: (" + ",".join(f"{v:.17g}" for v in so) + ")")
    if "space" in header:
        lines.append(f"space: {header['space']}")

    payload = np.asarray(array, order="F").astype(
        array.dtype.newbyteorder("<") if array.dtype.itemsize > 1 else array.dtype
    ).tobytes(order="F")
    if encoding in ("gzip", "gz"):
        payload = gzip.compress(payload, compresslevel=1)
    elif encoding != "raw":
        raise NotImplementedError(f"NRRD encoding {encoding!r} not supported")

    with open(path, "wb") as f:
        f.write(("\n".join(lines) + "\n\n").encode("ascii"))
        f.write(payload)
