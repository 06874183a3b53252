"""Build and load the port's CUDA kernels (csrc/*.cu) for Hopper.

At first use, nvcc compiles every source under csrc/ for sm_90a (one nvcc
process per source, all started together), links the objects into one shared
library with a plain C interface, and ctypes loads it. The library is
cached under ctseg_tpu_torch/_build/<key>/, where the key hashes the
sources and the flags, so an edited source never loads a stale library.
There is no fallback: without nvcc, `library()` raises.

Each C entry point launches on the stream it is given, allocates nothing and
returns its cudaError_t; `check` turns a non-zero code into an exception.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
LIB_NAME = "libctseg_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # registers, shared memory and spills, kept in `log`
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# name -> argtypes; every pointer and the stream as c_void_p so none is cut
# to 32 bits.
SIGNATURES = {
    # x, y, alpha, parts, mean, var, n, s, c, vec, chunks, rows_per_chunk,
    # dtype, device, stream
    "ctseg_in_prelu_fwd": [_P] * 6 + [_I] * 8 + [_P],
    # The split form across depth slabs:
    # x, parts, totals, n, s, c, vec, chunks, rows_per_chunk, dtype, device,
    # stream
    "ctseg_in_prelu_split_fwd_sums": [_P] * 3 + [_I] * 8 + [_P],
    # x, mean, var, alpha, y, n, s, c, vec, chunks, rows_per_chunk, dtype,
    # device, stream
    "ctseg_in_prelu_split_fwd_apply": [_P] * 5 + [_I] * 8 + [_P],
    # x, g, mean, var, alpha, parts, totals, n, s, c, vec, chunks,
    # rows_per_chunk, dtype, device, stream
    "ctseg_in_prelu_split_bwd_sums": [_P] * 7 + [_I] * 8 + [_P],
    # x, g, mean, var, alpha, means, dx, n, s, c, vec, chunks,
    # rows_per_chunk, dtype, device, stream
    "ctseg_in_prelu_split_bwd_apply": [_P] * 7 + [_I] * 8 + [_P],
    # x, y, alpha, mean_out, var_out, n, s, c, wcc, cluster_size, dtype,
    # device, stream
    "ctseg_in_prelu_fwd_cluster": [_P] * 5 + [_I] * 7 + [_P],
    # x, g, mean, var, alpha, dx, parts, means, n, s, c, vec, chunks,
    # rows_per_chunk, dtype, device, stream
    "ctseg_in_prelu_bwd": [_P] * 8 + [_I] * 8 + [_P],
    # x, g, mean, var, alpha, dx, parts, n, s, c, wcc, cluster_size, dtype,
    # device, stream
    "ctseg_in_prelu_bwd_cluster": [_P] * 7 + [_I] * 7 + [_P],
    # x, w, bias, alpha, scratch, out, xhat_out, rsinv_out,
    # n, h, w, cin, cout, dtype, device, stream
    "ctseg_conv3x3_in_prelu_fwd": [_P] * 8 + [_I] * 7 + [_P],
    # x, w, bias, alpha, scratch, stats, mean, rsinv, out, xhat_out,
    # w_planes, n, h, w, cin, cout, dtype, device, stream
    "ctseg_conv3x3_in_prelu_fwd_tc": [_P] * 11 + [_I] * 7 + [_P],
    # K2b: g, xhat, rsinv, alpha, dy, parts, means, n, s, c, vec, chunks,
    # rows_per_chunk, dtype, device, stream
    "ctseg_in_prelu_bwd_saved": [_P] * 7 + [_I] * 8 + [_P],
    # g, xhat, rsinv, alpha, dy, parts, n, s, c, wcc, cluster_size, threads,
    # dtype, device, stream
    "ctseg_in_prelu_bwd_saved_cluster": [_P] * 6 + [_I] * 8 + [_P],
    # images, top, left, rot, flip, params, out, n, h, w, s, device, stream
    "ctseg_window_normalize": [_P] * 7 + [_I] * 5 + [_P],
    # x, scale, out, b, k, l, device, stream
    "ctseg_min_plus": [_P] * 3 + [_I] * 4 + [_P],
    # src, scale, out, has_site, samples, rows_per_map, w, classes, labels,
    # ltype, device, stream
    "ctseg_edt_row_scan": [_P] * 4 + [_L] + [_I] * 6 + [_P],
    # d2, labels, has_site, out, maps, elems, classes, ltype, device, stream
    "ctseg_edt_signed_map": [_P] * 4 + [_L] + [_I] * 4 + [_P],
    # x, dy, part, dbpart, dw, db, n, e0, e1, e2, xd, cin, cout, k, pd, tl,
    # tg, s_tile, t_tile, t1, td, hs, hspan, wspan, stages, sx, sdy,
    # x_words, slot_words, groups, rpl, smem, part_elems, dbpart_elems,
    # dtype, device, stream
    "ctseg_shallow_dw": [_P] * 6 + [_I] * 26 + [_L] * 2 + [_I] * 2 + [_P],
    # x, dy, part, dbpart, dw, db, n, e0, e1, e2, f2, cin, cout, ndim, n_ct,
    # t1, t2, groups, sx, sdy, x_words, stage_words, smem, part_elems,
    # dbpart_elems, dtype, device, stream
    "ctseg_shallow_dwt": [_P] * 6 + [_I] * 17 + [_L] * 2 + [_I] * 2 + [_P],
}


class KernelLibrary:
    """The loaded shared library, with how it was built."""

    def __init__(self, path: Path, seconds: float, log: str):
        self.path = path
        self.build_seconds = seconds  # 0.0 when a cached build was loaded
        self.log = log
        self._lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(self._lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        self._lib.ctseg_error_string.argtypes = [ctypes.c_int]
        self._lib.ctseg_error_string.restype = ctypes.c_char_p

    def __getattr__(self, name):
        if name in SIGNATURES:
            return getattr(self._lib, name)
        raise AttributeError(name)

    def check(self, code: int, what: str) -> None:
        if code != 0:
            msg = self._lib.ctseg_error_string(code).decode()
            raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def sources(csrc: Path = CSRC):
    return sorted(p for p in csrc.iterdir() if p.suffix in (".cu", ".cuh"))


def build_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME): the CUDA kernels of "
        "ctseg_tpu_torch are compiled at first use and have no fallback"
    )


def build(out_dir: Path, csrc: Path = CSRC) -> KernelLibrary:
    """Compile csrc/*.cu, one nvcc per source in parallel, link the objects
    into out_dir/LIB_NAME (atomically) and load it. `csrc` may name another
    directory of sources, such as an edited copy that a tool times."""
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    jobs = []
    for src in sources(csrc):
        if src.suffix != ".cu":
            continue
        obj = out_dir / f".{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(csrc), "-c", "-o", str(obj),
               str(src)]
        jobs.append((obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = "", False
    for obj, proc in jobs:
        out, _ = proc.communicate()
        log += out
        failed = failed or proc.returncode != 0
    objects = [str(obj) for obj, _ in jobs]
    tmp = out_dir / f".{LIB_NAME}.{tag}"
    try:
        if not failed:
            link = subprocess.run(
                [nvcc, "-shared", "-o", str(tmp), *objects],
                capture_output=True, text=True)
            log += link.stdout + link.stderr
            failed = link.returncode != 0
        if failed:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed:\n{log}")
    finally:
        for obj in objects:
            Path(obj).unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    os.replace(tmp, out_dir / LIB_NAME)
    (out_dir / "build.log").write_text(log)
    return KernelLibrary(out_dir / LIB_NAME, seconds, log)


_lock = threading.Lock()
_library: Optional[KernelLibrary] = None


def library() -> KernelLibrary:
    """The process's kernel library, built on first call (thread-safe)."""
    global _library
    with _lock:
        if _library is None:
            out_dir = BUILD_ROOT / build_key()
            if (out_dir / LIB_NAME).exists():
                log_file = out_dir / "build.log"
                log = log_file.read_text() if log_file.exists() else ""
                _library = KernelLibrary(out_dir / LIB_NAME, 0.0, log)
            else:
                _library = build(out_dir)
        return _library


def use(lib: Optional[KernelLibrary]) -> None:
    """Make `lib` the library every wrapper launches from; None goes back to
    this tree's, loaded or built at the next use."""
    global _library
    with _lock:
        _library = lib
