"""Build and bind the port's CUDA kernels.

Every `coloc_tpu_torch/csrc/*.cu` is compiled by nvcc for sm_90a into ONE
shared library with a plain C interface, loaded with ctypes: one nvcc per
source, all started together, then one link, so a build takes about as
long as its slowest source. The library is built on first use into
`coloc_tpu_torch/_build/`, named by a hash of the sources and flags,
through `_libcache` (temporary name, then rename), so an edited source
rebuilds and an unchanged one loads the cached file. Nothing here includes
PyTorch's headers: a build takes seconds, not the minutes of a torch
extension, and needs no ninja.

A failed build raises with nvcc's output. There is no fallback.

Flags: no --use_fast_math (approximate sqrt/division would break P3P
parity with the plain twins), and -fmad=false so the kernels round like
the plain PyTorch twins, which never fuse a multiply into an add.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

from coloc_tpu_torch import _libcache

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = _libcache.BUILD_DIR
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *_ARCH, "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of every launcher: pointers, sizes, then device and stream;
# each returns its cudaError_t
_SIGNATURES = {
    "coloc_k2nn": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "coloc_p3p": [_P, _P, _P, _P, _I, _I, _P],
    "coloc_ransac_rank": [_P, _P, _P, _P, _P, _I, _I, _F, _I, _I, _I, _I, _P],
    "coloc_ransac_rank_batched": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _I, _I, _P],
    "coloc_fast_nms": [_P, _P, _P, _I, _I, _F, _I, _P],
    "coloc_extract": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "coloc_fivept_front": [_P, _P, _P, _P, _P, _I, _I, _P],
    "coloc_fivept_dk": [_P, _P, _P, _P, _I, _I, _P],
    "coloc_fivept_polish": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    "coloc_epi_rank": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # the last three pointers of fed_octave are host arrays (the schedule)
    "coloc_fed_octave": [_P] * 7 + [_I] * 4 + [_P] * 3 + [_I, _P],
    "coloc_sample_raster": [_P] * 6 + [_I] * 8 + [_I, _P],
    "coloc_k2nn_group": [_P] * 5 + [_I] * 3 + [_I, _P],
    "coloc_pose_lm": [_P] * 21 + [_I] * 4 + [_F, _F] + [_I, _P],
    "coloc_pose_cov": [_P] * 10 + [_I] * 2 + [_F] + [_I, _P],
}

_libs = _libcache.Libraries("CUDA")
build_seconds: float = 0.0   # 0.0 when the library came from the cache
build_log: str = ""          # nvcc/ptxas output of the last build


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels are built from "
            f"{CSRC} on first use")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path(nvcc: str) -> Path:
    parts = []
    for src in _sources():
        parts += [src.name.encode(), src.read_bytes()]
    parts += [" ".join(NVCC_FLAGS).encode(), nvcc.encode()]
    return _libcache.hashed_path("libcoloc_kernels", parts)


def _compile(nvcc: str, tmp: Path) -> None:
    """Compile every source in its own nvcc process, all at once (output to
    a log file each, so no pipe fills), wait for all, then link into
    `tmp`."""
    global build_seconds, build_log
    work = Path(tempfile.mkdtemp(prefix="obj-", dir=tmp.parent))
    t0 = time.perf_counter()
    jobs = []
    try:
        for src in sorted(CSRC.glob("*.cu")):
            obj, log = work / f"{src.stem}.o", work / f"{src.stem}.log"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            with open(log, "w") as f:
                proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)
            jobs.append((cmd, obj, log, proc))
        logs, failed = [], []
        for cmd, _, log, proc in jobs:
            rc = proc.wait()
            logs.append(log.read_text())
            if rc != 0:
                failed.append(f"nvcc failed ({rc}): {' '.join(cmd)}")
        if not failed:
            cmd = [nvcc, *_ARCH, "-shared", "-o", str(tmp), *[str(j[1]) for j in jobs]]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            logs.append(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}")
        build_seconds = time.perf_counter() - t0
        build_log = "".join(logs)
        if failed:
            raise RuntimeError("\n".join(failed) + "\n" + build_log)
    finally:
        for job in jobs:    # none is left running, even on an interrupt
            if job[3].poll() is None:
                job[3].kill()
                job[3].wait()
        shutil.rmtree(work, ignore_errors=True)


def _make() -> ctypes.CDLL:
    nvcc = _nvcc()
    path = library_path(nvcc)
    _libcache.build_once(path, lambda tmp: _compile(nvcc, tmp))
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.coloc_error_string.argtypes = [ctypes.c_int]
    lib.coloc_error_string.restype = ctypes.c_char_p
    return lib


def load() -> ctypes.CDLL:
    """The kernels' library, built first if its sources changed; raises with
    nvcc's output where it cannot be built."""
    return _libs.get("kernels", _make)


def launch(name: str, *args) -> None:
    """Call launcher `name` and raise on the cudaError_t it returns (a launch
    the card refuses never runs, and a later synchronize would not say so)."""
    lib = load()
    err = getattr(lib, name)(*args)
    if err != 0:
        msg = lib.coloc_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")
