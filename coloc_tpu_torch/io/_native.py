"""Build and load the port's native host libraries with g++: the topic bus
(`native/transport.cpp`, io/transport) and the prefetching image loader
(`native/loader.cpp`, io/native_loader). The sources are copies of
coloc_tpu's, so both packages speak one wire protocol.

A library is built on first use into `coloc_tpu_torch/_build/`, named by
a hash of its source, flags and compiler, through `_libcache` (temporary
name, then rename; the ops/_build.py kernels go the same way). Nothing is
built or loaded anywhere else.

The flags are coloc_tpu/native/Makefile's: -O2 -fPIC -std=c++17 -Wall
-shared, with -lpthread, and -lz for the loader. A failed build raises with
g++'s output, and a later call raises the same error without building again.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

from coloc_tpu_torch import _libcache

NATIVE = Path(__file__).resolve().parent.parent / "native"
BUILD_DIR = _libcache.BUILD_DIR
CXXFLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-shared")
# library name -> (source, link flags)
LIBRARIES = {
    "transport": ("transport.cpp", ("-lpthread",)),
    "loader": ("loader.cpp", ("-lz", "-lpthread")),
}

_libs = _libcache.Libraries("native")
build_seconds: Dict[str, float] = {}   # 0.0 where the library came from the cache


def compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found (set CXX): the port's native libraries are "
                           f"built from {NATIVE} on first use")
    return cxx


def library_path(name: str, cxx: str, build_dir: Path = BUILD_DIR) -> Path:
    src, libs = LIBRARIES[name]
    flags = " ".join((*CXXFLAGS, *libs, cxx)).encode()
    return _libcache.hashed_path(f"libcoloc_{name}", [(NATIVE / src).read_bytes(), flags],
                                 build_dir)


def build(name: str, build_dir: Path = BUILD_DIR) -> Path:
    """The library `name`, built first if no file of its hash exists."""
    cxx = compiler()
    out = library_path(name, cxx, build_dir)
    src, libs = LIBRARIES[name]

    def compile_to(tmp: Path) -> None:
        cmd = [cxx, *CXXFLAGS, str(NATIVE / src), "-o", str(tmp), *libs]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"g++ failed to run for {src}: {e!r}") from e
        build_seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")

    if not _libcache.build_once(out, compile_to):
        build_seconds.setdefault(name, 0.0)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name` (built first if need be); raises with the
    build's output where it cannot be built or loaded."""
    return _libs.get(name, lambda: ctypes.CDLL(str(build(name))))


def available(name: str) -> bool:
    """Whether library `name` could be built and loaded."""
    try:
        load(name)
        return True
    except RuntimeError:
        return False


def error(name: str) -> Optional[str]:
    """The build or load error of library `name`, if it failed."""
    return _libs.error(name)
