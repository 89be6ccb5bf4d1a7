"""Shared libraries built once into `coloc_tpu_torch/_build/` (git-ignored)
and loaded with ctypes: the CUDA kernels (ops/_build.py, nvcc) and the
native host libraries (io/_native.py, g++). Those modules say only which
sources and which compiler commands make a library; the naming, the
build and the loading are here.

A library's file is named by a hash of everything that goes into it
(sources, flags, compiler), so an edited source rebuilds and an unchanged
one loads the cached file. It is written to a temporary name of its own
(process and thread) and renamed into place, so two processes that build
at once (test workers, peer processes) never load a half-written file.
A library that failed to build or load raises the same error on every
later request, without building again.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional

BUILD_DIR = Path(__file__).resolve().parent / "_build"


def hashed_path(stem: str, parts: Iterable[bytes], build_dir: Path = BUILD_DIR) -> Path:
    """`build_dir/stem-<16 hex digits of sha256(parts)>.so`."""
    h = hashlib.sha256()
    for part in parts:
        h.update(part)
    return Path(build_dir) / f"{stem}-{h.hexdigest()[:16]}.so"


def build_once(out: Path, compile_to: Callable[[Path], None]) -> bool:
    """Make `out` by `compile_to(tmp)` unless it exists, then rename tmp
    into place. Returns whether it built. `compile_to` raises (with the
    compiler's output) where the build fails; no temporary file is left."""
    if out.is_file():
        return False
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}-{threading.get_ident()}.tmp")
    try:
        compile_to(tmp)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return True


class Libraries:
    """Loaded libraries by name: `get(name, make)` calls `make()` (build and
    load) once; where it raises RuntimeError or OSError, the error is kept
    and raised again on every later call."""

    def __init__(self, what: str):
        self.what = what
        self._lock = threading.Lock()
        self._libs: Dict[str, ctypes.CDLL] = {}
        self._errors: Dict[str, str] = {}

    def get(self, name: str, make: Callable[[], ctypes.CDLL]) -> ctypes.CDLL:
        lib = self._libs.get(name)      # every kernel launch asks: no lock then
        if lib is not None:
            return lib
        with self._lock:
            if name in self._libs:
                return self._libs[name]
            if name in self._errors:
                raise RuntimeError(self._errors[name])
            try:
                lib = make()
            except (RuntimeError, OSError) as e:
                self._errors[name] = f"{self.what} {name} library unavailable: {e}"
                raise RuntimeError(self._errors[name]) from e
            self._libs[name] = lib
            return lib

    def error(self, name: str) -> Optional[str]:
        return self._errors.get(name)
