"""ctypes binding for the native C++ prefetching image loader (counterpart
of coloc_tpu.io.native_loader).

Reference parity: the reference ingests frames with native C++ (OpenCV
imread, GPUDetector.hpp:161) synchronously; `coloc_tpu_torch/native/
loader.cpp` (a copy of coloc_tpu's) decodes PNG (zlib) / PGM and prefetches
on worker threads, so host decoding overlaps device work. It needs no PIL.

io/_native builds the library with g++ and zlib into
`coloc_tpu_torch/_build/` on first use. `available()` says whether it could
be built; `NativeLoader` raises with g++'s output where it cannot, and
`decode_image` returns None. Callers that can read frames otherwise
(cli.py: io/disk) choose between the two and say which they used.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from coloc_tpu_torch.io import _native

_bound = False


def _load_library() -> ctypes.CDLL:
    global _bound
    lib = _native.load("loader")
    if not _bound:
        lib.coloc_loader_open.restype = ctypes.c_void_p
        lib.coloc_loader_open.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.coloc_loader_get.restype = ctypes.c_int
        lib.coloc_loader_get.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ]
        lib.coloc_loader_close.argtypes = [ctypes.c_void_p]
        lib.coloc_decode_image.restype = ctypes.c_int
        lib.coloc_decode_image.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ]
        _bound = True
    return lib


def available() -> bool:
    """Whether the loader library could be built (coloc_tpu's meaning)."""
    return _native.available("loader")


def decode_image(path: str, height: int, width: int) -> Optional[np.ndarray]:
    """One image decoded natively, float32 (height, width); None where the
    library is unavailable or the file is not a PNG / PGM of that size."""
    if not available():
        return None
    lib = _load_library()
    out = np.zeros((height, width), np.float32)
    rc = lib.coloc_decode_image(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), height, width)
    return out if rc == 0 else None


class NativeLoader:
    """Prefetching dataset loader over img__Quad{d}_{f:04d}.{png,pgm}.

    Frames are decoded ahead by worker threads in sequential order
    (frame-major, all drones per frame), the session's access pattern.
    """

    def __init__(self, folder: str, num_drones: int, num_frames: int,
                 height: int, width: int, prefetch_depth: int = 8,
                 num_threads: int = 2):
        self._lib = _load_library()
        self._h, self._w = height, width
        self._handle = self._lib.coloc_loader_open(
            folder.encode(), num_drones, num_frames, height, width,
            prefetch_depth, num_threads)

    def get(self, drone: int, frame: int) -> np.ndarray:
        out = np.zeros((self._h, self._w), np.float32)
        rc = self._lib.coloc_loader_get(
            self._handle, drone, frame, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc != 0:
            raise IOError(f"failed to load drone={drone} frame={frame}")
        return out

    def close(self):
        if self._handle:
            self._lib.coloc_loader_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
