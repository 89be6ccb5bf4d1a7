"""Device dispatch for kernels (counterpart of coloc_tpu.ops.dispatch).

One rule: a CUDA tensor goes to the hand-written Hopper kernel, a CPU tensor
to the kernel's plain PyTorch twin. There is no switch that sends CUDA
tensors down the plain path and no fallback when a build or launch fails:
those raise. Interpret mode has no counterpart; the plain twins serve the
CPU.

Each kernel wrapper adds one to its launch count where it launches its
kernel, and nowhere else, so a run can prove that its main path went
through the kernels (chip_smoke.py reads the counts). A CUDA graph
launches its kernels at each replay, not while it is captured: the counts
taken during a capture are moved into the graph's record
(`counted_capture`) and added at each replay (`count_replay`).

`constant` gives a step its scalar constants without a host-to-device
copy per call, which a captured step may not make.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, Iterator

import torch

KERNELS = ("k2nn", "p3p", "ransac_rank", "fast_nms", "extract",
           "fivept_front", "fivept_dk", "fivept_polish", "epi_rank",
           "fed_octave", "sample_raster", "k2nn_group", "pose_lm", "pose_cov")
_LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}


def use_kernel(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain twin); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise RuntimeError(f"no kernel or plain path for device {t.device}")


def default_device(device=None) -> torch.device:
    """The device of an entry point: the caller's, or cuda:0 when None.
    There is no silent CPU: with no CUDA device, None raises, and the CPU
    is used only when the caller asks for it."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card; pass device='cpu' to "
            "run the plain PyTorch path")
    return torch.device("cuda", 0)


def check_operand(t: torch.Tensor, name: str, dtype: torch.dtype, shape,
                  device: torch.device) -> None:
    """Raise unless `t` is what a kernel reads through its raw pointer:
    `dtype`, `shape` (None entries match any extent), on `device`, and
    contiguous."""
    ok_shape = t.dim() == len(shape) and all(
        s is None or s == n for s, n in zip(shape, t.shape))
    if t.dtype != dtype or not ok_shape or t.device != device:
        raise ValueError(
            f"{name}: expected {dtype} {tuple(shape)} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def count_launch(name: str) -> None:
    _LAUNCHES[name] += 1


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(_LAUNCHES)


@contextlib.contextmanager
def counted_capture(record: Dict[str, int]) -> Iterator[Dict[str, int]]:
    """Around the capture of a CUDA graph: what the wrappers count inside
    is added to `record` (the graph's launches a replay) and taken off the
    counts, since capturing launches nothing."""
    before = dict(_LAUNCHES)
    try:
        yield record
    finally:
        for name in _LAUNCHES:
            record[name] = record.get(name, 0) + _LAUNCHES[name] - before[name]
            _LAUNCHES[name] = before[name]


def count_replay(record: Dict[str, int]) -> None:
    """One replay of a graph whose capture filled `record`."""
    for name, n in record.items():
        _LAUNCHES[name] += n


@functools.lru_cache(maxsize=None)
def constant(value, device: torch.device,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A 0-dim tensor holding `value` on `device`, made once per (value,
    device, dtype). Read only: every caller shares it."""
    return torch.tensor(value, dtype=dtype, device=device)
