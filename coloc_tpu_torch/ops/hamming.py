"""Brute-force 512-bit Hamming 2-NN (counterpart of coloc_tpu.ops.hamming).

Reference parity: CUDAK2NN — each query scans the whole training bank and
keeps best, second-best and the index of the best; the accept test lives in
matching.py.

  pack_bank          — the device-resident bank (setMapData parity): packed
                       words + a per-row penalty (0 valid, 2048 invalid)
  hamming_2nn_bank   — 2-NN against a resident bank: the CUDA kernel
                       csrc/k2nn.cu on a CUDA tensor, hamming_2nn_plain on CPU
  hamming_2nn_plain  — the kernel's plain twin (+-1 float matmul, exact)

Semantics shared by kernel and twin (and by coloc_tpu's Pallas kernel):
best = second = 2048 and idx = -1 to start; an invalid bank row costs
hd + 2048; the lowest index wins ties; a duplicate of the best is second;
an invalid query reports 2048/2048; an all-invalid bank gives idx -1.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from coloc_tpu_torch.ops import _build, dispatch
from coloc_tpu_torch.types import DESC_WORDS

DESC_BITS = 512
_INVALID_DIST = 2048  # > any possible Hamming distance


class Bank(NamedTuple):
    desc: torch.Tensor  # (T, 16) int32 packed descriptors, contiguous
    pen: torch.Tensor   # (T,) int32: 0 for a valid row, 2048 for an invalid one


def unpack_bipolar(desc: torch.Tensor, dtype=torch.int8) -> torch.Tensor:
    """(N, 16) int32 packed bits -> (N, 512) +-1 of `dtype` (bit 0 of word 0 first)."""
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    bits = (desc[:, :, None] >> shifts) & 1
    bits = bits.reshape(desc.shape[0], DESC_BITS)
    return (2 * bits - 1).to(dtype)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(N, 512) {0,1} -> (N, 16) int32 words, inverse of the unpack layout."""
    b = bits.reshape(bits.shape[0], DESC_WORDS, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = (b << shifts).sum(dim=-1)                 # [0, 2^32)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def pack_bank(t_desc: torch.Tensor, t_valid: torch.Tensor) -> Bank:
    pen = torch.where(t_valid, 0, _INVALID_DIST).to(torch.int32)
    return Bank(desc=t_desc.to(torch.int32).contiguous(), pen=pen.contiguous())


def hamming_2nn_plain(
    q_desc: torch.Tensor, q_valid: torch.Tensor, bank: Bank
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of csrc/k2nn.cu: (idx, best, second), each (Q,) int32.

    Distances come from a +-1 float32 matmul, exact because every partial
    sum is an integer below 2^24. The running (best, second) of the kernel,
    started at (2048, 2048), equals the two smallest of {d_j} + {2048, 2048}.
    """
    Q, T = q_desc.shape[0], bank.desc.shape[0]
    sq = unpack_bipolar(q_desc, torch.float32)
    st = unpack_bipolar(bank.desc, torch.float32)
    dot = sq @ st.T                                          # (Q, T)
    dist = ((DESC_BITS - dot) * 0.5).to(torch.int32) + bank.pen[None, :]
    sentinel = torch.full((Q, 2), _INVALID_DIST, dtype=torch.int32,
                          device=q_desc.device)
    two = torch.cat([dist, sentinel], dim=1)
    low2 = torch.topk(two, 2, dim=1, largest=False, sorted=True).values
    best, second = low2[:, 0], low2[:, 1]
    if T > 0:
        arg = torch.argmin(dist, dim=1).to(torch.int32)    # first occurrence
        idx = torch.where(best < _INVALID_DIST, arg, -1)
    else:
        idx = torch.full((Q,), -1, dtype=torch.int32, device=q_desc.device)
    best = torch.where(q_valid, best, _INVALID_DIST)
    second = torch.where(q_valid, second, _INVALID_DIST)
    return idx.to(torch.int32), best.to(torch.int32), second.to(torch.int32)


def _hamming_2nn_cuda(q_desc, q_valid, bank):
    dev = q_desc.device
    Q, T = q_desc.shape[0], bank.desc.shape[0]
    dispatch.check_operand(q_desc, "q_desc", torch.int32, (None, DESC_WORDS), dev)
    dispatch.check_operand(q_valid, "q_valid", torch.bool, (Q,), dev)
    dispatch.check_operand(bank.desc, "bank.desc", torch.int32, (None, DESC_WORDS), dev)
    dispatch.check_operand(bank.pen, "bank.pen", torch.int32, (T,), dev)
    idx, best, second = (torch.empty(Q, dtype=torch.int32, device=dev)
                         for _ in range(3))
    _build.launch(
        "coloc_k2nn", q_desc.data_ptr(), q_valid.data_ptr(),
        bank.desc.data_ptr(), bank.pen.data_ptr(), idx.data_ptr(),
        best.data_ptr(), second.data_ptr(), Q, T, dev.index,
        dispatch.stream_handle(dev))
    dispatch.count_launch("k2nn")
    return idx, best, second


def hamming_2nn_bank(
    q_desc: torch.Tensor, q_valid: torch.Tensor, bank: Bank
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """2-NN against a resident bank: (idx, best, second), each (Q,) int32."""
    if dispatch.use_kernel(q_desc):
        return _hamming_2nn_cuda(q_desc, q_valid, bank)
    return hamming_2nn_plain(q_desc, q_valid, bank)


def hamming_2nn(q_desc: torch.Tensor, t_desc: torch.Tensor,
                q_valid: torch.Tensor, t_valid: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """2-NN of one descriptor set against another (frame against frame):
    the train side is packed as a bank, then the bank path. Where the best
    train row is invalid this reports the kernel's sentinels (idx -1, 2048)
    where coloc_tpu's XLA form reports the penalized distance; the accept
    test rejects both alike."""
    return hamming_2nn_bank(q_desc, q_valid, pack_bank(t_desc, t_valid))
