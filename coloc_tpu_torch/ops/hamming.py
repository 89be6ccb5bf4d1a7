"""Brute-force 512-bit Hamming 2-NN (counterpart of coloc_tpu.ops.hamming).

Reference parity: CUDAK2NN — each query scans the whole training bank and
keeps best, second-best and the index of the best; the accept test lives in
matching.py.

  pack_bank          — the device-resident bank (setMapData parity): packed
                       words + a per-row penalty (0 valid, 2048 invalid)
  hamming_2nn_bank   — 2-NN against a resident bank: the CUDA kernel
                       csrc/k2nn.cu on a CUDA tensor, hamming_2nn_plain on CPU
  hamming_2nn_plain  — the kernel's plain twin (+-1 float matmul, exact)
  pack_bank_twostage / hamming_2nn_twostage — the two-stage matcher for
                       very large banks: a 128-bit group prefilter (B12,
                       csrc/k2nn_group.cu on a CUDA tensor, group_top2_plain
                       on CPU), then an exact 512-bit re-rank of the
                       survivors in PyTorch ops

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
    """(N, W) int32 packed bits -> (N, 32 W) +-1 of `dtype` (bit 0 of word 0
    first; (N, 16) -> (N, 512) for a descriptor)."""
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    bits = (desc[:, :, None] >> shifts) & 1
    bits = bits.reshape(desc.shape[0], -1)
    return (2 * bits - 1).to(dtype)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(N, 32 W) {0,1} -> (N, W) int32 words, inverse of the unpack layout
    ((N, 512) -> (N, 16) for a descriptor)."""
    b = bits.reshape(bits.shape[0], -1, 32).to(torch.int64)
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


# ---------------------------------------------------------------------------
# Two-stage matcher for very large banks
# ---------------------------------------------------------------------------
#
# Stage 1 keeps, for every group of _GROUP bank rows, the top two rows by a
# 128-bit prefilter (every fourth descriptor bit, as a +-1 dot); stage 2
# re-ranks the 2 T / _GROUP survivors with exact 512-bit distances. The
# best match is exact whenever its group-local prefilter rank is <= 2,
# which holds for matching-shaped data (a true match sits tens of bits
# below the background); the second-best is the minimum over the
# survivors, so margins may be biased up. coloc_tpu keeps it off the
# default path (brute force won on the TPU); see PERF.md for this card.

_GROUP = 2048                    # bank rows a prefilter group
_PF_STRIDE = 4                   # prefilter bit = every fourth descriptor bit
_PF_WORDS = DESC_BITS // _PF_STRIDE // 32
_CAND_IDX_MASK = (1 << 20) - 1   # candidate index field of the re-rank key
_RERANK_INVALID = 600            # > any real distance, keeps keys in int32
_PEN_KEY = -2 * _INVALID_DIST * 65536


class TwoStageBank(NamedTuple):
    pf: torch.Tensor       # (Tp, 4) int32: the 128 prefilter bits a row, packed;
                           # Tp = T rounded up to _GROUP, padding rows zero
    penrcol: torch.Tensor  # (Tp,) int32: pen * 65536 + (_GROUP - 1 - row % _GROUP),
                           # pen = -4096 for an invalid or padding row, else 0
    desc: torch.Tensor     # (T, 16) int32 packed descriptors (stage 2 reads them)
    valid: torch.Tensor    # (T,) bool


def prefilter_words(desc: torch.Tensor) -> torch.Tensor:
    """(N, 16) packed descriptors -> (N, 4) int32: bits 0, 4, ..., 508
    (coloc_tpu's `[:, ::4]` of the +-1 form), packed in order."""
    return pack_bits(unpack_bipolar(desc)[:, ::_PF_STRIDE] > 0)


def pack_bank_twostage(t_desc: torch.Tensor, t_valid: torch.Tensor) -> TwoStageBank:
    """The resident two-stage bank; groups pad to _GROUP rows with invalid
    rows whose prefilter operand is zero."""
    T = t_desc.shape[0]
    if T > _CAND_IDX_MASK + 1:
        # the re-rank key packs the candidate index into 20 bits; a larger
        # bank would bleed indices into the distance field
        raise ValueError(
            f"two-stage bank capped at {_CAND_IDX_MASK + 1} rows (got {T});"
            " shard the bank instead"
        )
    Tp = -(-T // _GROUP) * _GROUP
    dev = t_desc.device
    pf = torch.nn.functional.pad(prefilter_words(t_desc.to(torch.int32)),
                                 (0, 0, 0, Tp - T))
    pen = torch.full((Tp,), _PEN_KEY, dtype=torch.int32, device=dev)
    pen[:T] = torch.where(t_valid, 0, _PEN_KEY).to(torch.int32)
    rcol = (_GROUP - 1) - torch.arange(Tp, dtype=torch.int32, device=dev) % _GROUP
    return TwoStageBank(pf=pf.contiguous(), penrcol=(pen + rcol).contiguous(),
                        desc=t_desc.to(torch.int32).contiguous(),
                        valid=t_valid.contiguous())


def group_top2_plain(q_pf: torch.Tensor, bank: TwoStageBank
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of csrc/k2nn_group.cu (coloc_tpu's _group_top2_xla form):
    (Q, 4) query prefilter words -> (idx1, idx2), each (Q, G) int32, the
    global rows of the two largest keys (dot << 16) + penrcol per group.
    The +-1 float product is exact (|dot| <= 128); a padding row's operand
    is zero, as coloc_tpu pads its int8 operand, so its dot is 0. Keys are
    unique within a group (the reversed column), so the order is total."""
    Q, Tp = q_pf.shape[0], bank.pf.shape[0]
    G = Tp // _GROUP
    st = unpack_bipolar(bank.pf, torch.float32)
    st[bank.desc.shape[0]:] = 0.0
    dot = (unpack_bipolar(q_pf, torch.float32) @ st.T).to(torch.int32)
    key = ((dot << 16) + bank.penrcol).reshape(Q, G, _GROUP)
    top2 = torch.topk(key, 2, dim=-1).values
    base = torch.arange(G, dtype=torch.int32, device=q_pf.device) * _GROUP
    idx1 = (_GROUP - 1) - (top2[..., 0] & 65535) + base
    idx2 = (_GROUP - 1) - (top2[..., 1] & 65535) + base
    return idx1.to(torch.int32), idx2.to(torch.int32)


def _group_top2_cuda(q_pf, bank):
    dev = q_pf.device
    Q, Tp = q_pf.shape[0], bank.pf.shape[0]
    T, G = bank.desc.shape[0], Tp // _GROUP
    dispatch.check_operand(q_pf, "q_pf", torch.int32, (Q, _PF_WORDS), dev)
    dispatch.check_operand(bank.pf, "bank.pf", torch.int32, (Tp, _PF_WORDS), dev)
    dispatch.check_operand(bank.penrcol, "bank.penrcol", torch.int32, (Tp,), dev)
    if Tp % _GROUP or not 0 < T <= Tp or q_pf.data_ptr() % 16 or bank.pf.data_ptr() % 16:
        raise ValueError(f"two-stage bank of {T} rows padded to {Tp}: needs "
                         f"whole {_GROUP}-row groups and 16-byte aligned rows")
    idx1 = torch.empty((Q, G), dtype=torch.int32, device=dev)
    idx2 = torch.empty((Q, G), dtype=torch.int32, device=dev)
    _build.launch("coloc_k2nn_group", q_pf.data_ptr(), bank.pf.data_ptr(),
                  bank.penrcol.data_ptr(), idx1.data_ptr(), idx2.data_ptr(),
                  Q, T, G, dev.index, dispatch.stream_handle(dev))
    dispatch.count_launch("k2nn_group")
    return idx1, idx2


def group_top2(q_pf: torch.Tensor, bank: TwoStageBank
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage 1: the two best rows of every bank group by the 128-bit
    prefilter -> (idx1, idx2), each (Q, G) int32 global row indices."""
    if dispatch.use_kernel(q_pf):
        return _group_top2_cuda(q_pf.contiguous(), bank)
    return group_top2_plain(q_pf, bank)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word (SWAR on the unsigned value in int64)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def hamming_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact popcount Hamming distance between packed descriptor rows,
    int32 (..., W) -> (...,) int32: the test oracle, plain PyTorch on any
    device (no kernel)."""
    return _popcount32(torch.bitwise_xor(a, b)).sum(dim=-1).to(torch.int32)


def hamming_2nn_twostage(q_desc: torch.Tensor, q_valid: torch.Tensor,
                         bank: TwoStageBank
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Two-stage 2-NN against a resident large bank: (idx, best, second),
    each (Q,) int32, the contract of hamming_2nn_bank on the survivors."""
    T = bank.desc.shape[0]
    idx1, idx2 = group_top2(prefilter_words(q_desc), bank)
    cand = torch.cat([idx1, idx2], dim=1).to(torch.int64)        # (Q, 2G)

    # stage 2: exact 512-bit distances of the survivors
    safe = torch.clamp(cand, 0, T - 1)
    dist = _popcount32(bank.desc[safe] ^ q_desc[:, None, :]).sum(dim=-1)
    ok = (cand >= 0) & (cand < T) & bank.valid[safe]
    dist = torch.where(ok, dist, _RERANK_INVALID)
    # distance-major key, lowest index on ties (the brute-force kernel's
    # rule); candidate indices are unique, so masking exactly the minimum
    # and reducing again leaves a duplicate of the best as second
    skey = dist * (_CAND_IDX_MASK + 1) + safe
    k1 = skey.amin(dim=1, keepdim=True)
    k2 = torch.where(skey == k1, 2 ** 30, skey).amin(dim=1)
    k1 = k1[:, 0]
    best_idx = k1 & _CAND_IDX_MASK
    best, second = k1 >> 20, k2 >> 20
    best = torch.where(best >= _RERANK_INVALID, _INVALID_DIST, best)
    second = torch.where(second >= _RERANK_INVALID, _INVALID_DIST, second)
    best = torch.where(q_valid, best, _INVALID_DIST)
    second = torch.where(q_valid, second, _INVALID_DIST)
    return (best_idx.to(torch.int32), best.to(torch.int32),
            second.to(torch.int32))
