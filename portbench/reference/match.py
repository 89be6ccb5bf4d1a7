"""Nearest and second-nearest map descriptor by Hamming distance, XOR and
population count on 32-bit words, and the accept tests: the margin
(second - best > threshold) or the ratio (best < ratio x second)."""

from __future__ import annotations

import torch

_M1, _M2, _M4, _H01 = 0x55555555, 0x33333333, 0x0F0F0F0F, 0x01010101


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word, held in int64."""
    x = x & 0xFFFFFFFF
    x = x - ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    return ((x * _H01) & 0xFFFFFFFF) >> 24


def two_nearest(q: torch.Tensor, bank: torch.Tensor, bank_valid: torch.Tensor, chunk: int = 256):
    """Query words (Q, W) against bank words (T, W) -> (index of the
    nearest valid row, lowest on ties; its distance; the second least
    distance over the other valid rows), each (Q,) int64."""
    qs, bs = q.to(torch.int64), bank.to(torch.int64)
    idx, best, second = [], [], []
    big = torch.iinfo(torch.int64).max // 4
    for i in range(0, qs.shape[0], chunk):
        d = popcount32(qs[i:i + chunk, None, :] ^ bs[None]).sum(-1)      # (c, T)
        d = torch.where(bank_valid[None], d, big)
        two = torch.topk(d, 2, dim=1, largest=False, sorted=True).values
        idx.append(torch.argmin(d, dim=1))
        best.append(two[:, 0])
        second.append(two[:, 1])
    return torch.cat(idx), torch.cat(best), torch.cat(second)


def match(q_words, q_valid, bank_words, bank_valid, mode: str, margin: int, ratio: float):
    """-> the map slot of each query (Q,) int64, -1 where rejected."""
    idx, best, second = two_nearest(q_words, bank_words, bank_valid)
    if mode == "ratio":
        ok = best.double() < ratio * second.double()
    else:
        ok = (second - best) > margin
    ok = ok & q_valid & (best <= 512)
    return torch.where(ok, idx, -1)
