"""Descriptor matching (counterpart of coloc_tpu.matching).

Accept criteria: margin `second - best > threshold` (KORAL/CUDAK2NN parity)
or Lowe ratio `best < ratio * second` (AKAZE/OpenMVG parity), plus
`best <= 512` so a penalized invalid bank row is never accepted.
"""

from __future__ import annotations

from typing import Optional

import torch

from coloc_tpu_torch.config import MatcherOptions
from coloc_tpu_torch.ops import hamming
from coloc_tpu_torch.types import Features, MapDB, Matches


def _accept(idx, best, second, q_valid, opts: MatcherOptions,
            threshold: int) -> Matches:
    if opts.mode == "ratio":
        ok = best.to(torch.float32) < opts.dist_ratio * second.to(torch.float32)
    else:
        ok = (second - best) > threshold
    # a real hit has Hamming distance <= 512; more means the best was an
    # invalid (penalized) bank row
    ok = ok & q_valid & (best <= 512)
    return Matches(idx=torch.where(ok, idx, -1).to(torch.int32), best=best,
                   second=second)


def match_pair(query: Features, train: Features, opts: MatcherOptions) -> Matches:
    """Frame-vs-frame putative matching (computeMatchesPair parity), with
    the pairwise margin."""
    idx, best, second = hamming.hamming_2nn(query.desc, train.desc,
                                            query.valid, train.valid)
    return _accept(idx, best, second, query.valid, opts,
                   opts.pair_margin_threshold)


def pack_map_bank(mapdb: MapDB) -> hamming.Bank:
    """The device-resident map descriptor bank (setMapData parity)."""
    return hamming.pack_bank(mapdb.desc, mapdb.valid)


def pack_map_bank_twostage(mapdb: MapDB) -> hamming.TwoStageBank:
    """The resident bank of the two-stage large-map matcher (128-bit group
    prefilter + exact 512-bit re-rank, ops/hamming.hamming_2nn_twostage)."""
    return hamming.pack_bank_twostage(mapdb.desc, mapdb.valid)


def match_with_map(query: Features, mapdb: MapDB, opts: MatcherOptions,
                   bank: Optional[hamming.Bank] = None,
                   twostage_bank: Optional[hamming.TwoStageBank] = None) -> Matches:
    """Frame-vs-map matching (matchSceneWithMap parity); idx indexes the
    map's landmark bank. `twostage_bank` (from pack_map_bank_twostage)
    takes precedence, then `bank` (a resident bank from pack_map_bank),
    then the map packed for this call, as in coloc_tpu."""
    if twostage_bank is not None:
        idx, best, second = hamming.hamming_2nn_twostage(
            query.desc, query.valid, twostage_bank)
    else:
        if bank is None:
            bank = pack_map_bank(mapdb)
        idx, best, second = hamming.hamming_2nn_bank(query.desc, query.valid, bank)
    return _accept(idx, best, second, query.valid, opts, opts.margin_threshold)


def match_maps(map_a: MapDB, map_b: MapDB, opts: MatcherOptions) -> Matches:
    """Map-vs-map descriptor matching (matchMapFeatures parity), with the
    map margin; idx indexes map_b's landmark slots."""
    idx, best, second = hamming.hamming_2nn(map_a.desc, map_b.desc, map_a.valid,
                                            map_b.valid)
    return _accept(idx, best, second, map_a.valid, opts, opts.margin_threshold)
