"""Where the time of the port's two-stage prefilter (B12) and epipolar rank
(B9) kernels goes, on one CUDA card.

    python scripts/prof_torch_rank_split.py

Builds copies of coloc_tpu_torch/csrc/k2nn_group.cu and epi_rank.cu with
one part cut out or put back, and times each against the source as it is,
in turns (source, copy, copy, source), by torch.profiler's device time:

  B12 at Q=1024 x T=262144 (random descriptors, 5% of rows invalid):
    - "mma only": the top-2 epilogue cut to an XOR of the accumulators (the
      1-bit MMAs, the fragment loads and the staging remain);
    - "epilogue only": each MMA replaced by four bit-field extracts of its
      B operand (the keys and top-2 pushes remain);
    - "warp vote": a warp skips a fragment's pushes when no lane's key
      beats its second (exact; the design the source does not use).
  B9 at Hm=7680 x M=1024, with 10% and with 80% of the points masked:
    - "staging only": the compute loop cut out (the model copy, the point
      staging and compaction, the odd-mask pass and the reduction remain).

Every copy but "warp vote" computes a wrong result; the vote copy is
checked against the source's output. Prints the card's name and power
limit beside the numbers.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from coloc_tpu_torch.ops import _build, dispatch, hamming, ransac_rank  # noqa: E402

CALLS = 20

GROUP_KEYS = '''        key[i][0] = acc[0] * 262144 + rt.x;
        key[i][1] = acc[1] * 262144 + rt.y;
        key[i][2] = acc[2] * 262144 + rt.x;
        key[i][3] = acc[3] * 262144 + rt.y;'''
GROUP_PUSH = '''#pragma unroll
      for (int i = 0; i < kTiles; ++i) {
        push2(k1[i][0], k2[i][0], key[i][0], key[i][1]);
        push2(k1[i][1], k2[i][1], key[i][2], key[i][3]);
      }'''
GROUP_MMA = "        mma_and_popc(acc, a[i][0], a[i][1], b);"
EPI_LOOP = "    for (int p = 4 * warp; p < padded; p += 4 * kWarps) {"

GROUP_VARIANTS = {
    "mma only": [(GROUP_KEYS, '''        key[i][0] = acc[0] ^ rt.x;
        key[i][1] = acc[1];
        key[i][2] = acc[2] ^ rt.y;
        key[i][3] = acc[3];'''),
                 (GROUP_PUSH, '''#pragma unroll
      for (int i = 0; i < kTiles; ++i) {
        k1[i][0] ^= key[i][0] ^ key[i][1];
        k1[i][1] ^= key[i][2] ^ key[i][3];
      }''')],
    "epilogue only": [(GROUP_MMA, '''        acc[0] = b & 127;
        acc[1] = (b >> 7) & 127;
        acc[2] = (b >> 14) & 127;
        acc[3] = (b >> 21) & 127;''')],
    "warp vote": [(GROUP_PUSH, '''      bool need = false;
#pragma unroll
      for (int i = 0; i < kTiles; ++i)
        need |= max(key[i][0], key[i][1]) > k2[i][0] || max(key[i][2], key[i][3]) > k2[i][1];
      if (__any_sync(0xffffffffu, need)) {
#pragma unroll
        for (int i = 0; i < kTiles; ++i) {
          push2(k1[i][0], k2[i][0], key[i][0], key[i][1]);
          push2(k1[i][1], k2[i][1], key[i][2], key[i][3]);
        }
      }''')],
}
EPI_VARIANTS = {
    "staging only": [(EPI_LOOP, "    for (int p = 4 * warp; p < 0; p += 4 * kWarps) {")],
}


def build(name, edits, work):
    """name.cu from the port's csrc with `edits` applied, built by
    chip_smoke.build_parent -> its C launcher."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"{name}.cu: the pattern to replace is not there once:\n{old}")
        src = src.replace(old, new)
    d = Path(tempfile.mkdtemp(prefix=f"{name}-", dir=work))
    (d / f"{name}.cu").write_text(src)
    return chip_smoke.build_parent(d, (name,))[name]


def turns(tag, source, copy, kernel, card):
    """Device ms of source and copy in turns (source, copy, copy, source)."""
    ms = {"source": [], "copy": []}
    for which, fn in (("source", source), ("copy", copy), ("copy", copy),
                      ("source", source)):
        ms[which].append(chip_smoke.device_ms(fn, kernel, CALLS))
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    print(f"[{tag}] device {mean['copy']:.4f} ms; the source {mean['source']:.4f} ms "
          f"(in turns)  ({card})")


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(card)
    _build.load()
    work = Path(tempfile.mkdtemp(prefix="coloc-split-"))
    stream = dispatch.stream_handle(dev)

    # B12
    rng = np.random.default_rng(0)
    Q, T = 1024, 262144
    td = torch.from_numpy(rng.integers(0, 2 ** 32, (T, 16), dtype=np.uint64)
                          .astype(np.uint32).view(np.int32)).to(dev)
    qd = torch.from_numpy(rng.integers(0, 2 ** 32, (Q, 16), dtype=np.uint64)
                          .astype(np.uint32).view(np.int32)).to(dev)
    bank = hamming.pack_bank_twostage(td, torch.from_numpy(rng.random(T) > 0.05).to(dev))
    q_pf = hamming.prefilter_words(qd)
    G = bank.pf.shape[0] // hamming._GROUP
    want = hamming._group_top2_cuda(q_pf, bank)
    for tag, edits in GROUP_VARIANTS.items():
        fn = build("k2nn_group", edits, work)
        outs = [torch.empty((Q, G), dtype=torch.int32, device=dev) for _ in range(2)]
        args = (q_pf.data_ptr(), bank.pf.data_ptr(), bank.penrcol.data_ptr(),
                *(o.data_ptr() for o in outs), Q, T, G, dev.index, stream)

        def copy(fn=fn, args=args):
            if fn(*args) != 0:
                raise SystemExit(f"k2nn_group {tag}: launch failed")
        if tag == "warp vote":
            copy()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(outs, want)):
                raise SystemExit("k2nn_group with the warp vote differs from the source")
        turns(f"k2nn_group Q={Q} x T={T}, {tag}", lambda: hamming._group_top2_cuda(q_pf, bank),
              copy, "k2nn_group_kernel", card)

    # B9
    Hm, M = 7680, 1024
    for masked in (0.1, 0.8):
        Es = torch.from_numpy(rng.normal(size=(Hm, 3, 3)).astype(np.float32))
        x1 = torch.from_numpy(rng.uniform(-0.6, 0.6, (M, 2)).astype(np.float32))
        x2 = x1 + torch.from_numpy(rng.normal(0, 0.01, (M, 2)).astype(np.float32))
        valid = torch.from_numpy(rng.random(M) > masked)
        ops = [t.to(dev).contiguous() for t in ransac_rank.epipolar_operands(
            Es, x1, x2, valid, 451.2 ** 2, 480.0 ** 2, 16.0)]
        for tag, edits in EPI_VARIANTS.items():
            fn = build("epi_rank", edits, work)
            out = torch.empty(Hm, device=dev)
            args = (*(t.data_ptr() for t in ops), out.data_ptr(), Hm, M, -2, 5, dev.index,
                    stream)

            def copy(fn=fn, args=args):
                if fn(*args) != 0:
                    raise SystemExit(f"epi_rank {tag}: launch failed")
            turns(f"epi_rank Hm={Hm} x M={M}, {int(valid.sum())} unmasked, {tag}",
                  lambda: ransac_rank._epi_rank_cuda(*ops, 2, 5), copy, "epi_rank_kernel", card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
