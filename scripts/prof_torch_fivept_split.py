"""Where the time of the port's five-point front (B6), Durand-Kerner (B7)
and polish (B8) kernels goes, on one CUDA card.

    python scripts/prof_torch_fivept_split.py

Builds copies of coloc_tpu_torch/csrc/fivept_front.cu, fivept_dk.cu and
fivept_polish.cu with one part cut out or changed, and times each against
the source as it is, in turns (source, copy, copy, source), by
torch.profiler's device time, at the solver's B = 256 samples
(chip_smoke.py's: two views of a random scene, half of the samples on a
plane) and at B = 2048:

  B6:
    - "no Gauss-Jordan": the 10 elimination steps cut (the tail is read
      from the unreduced columns);
    - "no polynomials": lane 0's Nistér polynomials and determinant cut;
    - "no constraint expansion": the generated eet_entry / row_entry /
      det_term / det_combine calls replaced by copies of their inputs.
  B7:
    - "no iterations": the 24 Durand-Kerner iterations cut (what is left:
      the launch, the loads, the seeds, Newton and the stores);
    - "12 iterations": half of them, for the cost of one;
    - "divisions as products": the update's two divisions by |d|^2 + 1e-20
      made multiplications;
    - "spare lanes on their own": lanes 30-31 run as a fourth group of
      their own instead of repeating lanes 20-21 (they store nothing and
      no live lane reads them, so the output is still checked against the
      source's).
  B8 (on the front's and DK's outputs for those samples):
    - "no Gauss-Newton steps": the 5 steps cut (staging, the 2x2 start,
      the certificate, E and the stores are left);
    - "no contraction": each lane's 2 x 5 row contractions replaced by one
      product a row;
    - "no gather and sums": the octet's sums (the quad's 20 shuffles and
      three sums of 10 terms) replaced by three short sums of the lane's
      vector;
    - "no 2x2 start", "no certificate": x = y = z to start, and no
      certificate;
    - "staging, E and stores alone": the whole polish of a seed pair cut;
    - "divisions as products": the steps' three IEEE divisions by det made
      multiplications;
    - "one sample a CTA": at every B, where the source takes two a CTA for
      B = SMs + 1 .. 2 SMs (checked against the source's output).

Every copy but "spare lanes on their own" and "one sample a CTA"
computes a wrong result. Prints the card's name and power limit beside
the numbers.
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
from coloc_tpu_torch.geometry import fivept  # noqa: E402
from coloc_tpu_torch.ops import _build, dispatch  # noqa: E402

CALLS = 20

FRONT_VARIANTS = {
    "no Gauss-Jordan": [("  for (int k = 0; k < 10; ++k) {", "  for (int k = 0; k < 0; ++k) {")],
    "no polynomials": [("  if (lane != 0) return;", "  return;")],
    "no constraint expansion": [
        ("coloc_fivept::eet_entry(ea, ec, e10);",
         "_Pragma(\"unroll\") for (int i = 0; i < 10; ++i) "
         "e10[i] = ea[i % 4][i % 3] + ec[i % 4][i % 3];"),
        ("coloc_fivept::det_term(d, t20);",
         "_Pragma(\"unroll\") for (int i = 0; i < 20; ++i) t20[i] = d[i % 5][i % 4];"),
        ("coloc_fivept::row_entry(er, dg, ec, e, m);",
         "_Pragma(\"unroll\") for (int i = 0; i < 20; ++i) "
         "m[i] = er[i % 3][i % 10] + dg[i % 3][i % 10] + e[i % 4];"),
        ("coloc_fivept::det_combine(t, m);",
         "_Pragma(\"unroll\") for (int i = 0; i < 20; ++i) m[i] = t[i % 3][i];")],
}
DK_VARIANTS = {
    "no iterations": [("constexpr int kIters = 24;", "constexpr int kIters = 0;")],
    "12 iterations": [("constexpr int kIters = 24;", "constexpr int kIters = 12;")],
    "divisions as products": [
        ("zr - (pr * dr + pi * di) / den", "zr - (pr * dr + pi * di) * den"),
        ("zi - (pi * dr - pr * di) / den", "zi - (pi * dr - pr * di) * den")],
    "spare lanes on their own": [
        ("const int g = min(lane / 10, kGroups - 1), k = lane < 30 ? lane - 10 * g : lane - 30;",
         "const int g = lane / 10, k = lane - 10 * g;")],
}
POLISH_VARIANTS = {
    "no Gauss-Newton steps": [("constexpr int kSteps = 5;", "constexpr int kSteps = 0;")],
    "no contraction": [("for (int i = 0; i < 5; ++i) own[s][i] = contract(md[i], mono);",
                        "for (int i = 0; i < 5; ++i) own[s][i] = md[i][0] * mono[i];")],
    "no gather and sums": [
        ("quad_sums(v, G, H, s0, s1, s2);",
         "s0 = v[0] + v[1] + v[2] + v[3]; s1 = v[4] + v[5] + v[6]; s2 = v[7] + v[8] + v[9];")],
    "no 2x2 start": [("  x = (AtA11 * Atb0 - AtA01 * Atb1) / det2;\n"
                      "  y = (AtA00 * Atb1 - AtA01 * Atb0) / det2;", "  x = z;\n  y = z;")],
    "no certificate": [("  return finite && (maxr < 1e-3f * scale);", "  return x > 0.0f;")],
    "staging, E and stores alone": [
        ("const bool conv = polish_pair(s_in[j], s_in[j] + kCoefWord, G, H, x, y, z);",
         "x = y = z; const bool conv = z > 0.0f;")],
    "divisions as products": [
        ("    const float dx = (c00 * gx + c01 * gy + c02 * gz) / det;",
         "    const float dx = (c00 * gx + c01 * gy + c02 * gz) * det;"),
        ("                      + (Axz * Axy - Axx * Ayz) * gz) / det;",
         "                      + (Axz * Axy - Axx * Ayz) * gz) * det;"),
        ("                      + (Axx * Ayy - Axy * Axy) * gz) / det;",
         "                      + (Axx * Ayy - Axy * Axy) * gz) * det;")],
    "one sample a CTA": [("if (B > sms && B <= 2 * sms)", "if (false)")],
}
# copies whose output must equal the source's
SAME_OUTPUT = ("spare lanes on their own", "one sample a CTA")


def build(name, edits, work):
    """name.cu from the port's csrc with `edits` applied (fivept_front.cu
    with the port's generated header), built by chip_smoke.build_parent ->
    its C launcher."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"{name}.cu: the pattern to replace is not there once:\n{old}")
        src = src.replace(old, new)
    d = Path(tempfile.mkdtemp(prefix=f"{name}-", dir=work))
    (d / f"{name}.cu").write_text(src)
    header = "fivept_constraints.cuh"
    (d / header).write_text((_build.CSRC / header).read_text())
    return chip_smoke.build_parent(d, (name,))[name]


def launcher(tag, fn, args):
    def copy():
        if fn(*args) != 0:
            raise SystemExit(f"{tag}: launch failed")
    return copy


def check_same(tag, copy, got, want):
    """The copy's outputs equal the source's bit for bit (NaN included)."""
    copy()
    torch.cuda.synchronize()
    bits = lambda t: t.view(torch.int32) if t.is_floating_point() else t  # noqa: E731
    if not all(torch.equal(bits(a), bits(b)) for a, b in zip(got, want)):
        raise SystemExit(f"{tag} differs from the source")


def turns(tag, source, copy, kernel, card):
    """Device ms of source and copy in turns (source, copy, copy, source)."""
    ms = {"source": [], "copy": []}
    for which, fn in (("source", source), ("copy", copy), ("copy", copy),
                      ("source", source)):
        ms[which].append(chip_smoke.device_ms(fn, kernel, CALLS))
    mean = {k: None if None in v else sum(v) / len(v) for k, v in ms.items()}
    print(f"[{tag}] device {chip_smoke.fmt_ms(mean['copy'])}; the source "
          f"{chip_smoke.fmt_ms(mean['source'])} (in turns)  ({card})")


def samples(B, dev):
    """chip_smoke.py's five-point samples -> xs (20, B) on dev."""
    rng = np.random.default_rng(B)
    P = np.c_[rng.uniform(-3, 3, (B * 5, 2)), rng.uniform(5, 15, (B * 5, 1))].reshape(B, 5, 3)
    P[B // 2:, :, 2] = 8.0
    Pc = P - [0.3, 0.05, 0.0]
    x1 = torch.from_numpy((P[..., :2] / P[..., 2:]).astype(np.float32)).to(dev)
    x2 = torch.from_numpy((Pc[..., :2] / Pc[..., 2:]).astype(np.float32)).to(dev)
    return torch.cat([x1[:, :, 0], x1[:, :, 1], x2[:, :, 0], x2[:, :, 1]], dim=1).T.contiguous()


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
    # a first profiler session can miss the device's activity: spend it here
    chip_smoke.device_ms(lambda: torch.ones(1, device=dev) + 1, "elementwise", 1)
    work = Path(tempfile.mkdtemp(prefix="coloc-split-"))
    stream = dispatch.stream_handle(dev)
    front = {tag: build("fivept_front", edits, work)
             for tag, edits in FRONT_VARIANTS.items()}
    dk = {tag: build("fivept_dk", edits, work) for tag, edits in DK_VARIANTS.items()}
    polish = {tag: build("fivept_polish", edits, work)
              for tag, edits in POLISH_VARIANTS.items()}
    for B in (256, 2048):
        xs = samples(B, dev)
        outs = [torch.empty(shape + (B,), device=dev)
                for shape in ((36,), (40, 20), (40,), (11,))]
        for tag, fn in front.items():
            args = (xs.data_ptr(), *(o.data_ptr() for o in outs), B, dev.index, stream)
            turns(f"fivept_front B={B}, {tag}", lambda: fivept._front_cuda(xs),
                  launcher(f"fivept_front {tag}", fn, args), "front_kernel", card)
        basis, md, coef, npoly = fivept._front_cuda(xs)
        c, s = fivept.dk_normalise(npoly)
        want = fivept._dk_cuda(c, s)
        for tag, fn in dk.items():
            got = (torch.empty((10, B), device=dev),
                   torch.empty((10, B), dtype=torch.bool, device=dev))
            args = (c.data_ptr(), s.data_ptr(), *(o.data_ptr() for o in got), B, dev.index,
                    stream)
            copy = launcher(f"fivept_dk {tag}", fn, args)
            if tag in SAME_OUTPUT:
                check_same(f"fivept_dk {tag}", copy, got, want)
            turns(f"fivept_dk B={B}, {tag}", lambda: fivept._dk_cuda(c, s), copy, "dk_kernel",
                  card)
        delta = 0.01 * (want[0].abs() + 1.0)
        pol = (md, coef, basis, torch.cat([want[0], want[0] + delta, want[0] - delta]),
               want[1].repeat(3, 1).contiguous())
        want = fivept._polish_cuda(*pol)
        for tag, fn in polish.items():
            got = (torch.empty((B, 30, 9), device=dev),
                   torch.empty((B, 30), dtype=torch.bool, device=dev))
            args = (*(t.data_ptr() for t in pol), *(o.data_ptr() for o in got), B, dev.index,
                    stream)
            copy = launcher(f"fivept_polish {tag}", fn, args)
            if tag in SAME_OUTPUT:
                check_same(f"fivept_polish {tag}", copy, got, want)
            turns(f"fivept_polish B={B}, {tag}", lambda: fivept._polish_cuda(*pol), copy,
                  "polish_kernel", card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
