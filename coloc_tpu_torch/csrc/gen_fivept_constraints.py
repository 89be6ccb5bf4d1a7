#!/usr/bin/env python3
"""Generate csrc/fivept_constraints.cuh from the port's five-point module.

    python3 coloc_tpu_torch/csrc/gen_fivept_constraints.py

The cubic-constraint expansion of the five-point solver (the 10x20
coefficient matrix over Nistér's monomials) is polynomial bookkeeping that
coloc_tpu runs at trace time. CUDA has no trace time, so this script runs
the port's own polynomial arithmetic (geometry/fivept.py's _Poly) on
symbolic values and writes every multiply, add and subtract it performs,
in its order, as one statement of straight-line CUDA. The plain twin runs
the same arithmetic on tensors, so kernel and twin round alike.

The kernel spreads a sample's rows over the lanes of a warp, and lanes
that run different straight-line code serialize. Rows 1-9 are the nine
entries 2 (E E^T E)[r][c] - tr(E E^T) E[r][c], which share one operation
sequence whatever (r, c), so the header carries that sequence once, in two
steps a lane runs for its own (r, c):

  eet_entry   (E E^T)[r][c], 10 coefficients, from rows r and c of E;
  row_entry   row 1 + 3 r + c of M, from (E E^T)[r][k] (k = 0..2), the
              diagonal (E E^T)[k][k] (for the trace), column c of E and
              E[r][c];

Row 0, det E, is _constraint_rows' cofactor expansion T_0 - T_1 + T_2:
det_term forms one cofactor term T_j (one code path for the three lanes
that run it) and det_combine adds them up. md_rows maps a row of M to its three rows of
M D_x, M D_y, M D_z (front_plain's MD loop), into any indexable out (the
kernel's is its shared-memory stage). Each function stores an output as
soon as it is formed.

tests/test_torch_twoview.py checks that the committed header equals this
script's output, and runs the header's statements in numpy float32 to
show that they give front_plain's M bit for bit.
"""

from __future__ import annotations

import re
import sys
from pathlib import Path

HEADER = Path(__file__).resolve().parent / "fivept_constraints.cuh"


class _Sym:
    """A named float value of the generated code; every arithmetic
    operation on it appends one statement."""

    __slots__ = ("em", "name")

    def __init__(self, em, name):
        self.em, self.name = em, name

    def __add__(self, o):
        return self.em.op(f"{self.name} + {_ref(o)}")

    def __radd__(self, o):
        return self.em.op(f"{_ref(o)} + {self.name}")

    def __sub__(self, o):
        return self.em.op(f"{self.name} - {_ref(o)}")

    def __mul__(self, o):
        return self.em.op(f"{self.name} * {_ref(o)}")

    def __rmul__(self, o):
        return self.em.op(f"{_ref(o)} * {self.name}")

    def __neg__(self):
        return self.em.op(f"-{self.name}")


def _ref(v) -> str:
    if isinstance(v, _Sym):
        return v.name
    return f"{float(v)!r}f"


class _Emitter:
    def __init__(self):
        self.lines = []

    def op(self, expr: str) -> _Sym:
        name = f"t{len(self.lines)}"
        self.lines.append(f"  const float {name} = {expr};")
        return _Sym(self, name)

    def inputs(self, fmt, *shape):
        """Nested lists of named inputs, e.g. fmt "a[{}][{}]" over (4, 3)."""
        if len(shape) == 1:
            return [_Sym(self, fmt.format(i)) for i in range(shape[0])]
        return [self.inputs(fmt.replace("{}", str(i), 1), *shape[1:])
                for i in range(shape[0])]


def _function(signature, em, outputs, template=None):
    """A device function: the emitter's statements, each output stored as
    soon as it is formed (out[i] = value; constant outputs first)."""
    stores = {}
    body = []
    for i, v in enumerate(outputs):
        if isinstance(v, _Sym):
            stores.setdefault(v.name, []).append(i)
        else:
            body.append(f"  out[{i}] = {_ref(v)};")
    for line in em.lines:
        body.append(line)
        name = re.match(r"  const float (t\d+) = ", line).group(1)
        body += [f"  out[{i}] = {name};" for i in stores.pop(name, [])]
    body += [f"  out[{i}] = {name};" for name, idx in stores.items() for i in idx]
    head = [template] if template else []
    return [*head, "__device__ __forceinline__ void " + signature + " {", *body, "}", ""]


def _e_poly(fivept, xyzw):
    # E[r][c] as _constraint_rows builds it: x, y, z, then the constant
    return fivept._Poly({(1, 0, 0): xyzw[0], (0, 1, 0): xyzw[1],
                         (0, 0, 1): xyzw[2], (0, 0, 0): xyzw[3]})


def render() -> str:
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    from coloc_tpu_torch.geometry import fivept

    Poly = fivept._Poly

    # (E E^T)[r][c] = sum_k E[r][k] E^T[k][c], matmul's order in _constraint_rows
    em = _Emitter()
    a, c = em.inputs("a[{}][{}]", 4, 3), em.inputs("c[{}][{}]", 4, 3)
    eet = sum((_e_poly(fivept, [a[v][k] for v in range(4)])
               * _e_poly(fivept, [c[v][k] for v in range(4)]) for k in range(3)), Poly())
    eet_keys = list(eet.terms)
    assert len(eet_keys) == 10
    eet_fn = _function("eet_entry(const float (&a)[4][3], const float (&c)[4][3], "
                       "float (&out)[10])", em, list(eet.terms.values()))

    # row 1 + 3 r + c: 2 (E E^T E)[r][c] - tr(E E^T) E[r][c]
    em = _Emitter()
    er, dg = em.inputs("er[{}][{}]", 3, 10), em.inputs("dg[{}][{}]", 3, 10)
    ec, e = em.inputs("ec[{}][{}]", 4, 3), em.inputs("e[{}]", 4)

    def as_poly(coefs):
        return Poly(dict(zip(eet_keys, coefs)))

    eete = sum((as_poly(er[k]) * _e_poly(fivept, [ec[v][k] for v in range(4)])
                for k in range(3)), Poly())
    trace = as_poly(dg[0]) + as_poly(dg[1]) + as_poly(dg[2])
    eq = Poly.const(2.0) * eete - trace * _e_poly(fivept, e)
    row_fn = _function("row_entry(const float (&er)[3][10], const float (&dg)[3][10], "
                       "const float (&ec)[4][3], const float (&e)[4], float (&out)[20])",
                       em, [eq.coeff(m) for m in fivept._MONOMIALS])

    # row 0, det E = T0 - T1 + T2 with T_j = E[0][j] (E[1][a] E[2][b] -
    # E[1][b] E[2][a]), (a, b) = (1, 2), (0, 2), (0, 1): _constraint_rows'
    # expression, a term a lane, then the combination
    em = _Emitter()
    d = em.inputs("d[{}][{}]", 5, 4)
    P = [_e_poly(fivept, d[i]) for i in range(5)]
    term = P[0] * (P[1] * P[2] - P[3] * P[4])
    term_keys = list(term.terms)
    det_term_fn = _function(f"det_term(const float (&d)[5][4], float (&out)[{len(term_keys)}])",
                            em, list(term.terms.values()))
    em = _Emitter()
    tj = em.inputs("t[{}][{}]", 3, len(term_keys))
    T = [Poly(dict(zip(term_keys, tj[j]))) for j in range(3)]
    det = T[0] - T[1] + T[2]
    det_fn = _function(f"det_combine(const float (&t)[3][{len(term_keys)}], float (&out)[20])",
                       em, [det.coeff(m) for m in fivept._MONOMIALS])

    # M D_a for one row of M: out[20 a + j] = (M D_a)[j], front_plain's sums
    em = _Emitter()
    m = em.inputs("m[{}]", 20)
    md = []
    for a_ in range(3):
        for j in range(20):
            acc = 0.0
            for k, val in fivept._DIFF_TERMS[a_][j]:
                acc = acc + val * m[k]
            md.append(acc)
    md_fn = _function("md_rows(const float (&m)[20], Out out)", em, md,
                      template="template <class Out>")

    return "\n".join([
        "// GENERATED by csrc/gen_fivept_constraints.py from",
        "// coloc_tpu_torch/geometry/fivept.py (_Poly, _constraint_rows, _DIFF_TERMS).",
        "// Do not edit.",
        "//",
        "// One statement per arithmetic operation of the plain twin, in its order.",
        "// The null basis X, Y, Z, W is four row-major 3x3 matrices; E = x X +",
        "// y Y + z Z + W; a 4x3 argument holds (X, Y, Z, W) by rows of E, so",
        "// a[v][k] is basis v at (r, k). M rows are over fivept._MONOMIALS.",
        "//   eet_entry(rows r and c of E) -> (E E^T)[r][c], coefficients in the",
        "//     order row_entry reads them;",
        "//   row_entry((E E^T)[r][0..2], (E E^T)[k][k] for k = 0..2, column c",
        "//     of E (ec[v][k] = basis v at (k, c)), E[r][c]) -> M row 1 + 3 r + c;",
        "//   det_term(E[0][j], E[1][a], E[2][b], E[1][b], E[2][a], each as",
        "//     (x, y, z, 1) coefficients) -> T_j = E[0][j] (E[1][a] E[2][b] -",
        "//     E[1][b] E[2][a]), (a, b) = (1, 2), (0, 2), (0, 1) for j = 0, 1, 2;",
        "//   det_combine(T_0, T_1, T_2) -> M row 0 = det E = T_0 - T_1 + T_2;",
        "//   md_rows(a row of M, out) -> its rows of M D_x, M D_y, M D_z,",
        "//     out[20 a + j] = (M D_a)[j], each stored as soon as it is formed.",
        "#pragma once",
        "",
        "namespace coloc_fivept {",
        "",
        *eet_fn,
        *row_fn,
        *det_term_fn,
        *det_fn,
        *md_fn,
        "}  // namespace coloc_fivept",
        "",
    ])


if __name__ == "__main__":
    HEADER.write_text(render())
    print(f"wrote {HEADER}")
