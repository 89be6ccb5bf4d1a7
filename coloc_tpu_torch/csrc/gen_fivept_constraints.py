#!/usr/bin/env python3
"""Generate csrc/fivept_constraints.cuh from the port's five-point module.

    python3 coloc_tpu_torch/csrc/gen_fivept_constraints.py

The cubic-constraint expansion of the five-point solver (the 10x20
coefficient matrix over Nistér's monomials) is polynomial bookkeeping that
coloc_tpu runs at trace time. CUDA has no trace time, so this script runs
the port's own _constraint_rows (geometry/fivept.py) on symbolic values
and writes every multiply, add and subtract it performs, in its order, as
one statement of straight-line CUDA. The plain twin runs the same
_constraint_rows on tensors, so kernel and twin round alike. The header
also carries the differentiation terms (_DIFF_TERMS) that assemble MD.

tests/test_torch_twoview.py checks that the committed header equals this
script's output.
"""

from __future__ import annotations

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


def render() -> str:
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    from coloc_tpu_torch.geometry import fivept

    em = _Emitter()
    basis = [[[_Sym(em, f"{n}[{3 * r + c}]") for c in range(3)] for r in range(3)]
             for n in ("X", "Y", "Z", "W")]
    rows = fivept._constraint_rows(*basis)
    body = list(em.lines)
    for r, rr in enumerate(rows):
        for c, v in enumerate(rr):
            body.append(f"  M[{r * 20 + c}] = {_ref(v)};")

    diff_k = [[terms[0][0] if terms else -1 for terms in fivept._DIFF_TERMS[a]]
              for a in range(3)]
    diff_v = [[terms[0][1] if terms else 0.0 for terms in fivept._DIFF_TERMS[a]]
              for a in range(3)]
    assert all(len(t) <= 1 for a in fivept._DIFF_TERMS for t in a)

    def table(rows, fmt):
        return ",\n".join("    {" + ", ".join(fmt(v) for v in row) + "}"
                          for row in rows)

    return "\n".join([
        "// GENERATED by csrc/gen_fivept_constraints.py from",
        "// coloc_tpu_torch/geometry/fivept.py::_constraint_rows. Do not edit.",
        "//",
        "// constraint_rows: the 10x20 cubic-constraint matrix of the null basis",
        "// X, Y, Z, W (each a row-major 3x3), one statement per arithmetic",
        "// operation of the plain twin, in its order (row-major M[r * 20 + c]).",
        "// kDiffK / kDiffVal: (M D_a)[:, j] = kDiffVal[a][j] * M[:, kDiffK[a][j]]",
        "// (kDiffK -1: the column is zero).",
        "#pragma once",
        "",
        "namespace coloc_fivept {",
        "",
        "__constant__ int kDiffK[3][20] = {",
        table(diff_k, str),
        "};",
        "",
        "__constant__ float kDiffVal[3][20] = {",
        table(diff_v, lambda v: f"{v!r}f"),
        "};",
        "",
        "__device__ __forceinline__ void constraint_rows(",
        "    const float* X, const float* Y, const float* Z, const float* W,",
        "    float* M) {",
        *body,
        "}",
        "",
        "}  // namespace coloc_fivept",
        "",
    ])


if __name__ == "__main__":
    HEADER.write_text(render())
    print(f"wrote {HEADER}")
