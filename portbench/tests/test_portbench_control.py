"""The control on the card: the reference in float32 with its products in
TF32, put in the program's place, fails the cell's limits, while the
program passes them. At a test's size (240x320 frames); the readings at
the cells' own sizes are `python3 -m portbench.control`'s, in PERF.md."""

from __future__ import annotations

import pytest

from portbench import common, control, run
from portbench.tests.conftest import tiny


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", ["koral-session-d2", "koral-serve-b64"])
def test_control_fails_program_passes(card, cell_name):
    _, cfg, traffic = tiny(cell_name)
    limits = common.load_json(common.ROOT / "limits" / f"{cell_name}.json")
    for seed in (101, 102, 103):
        cell = run.make_cell(cfg, traffic, seed, card)
        r = control.readings(cell, 1.0, control=True)
        assert run.passes(run.check_lines(r["program"], limits)), r
        assert not run.passes(run.check_lines(r["control"], limits)), r
