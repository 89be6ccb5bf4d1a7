"""The AKAZE frontend's per-device constant tables (akaze._level_tables,
ops/mldb._disc_on and _grid_on): each equal, value and dtype, to the
tensor that the frontend built from numpy on every call before they were
cached (a captured step may not copy from the host), and a second call
returns the cached tensor itself. Every per-device table that a captured
step reads, TRIP's too, stays cached for the life of the process: a CUDA
graph holds no reference to it. The port only.
"""

import numpy as np
import pytest
import torch

from coloc_tpu_torch import akaze, frontend
from coloc_tpu_torch.ops import descriptor, diffusion, mldb, orientation, patches, pyramid
from coloc_tpu_torch.sfm import ba
from port_harness import one_torch_thread, time_limit  # noqa: F401

CPU = torch.device("cpu")


def _same(a, b):
    return a.dtype == b.dtype and torch.equal(a, b)


@pytest.fixture(scope="module")
def levels():
    img = torch.from_numpy(np.random.default_rng(0).uniform(0, 255, (2, 96, 160))
                           .astype(np.float32))
    return diffusion.build_scale_space_batch(img, num_octaves=2, num_sublevels=3)


def test_level_tables_equal_the_inline_tensors(levels):
    sp = patches.stack_levels_batch([ev.response for ev in levels])
    geom = (tuple(int(r) for r in sp.row_base), tuple(int(h) for h in sp.heights),
            tuple(int(w) for w in sp.widths))
    scales = tuple((ev.sigma, ev.octave) for ev in levels)
    tables = akaze._level_tables(CPU, *geom, scales)
    assert _same(tables.row_base, torch.as_tensor(sp.row_base).to(torch.int64))
    assert _same(tables.sigma, torch.tensor([ev.sigma / (2.0 ** ev.octave) for ev in levels],
                                            dtype=torch.float32))
    assert _same(tables.widths, torch.as_tensor(sp.widths))
    assert _same(tables.heights, torch.as_tensor(sp.heights))
    assert _same(tables.up, torch.tensor([2.0 ** ev.octave for ev in levels],
                                         dtype=torch.float32))
    assert akaze._level_tables(CPU, *geom, scales) is tables


@pytest.mark.parametrize("cell_samples", [1, 4, 7])
def test_mldb_tables_equal_the_inline_tensors(cell_samples):
    coords, cell_of, pairs, num_cells = mldb._grid_cells(cell_samples)
    onehot = (torch.from_numpy(cell_of)[:, None]
              == torch.arange(num_cells)[None, :]).to(torch.float32)
    grid = mldb._grid_on(CPU, cell_samples)
    assert _same(grid.coords, torch.from_numpy(coords))
    assert _same(grid.pool, onehot / onehot.sum(dim=0, keepdim=True))
    assert _same(grid.pair_a, torch.from_numpy(pairs[:, 0]))
    assert _same(grid.pair_b, torch.from_numpy(pairs[:, 1]))
    assert mldb._grid_on(CPU, cell_samples) is grid
    disc = mldb._disc_on(CPU)
    assert _same(disc, torch.from_numpy(mldb._DISC)) and mldb._disc_on(CPU) is disc


@pytest.mark.parametrize("table", [
    akaze._akaze_mask_on, akaze._level_tables, mldb._disc_on, mldb._grid_on,
    frontend._detection_mask_on, descriptor._tables_on, orientation._moment_tables_on,
    pyramid._resize_tensor, ba._jacobi_tables], ids=lambda fn: fn.__name__)
def test_captured_tables_are_never_evicted(table):
    assert table.cache_info().maxsize is None


def test_level_tables_outlive_other_geometries():
    first = akaze._level_tables(CPU, (0,), (17,), (23,), ((1.6, 0),))
    for w in range(24, 40):
        akaze._level_tables(CPU, (0,), (17,), (w,), ((1.6, 0),))
    assert akaze._level_tables(CPU, (0,), (17,), (23,), ((1.6, 0),)) is first
