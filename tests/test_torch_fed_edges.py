"""Parity of the port's B10 and B11 plain twins with coloc_tpu's Pallas
kernels (interpreted, as conftest sets) at the edge shapes where a tiled
kernel's border handling differs from a tile's: images a row or a column
wide, widths off any tile grid, a single keypoint or sample.

The twins define what the CUDA kernels compute (tests/test_torch_kernels.py
holds the kernels to them bit for bit on the card)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coloc_tpu.ops import diffusion as jdiff
from coloc_tpu.ops import patches as jpatch

from coloc_tpu_torch.ops import diffusion as tdiff
from coloc_tpu_torch.ops import patches as tpatch
from port_harness import one_torch_thread, time_limit  # noqa: F401


@pytest.mark.parametrize("octave", [0, 3])
@pytest.mark.parametrize("h,w", [(1, 37), (2, 5), (37, 1), (9, 130)])
def test_fed_octave_plain_matches_interpreted_kernel_at_edges(h, w, octave):
    """B = 2 with distinct k^2, the preset's octave-0 and octave-3
    schedules: atol 1e-6 on all four planes, the tolerance coloc_tpu holds
    its own two forms to (XLA:CPU may contract a multiply-add into an FMA
    where the port rounds both)."""
    rng = np.random.default_rng(h * w + octave)
    L = rng.uniform(0, 1, (2, h, w)).astype(np.float32)
    k2 = np.array([0.01, 0.04], np.float32)
    _, cycles, s4 = tdiff.octave_schedule(4, 4, 1.6, 0.25)[octave]
    want = jdiff.fed_octave_pallas(jnp.asarray(L), jnp.asarray(k2), h, w, cycles, s4,
                                   interpret=True)
    got = tdiff.fed_octave(torch.from_numpy(L), torch.from_numpy(k2), cycles, s4)
    for g, wnt, name in zip(got, want, ("L", "Lx", "Ly", "response")):
        assert g.shape == (2, 4, h, w)
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), atol=1e-6, err_msg=name)


@pytest.mark.parametrize("K,NS,C", [(1, 464, 3), (5, 1, 2), (1, 1, 3)])
def test_sample_raster_plain_matches_interpreted_kernel_at_edges(K, NS, C):
    """A single keypoint, a single sample, both: exactly equal, with .5
    ties and coordinates outside the window."""
    rng = np.random.default_rng(K * NS * C)
    stride, WP, ph, pw = 80, 256, 64, 128
    src = rng.uniform(-3, 3, (C * stride, WP)).astype(np.float32)
    row0 = rng.integers(0, C * stride - (C - 1) * stride - ph + 1, K).astype(np.int32)
    col0 = rng.integers(0, WP - pw + 1, K).astype(np.int32)
    lx = rng.uniform(-6, pw + 5, (K, NS)).astype(np.float32)
    ly = rng.uniform(-6, ph + 5, (K, NS)).astype(np.float32)
    lx[:, 0], ly[:, 0] = 2.5, ph - 0.5
    want = jpatch._sample_raster_pallas(
        jnp.asarray(src).astype(jnp.bfloat16), jnp.asarray(row0), jnp.asarray(col0),
        jnp.asarray(lx), jnp.asarray(ly), C, stride, ph, pw, interpret=True)
    got = tpatch.sample_raster_flat(torch.from_numpy(src).to(torch.bfloat16), stride,
                                    torch.from_numpy(row0), torch.from_numpy(col0),
                                    torch.from_numpy(lx), torch.from_numpy(ly),
                                    C=C, ph=ph, pw=pw)
    assert got.shape == (C, K, NS) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
