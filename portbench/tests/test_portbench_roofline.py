"""The kernels' bounds against PERF.md's kernel table."""

from __future__ import annotations

import pytest

from portbench import roofline


def test_b1_by_ops():
    assert roofline.k2nn(1024, 4096) * 1e3 == pytest.approx(0.00217, abs=5e-6)


def test_b4_b5_by_bytes():
    px = 4464 * 768
    assert roofline.fast_nms(px) * 1e3 == pytest.approx(0.01228, abs=5e-6)
    assert roofline.extract(px, 2053) * 1e3 == pytest.approx(0.04426, abs=5e-6)


def test_stacked_raster():
    """A 752x480 frame's 8 levels stack into 4464 rows of 768 columns (the
    raster of PERF.md's B4 row holds two such frames)."""
    assert roofline.stacked_raster(480, 752, 8, 1.2) == (2232, 768)


def test_step_bounds():
    b = roofline.trip_step(2, 480, 752, 8, 1.2, 1024, 4096, 256)
    assert b["k2nn"] == pytest.approx(roofline.k2nn(2048, 4096))
    assert b["fast_nms"] * 1e3 == pytest.approx(0.01228, abs=5e-6)
    assert set(b) == {"k2nn", "p3p", "ransac_rank", "fast_nms", "extract"}


def test_akaze_kernels():
    """B10 over a 480x752 frame's 4 octaves of 4 sublevels; B11's two calls
    at K = 5000 (the samples and their coordinates, not the bf16 source
    they read); B3 at M = 5000."""
    fed = sum(roofline.fed_octave(1, h, w, 4) for h, w in ((480, 752), (240, 376), (120, 188),
                                                           (60, 94)))
    assert fed * 1e3 == pytest.approx(0.00973, rel=0.01)
    calls = roofline.sample_raster(5000, 2, 49) + roofline.sample_raster(5000, 3, 464)
    assert calls * 1e3 == pytest.approx(0.01504, rel=0.01)
    assert roofline.ransac_rank(1, 1024, 5000) * 1e3 == pytest.approx(0.00336, rel=0.01)
    step = roofline.akaze_step(1, 480, 752, 4, 4, 5000, 8192, 256, 4)
    assert step["fed_octave"] == pytest.approx(fed)
    assert step["sample_raster"] == pytest.approx(calls)
    assert step["k2nn"] == pytest.approx(roofline.k2nn(5000, 8192))


def test_trace_names():
    assert roofline.kernel_of("void k2nn_mma_kernel<4>(int const*, ...)") == "k2nn"
    assert roofline.kernel_of("rank_kernel(float const*)") == "ransac_rank"
    assert roofline.kernel_of("epi_rank_kernel(float const*)") is None
    assert roofline.kernel_of("void at::native::elementwise_kernel<128, 2>") is None
