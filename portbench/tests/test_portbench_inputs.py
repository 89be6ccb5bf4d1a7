"""The scene generator against the port's numpy one."""

from __future__ import annotations

import numpy as np
import torch

from coloc_tpu_torch.io import synthetic
from portbench.inputs import scene


def test_textures_and_paths_equal():
    H, W = 96, 128
    K = np.array([[0.6 * W, 0, W / 2], [0, 0.6 * W, H / 2], [0, 0, 1]], np.float32)
    a, b = scene.make_scene(H, W, K, 5), synthetic.make_scene(H, W, K, seed=5)
    assert all(np.array_equal(x, y) for x, y in zip(a.textures, b.textures))
    assert np.array_equal(a.alphas[0], b.alphas[0])
    for d in range(3):
        R, C = scene.trajectory(9, d)
        Rp, Cp = synthetic.trajectory(9, d)
        np.testing.assert_allclose(R, Rp, atol=2e-7)
        np.testing.assert_array_equal(C, Cp)


def test_render_equals_numpy_render():
    """The device render (float64, then float32) against the numpy render
    at the same poses: within float32 rounding of 0-255 values."""
    H, W = 96, 128
    K = np.array([[0.6 * W, 0, W / 2], [0, 0.6 * W, H / 2], [0, 0, 1]], np.float32)
    a, b = scene.make_scene(H, W, K, 9), synthetic.make_scene(H, W, K, seed=9)
    R, C = scene.trajectory(6, 1)
    got = scene.render(a, R, C, torch.device("cpu"), block=4).numpy()
    want = np.stack([synthetic.render(b, R[f], C[f]) for f in range(6)])
    np.testing.assert_allclose(got, want, rtol=0, atol=255 * 2 ** -22)
