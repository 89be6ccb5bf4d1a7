"""Parity of the port's P3P with coloc_tpu on the CPU.

The port's plain twin of csrc/p3p.cu is held against coloc_tpu's Pallas
kernel (interpret mode) on minimal samples of a random scene with a known
pose. The Grunert/Ferrari solver is ill-conditioned in float32: on this
data the reference's own poses differ from a float64 evaluation of the same
arithmetic by more than 1e-4 on ~40% of valid poses. XLA's CPU backend
contracts multiply-adds into FMAs (the reference's quartic coefficient q2,
for one, matches an FMA emulation bit for bit and a plain evaluation on
only ~30% of samples), torch does not, and the solver amplifies those last
bits. So pose-for-pose agreement at 1e-4 holds on about half the poses,
and the port is held to the reference statistically here: same validity,
same rate of recovering the true pose, same accuracy against float64.
Bit-equality of the CUDA kernel with its plain twin, whose arithmetic is
identical, is checked on the card (tests/test_torch_kernels.py,
chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coloc_tpu.geometry import p3p as jp3p
from coloc_tpu.geometry import so3 as jso3

from coloc_tpu_torch.geometry import p3p as tp3p
from port_harness import one_torch_thread, time_limit  # noqa: F401

B = 256


def _scene(seed):
    rng = np.random.default_rng(seed)
    R = np.asarray(jso3.exp(jnp.asarray(rng.normal(0, 0.3, 3).astype(np.float32))))
    C = rng.normal(0, 1.0, 3).astype(np.float32)
    Xc = np.stack([rng.uniform(-3, 3, (B, 3)), rng.uniform(-2, 2, (B, 3)),
                   rng.uniform(4, 12, (B, 3))], -1).astype(np.float32)
    Xw = (Xc @ R + C).astype(np.float32)            # X_c = R (X_w - C)
    bear = (Xc / np.linalg.norm(Xc, axis=-1, keepdims=True)).astype(np.float32)
    truth = np.concatenate([R.reshape(9), C]).astype(np.float32)
    return Xw, bear, truth


def _rel(a, b):
    return (np.abs(a - b) / (1.0 + np.abs(b))).max(axis=-1)


def _finds_truth(flats, valid, truth):
    return ((_rel(flats, truth[None, None]) < 1e-3) & valid).any(axis=1).mean()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_p3p_flats_match_reference_statistics(seed):
    Xw, bear, truth = _scene(seed)
    fj, vj = (np.asarray(a) for a in jp3p.p3p_flats_batch(jnp.asarray(Xw),
                                                          jnp.asarray(bear)))
    ft, vt = (a.numpy() for a in tp3p.p3p_flats_batch(torch.from_numpy(Xw),
                                                       torch.from_numpy(bear)))
    f64, v64 = (a.numpy() for a in tp3p._p3p_core(
        torch.from_numpy(Xw).double(), torch.from_numpy(bear).double(),
        tp3p._acos_poly))
    assert ft.shape == (B, 4, 12) and vt.shape == (B, 4)
    # validity: equal on nearly every sample
    assert (vj == vt).all(axis=1).mean() >= 0.97
    # half the poses or more agree with the reference at 1e-4 outright
    both = vj & vt
    assert (_rel(ft, fj)[both] <= 1e-4).mean() >= 0.45
    # the true pose is recovered as often as the reference recovers it
    t_port, t_ref = _finds_truth(ft, vt, truth), _finds_truth(fj, vj, truth)
    assert t_port >= 0.75 and abs(t_port - t_ref) <= 0.04
    # and the port's float32 is as close to float64 as the reference's
    acc_port = (_rel(ft, f64)[vt & v64] <= 1e-4).mean()
    acc_ref = (_rel(fj, f64)[vj & v64] <= 1e-4).mean()
    assert acc_port >= acc_ref - 0.05


def test_p3p_grunert_true_acos_matches_reference_statistics():
    Xw, bear, truth = _scene(3)
    (Rj, Cj), vj = jp3p.p3p_grunert_batch(jnp.asarray(Xw), jnp.asarray(bear))
    fj = np.concatenate([np.asarray(Rj).reshape(B, 4, 9), np.asarray(Cj)], -1)
    vj = np.asarray(vj)
    pose, vt = tp3p.p3p_grunert(torch.from_numpy(Xw), torch.from_numpy(bear))
    ft = np.concatenate([pose.R.numpy().reshape(B, 4, 9), pose.C.numpy()], -1)
    vt = vt.numpy()
    assert (vj == vt).all(axis=1).mean() >= 0.97
    t_port, t_ref = _finds_truth(ft, vt, truth), _finds_truth(fj, vj, truth)
    assert t_port >= 0.75 and abs(t_port - t_ref) <= 0.04


def test_p3p_recovers_a_hand_checked_pose():
    """A triangle seen head on from the origin: the true pose (identity) is
    among the valid roots, to the solver's float32 accuracy."""
    Xw = np.array([[[-1.0, -1.0, 6.0], [1.5, -0.5, 7.0], [0.0, 1.2, 5.0]]],
                  np.float32)
    bear = Xw / np.linalg.norm(Xw, axis=-1, keepdims=True)
    flats, valid = tp3p.p3p_flats_batch(torch.from_numpy(Xw), torch.from_numpy(bear))
    truth = np.concatenate([np.eye(3).reshape(9), np.zeros(3)]).astype(np.float32)
    err = _rel(flats.numpy()[0], truth)[valid.numpy()[0]]
    assert err.min() < 1e-3
