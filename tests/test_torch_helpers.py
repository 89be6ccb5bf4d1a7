"""Public helpers of coloc_tpu that the port now carries, against
coloc_tpu on the CPU: so3.{to_quaternion, log, project_to_so3},
fivept.five_point (the one-sample solver), config.{default_intrinsics,
default_distortion} and ops/hamming.hamming_distance (the popcount
oracle)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coloc_tpu import config as jcfg
from coloc_tpu.geometry import fivept as jfivept
from coloc_tpu.geometry import so3 as jso3
from coloc_tpu.ops import hamming as jhamming

from coloc_tpu_torch import config as tcfg
from coloc_tpu_torch.geometry import fivept, so3
from coloc_tpu_torch.ops import hamming
from port_harness import one_torch_thread, time_limit  # noqa: F401


def _rotations():
    """Random rotations plus the edges: identity, theta = pi about each axis
    and a diagonal, theta just under pi, a tiny angle."""
    rng = np.random.default_rng(0)
    w = [rng.normal(size=3) * s for s in (0.1, 0.8, 2.0) for _ in range(8)]
    w += [np.zeros(3), [np.pi, 0, 0], [0, np.pi, 0], [0, 0, np.pi],
          np.pi * np.ones(3) / np.sqrt(3), [0, 0, np.pi - 1e-4], [1e-6, 0, 0]]
    w = torch.tensor(np.array(w), dtype=torch.float32)
    return so3.exp(w)


def test_to_quaternion_and_log_match_reference():
    """Batched over a leading axis, each within 1e-6 (quaternion) and 2e-6
    rad (log) of coloc_tpu's per-matrix result (float32; measured at most
    a few ulps)."""
    R = _rotations()
    q, w = so3.to_quaternion(R), so3.log(R)
    jq = np.stack([np.asarray(jso3.to_quaternion(jnp.asarray(r))) for r in R.numpy()])
    jw = np.stack([np.asarray(jso3.log(jnp.asarray(r))) for r in R.numpy()])
    np.testing.assert_allclose(q.numpy(), jq, rtol=0, atol=1e-6)
    np.testing.assert_allclose(w.numpy(), jw, rtol=0, atol=2e-6)
    assert (q[:, 0] >= 0).all()
    np.testing.assert_allclose(torch.linalg.norm(q, dim=-1).numpy(), 1.0, atol=1e-6)
    # exp(log(R)) = R away from pi
    np.testing.assert_allclose(so3.exp(w[:24]).numpy(), R[:24].numpy(), atol=2e-6)
    assert torch.equal(so3.to_quaternion(R[3]), q[3]) and torch.equal(so3.log(R[3]), w[3])


def test_project_to_so3_matches_reference():
    """Noisy and reflected matrices projected onto SO(3): within 1e-5 of
    coloc_tpu's, orthonormal, det +1."""
    rng = np.random.default_rng(1)
    M = _rotations().numpy() + rng.normal(size=(31, 3, 3)).astype(np.float32) * 0.05
    M[0] = np.diag([1.0, 1.0, -1.0]).astype(np.float32) @ M[0]
    P = so3.project_to_so3(torch.from_numpy(M)).numpy()
    jP = np.stack([np.asarray(jso3.project_to_so3(jnp.asarray(m))) for m in M])
    np.testing.assert_allclose(P, jP, rtol=0, atol=1e-5)
    np.testing.assert_allclose(P @ P.transpose(0, 2, 1), np.broadcast_to(np.eye(3), P.shape),
                               atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(P), 1.0, atol=1e-5)


def _normalize(E):
    E = E / np.linalg.norm(E)
    return E * np.sign(E.flat[np.argmax(np.abs(E))])


def test_five_point_one_sample():
    """five_point is five_point_batch at B = 1 (equal, exactly). On planted
    motions its candidates hold the true E (up to scale and sign) within
    1e-3 on every sample where coloc_tpu's jitted five_point's do, and on
    at least 5 of 6 (the two solvers give different candidate sets for one
    sample, so they are held by solution capture; measured: the port
    captures 5 of 6 within 2.5e-5, coloc_tpu 4 (eagerly 5); sample 3 is
    captured by neither, 0.61 away in both)."""
    rng = np.random.default_rng(2)
    j_five_point = jax.jit(jfivept.five_point)
    captured = []
    for _ in range(6):
        P = np.c_[rng.uniform(-3, 3, (5, 2)), rng.uniform(5, 15, (5, 1))]
        w = rng.normal(size=3) * 0.1
        R = so3.exp(torch.tensor(w, dtype=torch.float32)).double().numpy()
        t = rng.normal(size=3)
        t /= np.linalg.norm(t)
        Pc = (R @ P.T).T + t
        x1 = (P[:, :2] / P[:, 2:]).astype(np.float32)
        x2 = (Pc[:, :2] / Pc[:, 2:]).astype(np.float32)
        tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
        E_true = _normalize(tx @ R)
        Es, valid = fivept.five_point(torch.from_numpy(x1), torch.from_numpy(x2))
        Eb, vb = fivept.five_point_batch(torch.from_numpy(x1)[None], torch.from_numpy(x2)[None])
        assert torch.equal(Es, Eb[0]) and torch.equal(valid, vb[0])
        assert Es.shape == (30, 3, 3) and valid.shape == (30,)
        jE, jv = j_five_point(jnp.asarray(x1), jnp.asarray(x2))
        got = []
        for cands, ok in ((Es.numpy(), valid.numpy()), (np.asarray(jE), np.asarray(jv))):
            errs = [np.abs(_normalize(E.astype(np.float64)) - E_true).max()
                    for E, v in zip(cands, ok) if v]
            got.append(bool(errs) and min(errs) < 1e-3)
        captured.append(tuple(got))
    assert all(a or not b for a, b in captured) and sum(a for a, _ in captured) >= 5, captured


@pytest.mark.parametrize("D", [1, 2, 5])
def test_default_camera_equal_reference(D):
    jc, tc = jcfg.ColocConfig(num_drones=D), tcfg.ColocConfig(num_drones=D)
    for fn in ("default_intrinsics", "default_distortion"):
        a, b = getattr(tcfg, fn)(tc), getattr(jcfg, fn)(jc)
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_hamming_distance_equal_reference():
    """Popcount distances of int32 descriptor words (the uint32 bits, C5)
    equal coloc_tpu's on uint32 words, exactly, with all-ones and high-bit
    words and broadcasting."""
    rng = np.random.default_rng(3)
    a = rng.integers(0, 2 ** 32, (40, 16), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2 ** 32, (40, 16), dtype=np.uint64).astype(np.uint32)
    a[0], b[0] = 0xFFFFFFFF, 0
    a[1] = b[1]
    ref = np.asarray(jhamming.hamming_distance(jnp.asarray(a), jnp.asarray(b)))
    ta, tb = (torch.from_numpy(x.view(np.int32)) for x in (a, b))
    d = hamming.hamming_distance(ta, tb)
    assert d.dtype == torch.int32
    np.testing.assert_array_equal(d.numpy(), ref)
    assert int(d[0]) == 512 and int(d[1]) == 0
    ref_b = np.asarray(jhamming.hamming_distance(jnp.asarray(a[:, None]), jnp.asarray(b[None])))
    np.testing.assert_array_equal(hamming.hamming_distance(ta[:, None], tb[None]).numpy(), ref_b)
