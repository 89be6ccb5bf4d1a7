"""The plain reference's pieces against what they compute, by other means:
P3P against the pose it was made from, the Hamming 2-NN against Python's
bit counts, Floyd's draws, the filter's first step in closed form and the
covariance against a direct inverse."""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import geometry, kalman, match, trip


def test_p3p_recovers_the_pose():
    g = torch.Generator().manual_seed(3)
    dt = torch.float64
    n = 64
    R = geometry.exp_so3(0.3 * torch.randn(n, 3, generator=g, dtype=dt))
    C = torch.randn(n, 3, generator=g, dtype=dt)
    Xc = torch.cat([torch.randn(n, 3, 2, generator=g, dtype=dt),
                    4 + 4 * torch.rand(n, 3, 1, generator=g, dtype=dt)], -1)
    Xw = Xc @ R + C[:, None]
    Rs, Cs, ok = geometry.p3p(Xw, Xc / torch.linalg.norm(Xc, dim=-1, keepdim=True))
    err = torch.stack([geometry.angle_between(Rs[:, i], R) + (Cs[:, i] - C).norm(dim=-1)
                       for i in range(4)], 1)
    assert float(torch.where(ok, err, torch.full_like(err, 1e9)).min(1).values.max()) < 1e-6


def test_two_nearest_counts_bits():
    g = torch.Generator().manual_seed(4)
    q = torch.randint(-2 ** 31, 2 ** 31, (37, 16), generator=g, dtype=torch.int64).to(torch.int32)
    bank = torch.randint(-2 ** 31, 2 ** 31, (53, 16), generator=g,
                         dtype=torch.int64).to(torch.int32)
    bank[7] = q[3]
    valid = torch.ones(53, dtype=torch.bool)
    valid[11] = False
    idx, best, second = match.two_nearest(q, bank, valid)
    for i in range(37):
        d = [sum(bin((int(a) ^ int(b)) & 0xFFFFFFFF).count("1") for a, b in zip(q[i], bank[j]))
             if valid[j] else 10 ** 9 for j in range(53)]
        order = sorted(range(53), key=lambda j: (d[j], j))
        assert (int(idx[i]), int(best[i]), int(second[i])) == (order[0], d[order[0]],
                                                               d[order[1]])
    assert int(idx[3]) == 7 and int(best[3]) == 0


def test_words_and_bits():
    g = torch.Generator().manual_seed(5)
    bits = torch.rand(9, 512, generator=g) < 0.5
    assert torch.equal(trip.words_to_bits(trip.bits_to_words(bits)), bits)


def test_floyd_draws_distinct_valid_entries():
    valid = torch.tensor([[True, False, True, True, False, True, True]] * 2)
    valid[1, 2:] = False
    valid[1, 6] = True
    valid[1, 3] = True
    u = torch.rand((2, 500, 3), generator=torch.Generator().manual_seed(6))
    idx = geometry.floyd(u, valid)
    for f in range(2):
        allowed = set(torch.nonzero(valid[f])[:, 0].tolist())
        for row in idx[f].tolist():
            assert len(set(row)) == 3 and set(row) <= allowed


def test_filter_first_step():
    opts = {"process_noise": 0.01, "measurement_noise": 0.1, "initial_covariance": 1.0,
            "chi2_gate": 10.0}
    z = torch.tensor([[[1.0, 2.0, 3.0, 0.1, 0.2, 0.3 + 2 * math.pi]]], dtype=torch.float64)
    cov3 = torch.eye(3, dtype=torch.float64)[None, None] * 0.5
    rmse = torch.tensor([[2.0]], dtype=torch.float64)
    R, C = kalman.run(z, cov3, rmse, torch.tensor([[True]]), opts)
    # P_pred = 1.01; the gain is P_pred / (P_pred + m) per axis
    k_pos, k_ang = 1.01 / 1.11, 1.01 / 2.01
    assert torch.allclose(C[0, 0], z[0, 0, :3] * k_pos)
    e = torch.tensor([0.1, 0.2, 0.3], dtype=torch.float64) * k_ang
    assert torch.allclose(R[0, 0], geometry.rot_of(e))


def test_euler_round_trip():
    e = torch.tensor([[0.3, -0.4, 2.0], [-1.0, 0.2, -2.5]], dtype=torch.float64)
    assert torch.allclose(geometry.euler_of(geometry.rot_of(e)), e)


def test_covariance_floor():
    A = torch.randn(6, 6, dtype=torch.float64, generator=torch.Generator().manual_seed(7))
    H = A @ A.T + torch.eye(6, dtype=torch.float64)
    assert torch.allclose(geometry.covariance(H[None])[0], torch.linalg.inv(H))


def test_refine_reaches_the_optimum():
    """From a perturbed pose, the Huber optimum of exact observations is
    the true pose."""
    g = torch.Generator().manual_seed(8)
    dt = torch.float64
    R = geometry.exp_so3(0.1 * torch.randn(1, 3, generator=g, dtype=dt))
    C = torch.randn(1, 3, generator=g, dtype=dt)
    Xc = torch.cat([torch.randn(1, 50, 2, generator=g, dtype=dt),
                    5 + torch.rand(1, 50, 1, generator=g, dtype=dt)], -1)
    Xw = Xc @ R + C[:, None]
    K = torch.tensor([[[450.0, 0, 376], [0, 450.0, 240], [0, 0, 1]]], dtype=dt)
    dist = torch.zeros(1, 3, dtype=dt)
    uv = geometry.project(K, dist, Xc)
    R0 = geometry.exp_so3(torch.tensor([[0.01, -0.02, 0.01]], dtype=dt)) @ R
    Ro, Co = geometry.refine(R0, C + 0.05, K, dist, Xw, uv, torch.ones(1, 50, dtype=torch.bool))
    assert float(geometry.angle_between(Ro, R)) < 1e-9
    assert float((Co - C).norm()) < 1e-9


def test_pool_and_triplets_fixed():
    pool, tri = trip.pool_and_triplets()
    assert pool.shape == (192, 2) and tri.shape == (512, 3)
    assert np.all(np.linalg.norm(pool, axis=1) <= 24.0)
    assert len({(a, min(b, c), max(b, c)) for a, b, c in tri.tolist()}) == 512
