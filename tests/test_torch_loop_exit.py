"""The port's LM and Gauss-Newton loops in done-mask form, and the 6x6
inverse that never reads the host, on the CPU.

A masked iteration changes nothing, so the host's period `check_every`
between two reads of the loop's exit cannot change a bit of the result:
refine_pose_only over a drone axis (three lanes that stop at different
iterations, one of them at the damping cap), the full BA `refine` and
the essential-manifold Gauss-Newton are held bit-equal (torch.equal)
across check_every in {1, 3, max_iterations}. The pose covariance's
cyclic-Jacobi inverse is held against the eigh form it replaces.
"""

import numpy as np
import pytest
import torch

from coloc_tpu_torch.config import RefinerOptions
from coloc_tpu_torch.geometry import essential, so3
from coloc_tpu_torch.sfm import ba
import pose_cases
from port_harness import one_torch_thread, time_limit  # noqa: F401

OPTS = RefinerOptions()


@pytest.fixture(scope="module")
def lanes():
    """Three drones' problems of 21 points (tests/pose_cases.py): -> (R0,
    C0, X, uv, inliers, Ks, dists), each with a leading axis of 3."""
    return pose_cases.lanes()


def test_pose_lm_lanes_stop_apart(lanes):
    """The lanes stop at different iterations, the third at the damping
    cap, and the loop ends with every lane stopped."""
    R0, C0, X, uv, inl, Ks, dists = lanes
    st = ba.pose_lm_run(ba.pose_lm_init(R0, C0), X, uv, inl, Ks, dists, OPTS, 1)
    its = st.iterations.tolist()
    assert len(set(its)) == 3 and max(its) < OPTS.max_iterations, its
    assert float(st.lam[2]) == 1e8 and float(st.lam[:2].max()) < 1e8
    assert not bool(st.active.any())


@pytest.mark.parametrize("check_every", [3, RefinerOptions().max_iterations])
def test_refine_pose_only_check_every_bit_equal(lanes, check_every):
    """refine_pose_only of the three lanes: every output equal whichever
    period the host reads the exit at, and each lane's iterations too."""
    base = ba.refine_pose_only(*lanes, OPTS, check_every=1)
    got = ba.refine_pose_only(*lanes, OPTS, check_every=check_every)
    for a, b in zip(base, got):
        assert torch.equal(a, b)
    assert base.iterations.dtype == torch.int32 and base.iterations.shape == (3,)
    assert bool(torch.isfinite(base.cov).all())


def _ba_problem():
    """Two views of 40 points, view 1's pose and the points perturbed."""
    rng = np.random.default_rng(5)
    L = 40
    X = np.c_[rng.uniform(-2, 2, (L, 2)), rng.uniform(4, 9, (L, 1))].astype(np.float32)
    Rs = np.stack([np.eye(3), so3.exp(torch.tensor([0.02, -0.1, 0.01])).numpy()]
                  ).astype(np.float32)
    Cs = np.array([[0, 0, 0], [0.5, 0.05, -0.02]], np.float32)
    obs = []
    for R, C in zip(Rs, Cs):
        Xc = (X - C) @ R.T
        obs.append(Xc[:, :2] / Xc[:, 2:] * 300 + [160, 120] + rng.normal(0, 0.5, (L, 2)))
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    mask = np.ones((2, L), bool)
    mask[1, :4] = False
    return ba.BAProblem(
        Rs=t(Rs), Cs=t(Cs + [[0, 0, 0], [0.03, -0.02, 0.01]]),
        X=t(X + rng.normal(0, 0.05, X.shape)), obs=t(np.stack(obs)),
        obs_mask=torch.from_numpy(mask), Ks=t(np.stack([pose_cases.K] * 2)), dists=t(np.zeros((2, 3))))


@pytest.mark.parametrize("check_every", [3, RefinerOptions().max_iterations])
@pytest.mark.parametrize("optimize_structure", [True, False])
def test_refine_check_every_bit_equal(check_every, optimize_structure):
    """The full BA (Schur complement) and its poses-only form: equal bits
    whichever period the host reads the exit at."""
    problem = _ba_problem()
    fix = torch.tensor([True, False])
    base = ba.refine(problem, OPTS, fix, optimize_structure, check_every=1)
    got = ba.refine(problem, OPTS, fix, optimize_structure, check_every=check_every)
    for a, b in zip(base, got):
        assert torch.equal(a, b)
    assert 1 <= int(base.iterations) < OPTS.max_iterations


@pytest.mark.parametrize("check_every", [3, 8])
def test_refine_relative_pose_check_every_bit_equal(check_every):
    """Gauss-Newton on the essential manifold from a perturbed pose:
    equal bits whichever period the host reads its exit at."""
    rng = np.random.default_rng(7)
    X = np.c_[rng.uniform(-2, 2, (60, 2)), rng.uniform(4, 9, (60, 1))].astype(np.float32)
    R = so3.exp(torch.tensor([0.01, 0.08, -0.02]))
    t = torch.tensor([-0.9, 0.1, 0.05])
    t = t / torch.linalg.norm(t)
    Xt = torch.from_numpy(X)
    x1 = Xt[:, :2] / Xt[:, 2:]
    X2 = Xt @ R.T + t
    x2 = X2[:, :2] / X2[:, 2:] + torch.from_numpy(rng.normal(0, 1e-3, (60, 2)).astype(np.float32))
    R0 = so3.exp(torch.tensor([0.02, -0.01, 0.015])) @ R
    t0 = t + torch.tensor([0.05, -0.04, 0.02])
    t0 = t0 / torch.linalg.norm(t0)
    w = torch.ones(60)
    base = essential.refine_relative_pose(R0, t0, x1, x2, w, check_every=1)
    got = essential.refine_relative_pose(R0, t0, x1, x2, w, check_every=check_every)
    assert all(torch.equal(a, b) for a, b in zip(base, got))
    assert not torch.equal(base[0], R0)       # it moved


def _spd(evals, seed):
    Q, _ = np.linalg.qr(np.random.default_rng(seed).normal(size=(6, 6)))
    return ((Q * np.asarray(evals)) @ Q.T).astype(np.float32)


@pytest.mark.parametrize("evals,floored,tol", [
    ([3e7, 1e7, 5e6, 2e6, 1e6, 4e5], 0, 1e-5),     # well conditioned
    ([2e6, 1e6, 3e5, 1e5, 0.0, 0.0], 2, 1e-5),     # rank 4
    ([1e8, 3e7, 1e6, 1e4, 10.0, 1.0], 2, 1e-3),    # cond 1e8
])
def test_spd_inv_jacobi_matches_eigh(evals, floored, tol):
    """_spd_inv_jacobi against the eigh form _spd_inv on float32 6x6
    blocks, relative Frobenius error within `tol` (measured 3.8e-6,
    6.3e-7 and 2.3e-4: at cond 1e8 both resolve the floored directions
    only to eps ||M|| / gap). `floored` eigenvalues lie under the relative
    floor, so the floor acts there. The Jacobi sweeps have converged:
    V^T M V is diagonal to 1e-5 of max |M|."""
    M = torch.from_numpy(_spd(evals, len(evals) + int(evals[-1])))[None]
    ev = torch.linalg.eigvalsh(M.double())[0]
    assert int((ev < 1e-6 * ev.abs().max() + 1e-12).sum()) == floored
    want = ba._spd_inv(M)[0].double()
    got = ba._spd_inv_jacobi(M)[0].double()
    assert float(torch.linalg.norm(got - want) / torch.linalg.norm(want)) < tol
    w, V = ba._jacobi_eigh(M)
    off = V.transpose(-1, -2) @ M @ V - torch.diag_embed(w)
    assert float(off.abs().max()) <= 1e-5 * float(M.abs().max())


def test_pose_kernel_constants_are_the_twins():
    """csrc/pose_lm.cu (the card's pose LM and covariance) repeats the plain
    twin's constants: the Jacobi rounds and sweeps, the damping clamp, the
    step tolerance; and its C entry points take the arguments that
    ops/_build binds."""
    import re
    from pathlib import Path

    from coloc_tpu_torch.ops import _build

    src = (Path(ba.__file__).resolve().parent.parent / "csrc" / "pose_lm.cu").read_text()

    def table(name):
        body = re.search(name + r"\[5\]\[3\] = \{(.*?)\};", src, re.S).group(1)
        return [list(map(int, re.findall(r"\d+", row))) for row in re.findall(r"\{([^{}]*)\}", body)]

    assert table("kRoundP") == [[p for p, _ in r] for r in ba._JACOBI_ROUNDS]
    assert table("kRoundQ") == [[q for _, q in r] for r in ba._JACOBI_ROUNDS]

    def const(name):
        return float(re.search(r"constexpr \w+ " + name + r" = ([0-9.e+-]+)f?;", src).group(1))

    assert const("kJacobiSweeps") == ba._JACOBI_SWEEPS
    assert (const("kDiagMin"), const("kDiagMax"), const("kStepTol")) == (
        ba._DIAG_MIN, ba._DIAG_MAX, ba._STEP_TOL)
    for name in ("coloc_pose_lm", "coloc_pose_cov"):
        params = re.search(r'extern "C" int ' + name + r"\((.*?)\)", src, re.S).group(1)
        assert params.count(",") + 1 == len(_build._SIGNATURES[name])
