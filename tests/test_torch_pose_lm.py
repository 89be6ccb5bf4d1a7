"""The pose-only LM and covariance kernels (csrc/pose_lm.cu) against their
plain PyTorch twins, on the card.

Each test needs a CUDA device and skips without one (the kernels have no
CPU or interpret mode). This file imports neither jax nor coloc_tpu:

    python -m pytest --noconftest -m cuda tests/test_torch_pose_lm.py -q

"The twin" is ba's PyTorch form run on the same card tensors (dispatch's
kernel rule switched off for the call). The kernels sum U and g in a fixed
tree where the twin's cuBLAS products and reductions take another order,
so the two agree at float32 rounding, not bit for bit. Tolerances:
  - one iteration from one state: poses within 1e-5 (R's entries, C over
    sqrt(|C|^2 + 1), the LM's own scale of its step test) and the same
    bookkeeping, bit for bit: a first step is far above the rounding (but
    on the planted capped lane, whose condition puts both float32 forms
    ~1e-5 from a float64 twin: there as for whole runs, below);
  - a call of LM_GRAPH_STEPS iterations from a farther start: poses as for
    whole runs (below); iterations and active equal on the lanes whose
    decisions lie clear of the rounding floor (pose_cases.clear_lanes);
  - whole runs: iterations and active equal on the planted lanes
    (pose_cases.lanes), whose decisions are not borderline. Elsewhere a
    converged lane's accept decision sits at the rounding floor (new and
    old cost equal to float32 precision), so either form may stop an
    iteration early or late, and the two float32 forms differ by up to a
    few 1e-5 in C (a flat valley the tolerances accept). There each lane
    is held no farther from a float64 twin than twice the float32 twin's
    distance plus 1e-5, or at a float64 cost within
    pose_cases.COST_FLOOR (1e-6) of the float64 twin's: which point of the
    valley's floor a float32 form stops at turns on the rounding of its
    sums (at 512 threads a CTA one lane of 64x1024 stops 2.6e-5 from the
    float64 twin where the float32 twin, by chance, stops 1e-7 from it;
    both cost within 2.2e-7 of it);
  - cov within 1e-4 relative (Frobenius), rmse within 1e-5 relative, at
    one pose: the eigenvalues' rounding reaches the floored inverse
    through the condition of U.
"""

import contextlib
import dataclasses
import functools

import pytest
import torch

import pose_cases
from coloc_tpu_torch.config import RefinerOptions
from coloc_tpu_torch.ops import dispatch
from coloc_tpu_torch.session import LM_GRAPH_STEPS
from coloc_tpu_torch.sfm import ba
from port_harness import one_torch_thread, time_limit  # noqa: F401

pytestmark = pytest.mark.cuda
OPTS = RefinerOptions()


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@contextlib.contextmanager
def plain():
    """ba's plain twins on CUDA tensors for the calls inside."""
    use = dispatch.use_kernel
    dispatch.use_kernel = lambda t: False
    try:
        yield
    finally:
        dispatch.use_kernel = use


def _on(dev, case):
    return tuple(t.to(dev) for t in case)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _frob(a, b):
    return float(torch.linalg.norm((a - b).double()) / torch.linalg.norm(b.double()))


@functools.lru_cache(maxsize=None)
def _problems():
    """(D, L) and the problem: the session's and serving's shapes with Huber
    outliers and masked rows, one point, the planted lanes (D = 3, L = 21;
    one reaches the damping cap) and the edges: a lane with
    distortion, a lane all masked, a lane with points at z <= 1e-9 (some
    masked), a lane whose U is NaN (its Cholesky fails)."""
    out = {f"{D}x{L}": pose_cases.frame_lanes(D, L, seed=D * 7 + L)
           for D, L in ((1, 1), (2, 1024), (2, 5000), (64, 1024))}
    R0, C0, X, uv, inl, Ks, dists = pose_cases.frame_lanes(
        4, 300, seed=11, dist=(-0.05, 0.01, 0.001))
    inl[1] = False                                   # all masked
    X[2, :5] = torch.tensor([0.0, 0.0, -1.0])        # behind the camera
    X[2, 5:8, 2] = 0.0                               # on the camera's plane
    inl[2, :3] = False                               # some of them masked
    dists[2] = 0.0      # (with distortion r^6 overflows there, NaN in both)
    X[3, 0] = float("nan")                           # U is NaN
    out["edges"] = (R0, C0, X, uv, inl, Ks, dists)
    out["lanes"] = pose_cases.lanes()
    return out


PROBLEMS = ("1x1", "2x1024", "2x5000", "64x1024", "edges", "lanes")


def _case(name):
    return _problems()[name]


def _plain_run(R0, C0, X, uv, inl, Ks, dists):
    with plain():
        return ba.pose_lm_run(ba.pose_lm_init(R0, C0), X, uv, inl, Ks, dists, OPTS, 1)


def _f64(ts):
    return tuple(t.double() if t.is_floating_point() else t for t in ts)


def _pose_gap(a, b):
    """Per lane: max |dR| and max |dC| / sqrt(|C|^2 + 1) of poses a, b."""
    dR = (a.R.double() - b.R.double()).abs().flatten(1).amax(dim=1)
    scale = torch.sqrt((b.C.double() ** 2).sum(dim=1) + 1.0)
    dC = (a.C.double() - b.C.double()).abs().amax(dim=1) / scale
    return dR, dC


def test_pose_lm_kernel_planted_lanes(dev):
    """The three lanes of pose_cases.lanes: equal iterations and active
    (the third lane stops in the damping's escalation, at or next to its
    cap); the converging lanes' poses within 1e-5."""
    R0, C0, X, uv, inl, Ks, dists = _on(dev, pose_cases.lanes())
    got = ba.pose_lm_run(ba.pose_lm_init(R0, C0), X, uv, inl, Ks, dists, OPTS, 1)
    want = _plain_run(R0, C0, X, uv, inl, Ks, dists)
    assert torch.equal(got.iterations, want.iterations)
    assert torch.equal(got.active, want.active) and not bool(got.active.any())
    assert len(set(got.iterations.tolist())) == 3
    dR, dC = _pose_gap(got, want)
    assert float(dR[:2].max()) < 1e-5 and float(dC[:2].max()) < 1e-5


@pytest.mark.parametrize("name", PROBLEMS)
def test_pose_lm_kernel_step_equals_plain(dev, name):
    """One iteration from the initial state, kernel and twin: the same
    bookkeeping bit for bit (active, iterations, it, lam, nu; g0 within
    rounding) and poses within 1e-5; the all-masked lane and the NaN lane
    stay where they started (their step is 0). The planted capped lane
    (pixels unrelated to its points) solves a system whose condition puts
    each float32 form ~1e-5 from a float64 twin after one step (measured
    7e-6 and 9e-6): there the kernel is held no farther from the float64
    twin than twice the float32 twin's distance plus 1e-6."""
    R0, C0, X, uv, inl, Ks, dists = _on(dev, _case(name))
    st = ba.pose_lm_init(R0, C0)
    got = ba.pose_lm_steps(st, X, uv, inl, Ks, dists, OPTS, 1)
    with plain():
        want = ba.pose_lm_steps(st, X, uv, inl, Ks, dists, OPTS, 1)
    torch.cuda.synchronize()
    assert torch.equal(got.active, want.active) and torch.equal(got.iterations, want.iterations)
    assert int(got.it) == int(want.it) == 1
    assert torch.equal(got.lam, want.lam) and torch.equal(got.nu, want.nu)
    ok = torch.isfinite(want.g0)
    assert torch.equal(torch.isfinite(got.g0), ok)
    assert _rel(got.g0[ok], want.g0[ok]) < 1e-4
    dR, dC = _pose_gap(got, want)
    sound = torch.ones_like(dR, dtype=torch.bool)
    if name == "lanes":
        sound[2] = False
        f64 = ba.PoseLM(*(t.double() if t.is_floating_point() else t for t in st))
        with plain():
            w64 = ba.pose_lm_steps(f64, X.double(), uv.double(), inl, Ks.double(),
                                   dists.double(), OPTS, 1)
        kR, kC = _pose_gap(got, w64)
        pR, pC = _pose_gap(want, w64)
        assert float(kR[2]) <= 2 * float(pR[2]) + 1e-6 and float(kC[2]) <= 2 * float(pC[2]) + 1e-6
    assert float(dR[sound].max()) < 1e-5 and float(dC[sound].max()) < 1e-5
    if name == "edges":
        assert torch.equal(got.R[[1, 3]], R0[[1, 3]]) and torch.equal(got.C[[1, 3]], C0[[1, 3]])


@functools.lru_cache(maxsize=None)
def _far(name):
    """The problem `name` (D x L) from a start 0.1 rad and 0.3 m away: its
    first LM_GRAPH_STEPS steps each lower the cost by far more than the
    rounding."""
    D, L = map(int, name.split("x"))
    return pose_cases.frame_lanes(D, L, seed=D * 7 + L + 1, rot=0.1, shift=0.3)


@pytest.mark.parametrize("max_iterations", [RefinerOptions().max_iterations, 2])
@pytest.mark.parametrize("name", PROBLEMS[1:4])
def test_pose_lm_kernel_graph_call_equals_plain(dev, name, max_iterations):
    """One call of LM_GRAPH_STEPS iterations (a head or middle graph's),
    where the kernel reuses the candidate's linearization from one
    iteration to the next and, at max_iterations 2, stops every lane inside
    the call: each lane's pose no farther from the float64 twin than twice
    the float32 twin's distance plus 1e-5, or, on a lane not clear of the
    rounding floor, a step from it at a float64 cost within
    pose_cases.COST_FLOOR of the twin's (an accept flipped there); iterations
    and active equal on the lanes clear of the floor, of which there are
    some."""
    opts = dataclasses.replace(OPTS, max_iterations=max_iterations)
    case = _on(dev, _far(name))
    st = ba.pose_lm_init(case[0], case[1])
    got = ba.pose_lm_steps(st, *case[2:], opts, LM_GRAPH_STEPS)
    with plain():
        want = ba.pose_lm_steps(st, *case[2:], opts, LM_GRAPH_STEPS)
        f64 = ba.pose_lm_steps(ba.PoseLM(*_f64(st)), *_f64(case[2:]), opts, LM_GRAPH_STEPS)
    clear = pose_cases.clear_lanes(case, opts, LM_GRAPH_STEPS)
    assert bool(clear.any())
    assert torch.equal(got.iterations[clear], want.iterations[clear])
    assert torch.equal(got.active[clear], want.active[clear])
    kR, kC = _pose_gap(got, f64)
    pR, pC = _pose_gap(want, f64)
    close = (kR <= 2 * pR + 1e-5) & (kC <= 2 * pC + 1e-5)
    excess = pose_cases.cost_excess(case, opts, got, f64)
    assert bool((close | (~clear & (excess <= pose_cases.COST_FLOOR))).all())


@pytest.mark.parametrize("name", PROBLEMS[:4])
def test_pose_lm_kernel_run_as_accurate_as_plain(dev, name):
    """The whole LM (check_every 1) on the kernel and on the twin against
    the twin in float64: every lane's pose within twice the float32 twin's
    distance plus 1e-5, or on the floor of its valley (a float64 cost
    within pose_cases.COST_FLOOR of the float64 twin's)."""
    R0, C0, X, uv, inl, Ks, dists = _on(dev, _case(name))
    got = ba.pose_lm_run(ba.pose_lm_init(R0, C0), X, uv, inl, Ks, dists, OPTS, 1)
    want = _plain_run(R0, C0, X, uv, inl, Ks, dists)
    f64 = _plain_run(R0.double(), C0.double(), X.double(), uv.double(), inl, Ks.double(),
                     dists.double())
    kR, kC = _pose_gap(got, f64)
    pR, pC = _pose_gap(want, f64)
    close = (kR <= 2 * pR + 1e-5) & (kC <= 2 * pC + 1e-5)
    excess = pose_cases.cost_excess((R0, C0, X, uv, inl, Ks, dists), OPTS, got, f64)
    assert bool((close | (excess <= pose_cases.COST_FLOOR)).all())
    assert not bool(got.active.any())


@pytest.mark.parametrize("name", PROBLEMS)
def test_pose_cov_kernel_equals_plain(dev, name):
    """pose_lm_finish at the twin's solution: cov within 1e-4 (Frobenius,
    relative), rmse within 1e-5, n_obs equal; the all-masked lane's rmse 0
    and n_obs 0; NaN in U gives NaN where the twin's is NaN. The edges'
    lane 2 is held to finiteness only: its unmasked points at z <= 1e-9
    put entries of ~1e22 in U (1 / 1e-9 squared) over a null space at
    float32 noise, where neither float32 inverse is near a float64 one
    (0.35 and 0.65 Frobenius, measured)."""
    R0, C0, X, uv, inl, Ks, dists = _on(dev, _case(name))
    st = _plain_run(R0, C0, X, uv, inl, Ks, dists)
    got = ba.pose_lm_finish(st, X, uv, inl, Ks, dists, OPTS)
    with plain():
        want = ba.pose_lm_finish(st, X, uv, inl, Ks, dists, OPTS)
    torch.cuda.synchronize()
    assert torch.equal(got.n_obs, want.n_obs)
    assert torch.equal(got.Rs, want.Rs) and torch.equal(got.Cs, want.Cs)
    fin = torch.isfinite(want.cov).flatten(1).all(dim=1)
    assert torch.equal(torch.isfinite(got.cov).flatten(1).all(dim=1), fin)
    for d in torch.nonzero(fin).flatten().tolist():
        if name != "edges" or d != 2:
            assert _frob(got.cov[d], want.cov[d]) < 1e-4, d
    okr = torch.isfinite(want.rmse)
    assert torch.equal(torch.isfinite(got.rmse), okr)
    assert _rel(got.rmse[okr], want.rmse[okr]) < 1e-5
    if name == "edges":
        assert not bool(fin[3]) and int(got.n_obs[1]) == 0 and float(got.rmse[1]) == 0.0


@pytest.mark.parametrize("check_every", [1, 3, RefinerOptions().max_iterations])
def test_refine_pose_only_kernel_check_every_bit_equal(dev, check_every):
    """On the kernels a masked iteration changes nothing either: every
    output equal whichever period the host reads the exit at, and two
    launches of one call give the same bits."""
    for case in (pose_cases.lanes(), _case("2x5000")):
        args = _on(dev, case)
        base = ba.refine_pose_only(*args, OPTS, check_every=1)
        got = ba.refine_pose_only(*args, OPTS, check_every=check_every)
        torch.cuda.synchronize()
        for a, b in zip(base, got):
            assert torch.equal(a, b)


def test_pose_kernels_one_launch_a_call(dev):
    """One pose_lm launch a pose_lm_steps call, whatever n, and one
    pose_cov a pose_lm_finish; the twin launches neither."""
    args = _on(dev, _case("2x1024"))
    st = ba.pose_lm_init(args[0], args[1])
    for n in (1, 3, 7):
        before = dispatch.launch_counts()
        st = ba.pose_lm_steps(st, *args[2:], OPTS, n)
        after = dispatch.launch_counts()
        assert after["pose_lm"] == before["pose_lm"] + 1 and after["pose_cov"] == before["pose_cov"]
    before = dispatch.launch_counts()
    ba.pose_lm_finish(st, *args[2:], OPTS)
    with plain():
        ba.pose_lm_finish(st, *args[2:], OPTS)
        ba.pose_lm_steps(st, *args[2:], OPTS, 1)
    after = dispatch.launch_counts()
    assert after["pose_cov"] == before["pose_cov"] + 1 and after["pose_lm"] == before["pose_lm"]


@pytest.mark.parametrize("seed,dist", [(3, (0.0, 0.0, 0.0)), (4, (-0.05, 0.01, 0.0))])
def test_refine_pose_only_kernel_parity(dev, seed, dist):
    """refine_pose_only on the kernels within the tolerances that
    tests/test_torch_localize.py's test_refine_pose_only_parity holds the
    plain twin to against coloc_tpu (rotation 1e-4 rad, centre 1e-4,
    rmse 1e-3, cov 1e-2 relative, n_obs exact), here against the twin."""
    args = _on(dev, pose_cases.frame_lanes(1, 128, seed, dist=dist))
    got = ba.refine_pose_only(*(t[0] for t in args), OPTS)
    with plain():
        want = ba.refine_pose_only(*(t[0] for t in args), OPTS)
    dR = got.Rs[1] @ want.Rs[1].T
    angle = float(torch.arccos(((torch.trace(dR) - 1) / 2).clamp(-1, 1)))
    assert angle < 1e-4
    assert float((got.Cs[1] - want.Cs[1]).abs().max()) < 1e-4
    assert abs(float(got.rmse) - float(want.rmse)) < 1e-3
    assert _frob(got.cov, want.cov) < 1e-2
    assert int(got.n_obs) == int(want.n_obs)
