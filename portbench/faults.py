"""Faults planted in the program, each of which has to turn a run's
`correct` false: the upper readings of the numbers that the control does
not move (portbench/control.py --fault), and the benchmark's tests.

  state_unchanged  the filter step returns the bank it was given
  half_batch       the second half of a step's frames answered with the
                   first half's localizations
  altered          the first frame's pose turned by 0.01 rad where the
                   localization is produced
  inliers_halved   every other inlier of RANSAC's answer dropped where it
                   is produced
"""

from __future__ import annotations

import contextlib
import importlib

import torch


def state_unchanged(old):
    def f(cfg, pwcs, fb):
        _, filtered, dist_g, rej, eulers = old(cfg, pwcs, fb)
        from coloc_tpu_torch.fusion import kalman
        return fb, kalman.measurement_to_pose(fb.x), dist_g, rej, eulers
    return f


def half_batch(old):
    def f(res, n_inl, success):
        out = old(res, n_inl, success)
        h = out.success.shape[0] // 2

        def fill(t):
            return torch.cat([t[:h], t[:h], t[2 * h:]])
        from coloc_tpu_torch.types import Pose, PoseWithCov
        return PoseWithCov(Pose(fill(out.pose.R), fill(out.pose.C)), fill(out.cov),
                           fill(out.rmse), fill(out.n_tracks), fill(out.success))
    return f


def altered(old):
    turns = {}     # made on the first call, before any capture reads them

    def f(res, n_inl, success):
        out = old(res, n_inl, success)
        dev = out.pose.R.device
        if dev not in turns:
            c, s = 0.99995, 0.0099998
            turns[dev] = torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], device=dev)
        R = torch.cat([(turns[dev] @ out.pose.R[0])[None], out.pose.R[1:]])
        return out._replace(pose=out.pose._replace(R=R))
    return f


def inliers_halved(old):
    def f(*args, **kw):
        pose, inl, n, ok = old(*args, **kw)
        keep = (torch.arange(inl.shape[-1], device=inl.device) % 2) == 0
        inl = inl & keep
        return pose, inl, inl.sum(-1, dtype=torch.int32), ok
    return f


# fault -> the program's functions it wraps, (module, name) each
SITES = {
    state_unchanged: [("coloc_tpu_torch.session", "_filter_all")],
    half_batch: [("coloc_tpu_torch.sfm.localize", "finish")],
    altered: [("coloc_tpu_torch.sfm.localize", "finish")],
    # the session calls it through robust, serving through localize's name
    inliers_halved: [("coloc_tpu_torch.robust", "absolute_pose_p3p"),
                     ("coloc_tpu_torch.sfm.localize", "absolute_pose_p3p")],
}
BY_NAME = {f.__name__: f for f in SITES}


@contextlib.contextmanager
def planted(fault):
    """The program with `fault` (a function of SITES, or its name) planted."""
    fault = BY_NAME.get(fault, fault)
    saved = []
    for module, name in SITES[fault]:
        mod = importlib.import_module(module)
        old = getattr(mod, name)
        saved.append((mod, name, old))
        setattr(mod, name, fault(old))
    try:
        yield
    finally:
        for mod, name, old in saved:
            setattr(mod, name, old)
