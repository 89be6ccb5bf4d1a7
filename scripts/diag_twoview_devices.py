"""Where the card and the CPU part on the F and H two-view paths.

On the bench camera (752x480, 1024 keypoints, 8 levels) and make_scene
seed 1 (two depths for model F, one plane at depth 8 for model H), frame 0
of drones 0 and 1: the minimal solvers' models on the same 256 samples
(seven_point as candidate sets, four_point) on the card in float32 and on
the CPU in float32, each against the CPU in float64; then
relative_pose_{fundamental,homography} on the card and through the plain
CPU path from the same features, matches and samples, with
torch.linalg.eigh as it is and with eigh taken in float64, each also
against the ground truth. Then where the two part: the hypothesis RANSAC
keeps on each side (sample and candidate, its NFA and threshold, each
side's winner scored on the CPU), whether the re-fit replaced it, and the
re-fit plus decomposition on both devices from one inlier set (the CPU's
RANSAC inliers). Needs a CUDA device:

    python scripts/diag_twoview_devices.py
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import numpy as np
import torch

from coloc_tpu_torch import config, ransac as ransac_mod, robust
from coloc_tpu_torch.geometry import camera as cam_ops
from coloc_tpu_torch.geometry import essential as ess
from coloc_tpu_torch.geometry import homography as homog
from coloc_tpu_torch.io import synthetic
from coloc_tpu_torch.matching import match_pair
from coloc_tpu_torch.ransac import sample_indices
from coloc_tpu_torch.session import ColocSession

H, W = 480, 752
dev = torch.device("cuda", 0)
K = np.array([[0.6 * W, 0, W / 2], [0, 0.6 * W, H / 2], [0, 0, 1]], np.float32)
opts = config.DetectorOptions(width=W, height=H, max_keypoints=1024, num_levels=8,
                              fast_threshold=12)


def angle(Ra, Rb):
    d = torch.linalg.norm((Ra.double().cpu() - Rb.double().cpu())) / (2.0 * 2.0 ** 0.5)
    return float(2.0 * torch.asin(torch.clamp(d, max=1.0)))


def dir_angle(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float(torch.arccos(torch.clamp(a @ b / (a.norm() * b.norm()), -1, 1)))


real_eigh = torch.linalg.eigh


def eigh64(A, *a, **k):
    w, v = real_eigh(A.double(), *a, **k)
    return w.to(A.dtype), v.to(A.dtype)


for model, depths, S in (("F", (6.0, 12.0), 7), ("H", (8.0,), 4)):
    scene = synthetic.make_scene(H, W, K, seed=1, depths=depths)
    imgs, gt = {}, {}
    for d in range(2):
        Rs, Cs = synthetic.trajectory(11, d)
        imgs[d] = synthetic.render(scene, Rs[0], Cs[0]).astype(np.float32)
        gt[d] = (Rs[0], Cs[0])
    R_gt = torch.from_numpy(gt[1][0] @ gt[0][0].T)
    t_gt = torch.from_numpy(gt[1][0] @ (gt[0][1] - gt[1][1]))
    cfg = config.ColocConfig(num_drones=2, detector=opts, model=model)
    s = ColocSession(cfg, np.stack([K, K]), np.zeros((2, 3), np.float32), seed=0)
    f0, f1 = s.detect(imgs[0]), s.detect(imgs[1])
    m = match_pair(f0, f1, cfg.matcher)
    draws = sample_indices(m.mask, 256, S, torch.Generator(device=dev).manual_seed(11))
    uv1, uv2, mask = f0.xy, f1.xy[m.idx.long()], m.mask
    cam = s.cams[0]
    if model == "H":
        x1 = cam_ops.undistort(cam, cam_ops.normalize(cam, uv1))
        x2 = cam_ops.undistort(cam, cam_ops.normalize(cam, uv2))
        s1, s2 = x1[draws], x2[draws]
        Hg = homog.four_point(s1, s2).cpu().double()
        Hc = homog.four_point(s1.cpu(), s2.cpu()).double()
        H64 = homog.four_point(s1.cpu().double(), s2.cpu().double())
        for tag, Hx in (("card f32", Hg), ("cpu f32", Hc)):
            rel = ((Hx - H64).flatten(1).norm(dim=1) / H64.flatten(1).norm(dim=1))
            print(f"[H four_point] {tag} vs cpu f64: median {float(rel.median()):.2e}, "
                  f"90% {float(rel.quantile(0.9)):.2e}, max {float(rel.max()):.2e}")
    else:
        u1 = cam_ops.undistort_pixel(cam, uv1)
        u2 = cam_ops.undistort_pixel(cam, uv2)
        s1, s2 = u1[draws], u2[draws]
        out = {}
        for tag, a, b in (("card f32", s1, s2), ("cpu f32", s1.cpu(), s2.cpu()),
                          ("cpu f64", s1.cpu().double(), s2.cpu().double())):
            Fs, v = ess.seven_point(a, b)
            out[tag] = (Fs.cpu().double(), v.cpu())
        F64, v64 = out["cpu f64"]
        for tag in ("card f32", "cpu f32"):
            Fx, vx = out[tag]
            d = []
            for bi in range(256):
                for k in torch.nonzero(v64[bi]).flatten().tolist():
                    c = [min(float((F64[bi, k] - Fx[bi, j]).norm()), float((F64[bi, k] + Fx[bi, j]).norm()))
                         for j in torch.nonzero(vx[bi]).flatten().tolist()]
                    d.append(min(c) if c else float("inf"))
            d = np.asarray(d)
            print(f"[F seven_point] {tag} vs cpu f64 (sets, unit norm): median {np.median(d):.2e}, "
                  f"90% {np.quantile(d, 0.9):.2e}, max {d.max():.2e}; valid counts equal "
                  f"{float((vx.sum(1) == v64.sum(1)).float().mean()):.3f}")
    for tag, patch in (("eigh f32", None), ("eigh f64", eigh64)):
        if patch is not None:
            torch.linalg.eigh = patch
        try:
            gg = robust.relative_pose(model, uv1, uv2, mask, cam, s.cams[1], cfg.ransac, sample_idx=draws)
            cc = robust.relative_pose(model, uv1.cpu(), uv2.cpu(), mask.cpu(),
                                      cam_ops.Camera(cam.K.cpu(), cam.dist.cpu()),
                                      cam_ops.Camera(s.cams[1].K.cpu(), s.cams[1].dist.cpu()),
                                      cfg.ransac, sample_idx=draws.cpu())
        finally:
            torch.linalg.eigh = real_eigh
        flips = int((gg.inliers.cpu() != cc.inliers).sum())
        print(f"[{model} relative_pose, {tag}] card vs CPU: inliers {int(gg.n_inliers)} / "
              f"{int(cc.n_inliers)} ({flips} differ), R {angle(gg.R, cc.R):.2e} rad, t "
              f"{dir_angle(gg.t, cc.t):.2e} rad; from the ground truth: card R "
              f"{angle(gg.R, R_gt):.2e} t {dir_angle(gg.t, t_gt):.2e}, CPU R "
              f"{angle(cc.R, R_gt):.2e} t {dir_angle(cc.t, t_gt):.2e} rad")

    # where the two part: RANSAC's choice, the keep-if-better re-fit, and
    # the re-fit plus decomposition from one inlier set
    rec = {}
    real_ransac, real_refit = robust.ransac, robust._refit

    def rec_ransac(*a, **k):
        out = real_ransac(*a, **k)
        rec.setdefault("ransac", []).append(out)
        return out

    def rec_refit(res, refit_model, scorer, msk):
        out = real_refit(res, refit_model, scorer, msk)
        rec.setdefault("refit", []).append((refit_model, out))
        return out

    robust.ransac, robust._refit = rec_ransac, rec_refit
    try:
        gg = robust.relative_pose(model, uv1, uv2, mask, cam, s.cams[1], cfg.ransac,
                                  sample_idx=draws)
        cams_c = [cam_ops.Camera(c.K.cpu(), c.dist.cpu()) for c in s.cams[:2]]
        cc = robust.relative_pose(model, uv1.cpu(), uv2.cpu(), mask.cpu(), *cams_c,
                                  cfg.ransac, sample_idx=draws.cpu())
    finally:
        robust.ransac, robust._refit = real_ransac, real_refit
    (rg, rc), (fg, fc) = rec["ransac"], rec["refit"]
    if model == "H":
        data_c = (x1.cpu(), x2.cpu())
        f2 = (cams_c[1].fx + cams_c[1].fy) * 0.5
        score_c = lambda Hs: f2 ** 2 * homog.transfer_error_sq_batch(Hs, *data_c)  # noqa: E731
        cands = {"card": homog.four_point(s1, s2)[:, None].cpu(),
                 "cpu": homog.four_point(s1.cpu(), s2.cpu())[:, None]}
        log_a0, dim = torch.log10(torch.tensor(np.pi) / (4.0 * cams_c[1].cx * cams_c[1].cy)), 2.0
    else:
        data_c = (u1.cpu(), u2.cpu())
        score_c = lambda Fs: ess.symmetric_epipolar_distance_sq_batch(Fs, *data_c)  # noqa: E731
        cands = {"card": ess.seven_point(s1, s2)[0].cpu(), "cpu": ess.seven_point(s1.cpu(), s2.cpu())[0]}
        Dpx = torch.sqrt((2.0 * cams_c[0].cx) ** 2 + (2.0 * cams_c[0].cy) ** 2)
        log_a0, dim = torch.log10(2.0 * Dpx / (4.0 * cams_c[0].cx * cams_c[0].cy)), 1.0
    winners = {}
    for tag, r in (("card", rg), ("cpu", rc)):
        flat = cands[tag].reshape(-1, 3, 3)
        j = int((flat - r.model.cpu()).flatten(1).abs().amax(1).argmin())
        winners[tag] = (j, r.model.cpu())
    both = torch.stack([winners["card"][1], winners["cpu"][1]])
    nfa, thr = ransac_mod.nfa_scores(score_c(both), mask.cpu(), S, log_a0, dim)
    for i, tag in enumerate(("card", "cpu")):
        r, j = (rg, rc)[i], winners[tag][0]
        other = cands["cpu" if tag == "card" else "card"].reshape(-1, 3, 3)[j]
        wm = winners[tag][1]
        same = min(float((wm / wm.norm() - other / other.norm()).norm()),
                   float((wm / wm.norm() + other / other.norm()).norm()))
        print(f"[{model} ransac] {tag}: keeps sample {j // cands[tag].shape[1]} candidate "
              f"{j % cands[tag].shape[1]}, {int(r.n_inliers)} inliers at threshold_sq "
              f"{float(r.threshold_sq):.4g}; scored on the CPU: log10 NFA {float(nfa[i]):.4f}, "
              f"threshold_sq {float(thr[i]):.4g}; the other side's model of that hypothesis "
              f"{same:.2e} away (unit norm)")
    for tag, (refit_model, out), r in (("card", fg, rg), ("cpu", fc, rc)):
        print(f"[{model} refit] {tag}: RANSAC {int(r.n_inliers)} inliers, re-fit kept "
              f"{torch.equal(out[0], refit_model)}, final {int(out[2])} inliers")
    # one inlier set (the CPU's RANSAC inliers) through the re-fit and the
    # decomposition on both devices
    inl = rc.inliers
    same_inl = {}
    for tag, dv in (("card", dev), ("cpu", torch.device("cpu"))):
        w = inl.to(dv).to(torch.float32)
        if model == "H":
            a1, a2 = x1.to(dv), x2.to(dv)
            Hm = homog.four_point(a1, a2, weights=w)
            R, t, _n, _ok = homog.decompose_homography(Hm, a1, a2, inl.to(dv),
                                                       cfg.ransac.chirality_ratio)
        else:
            a1, a2 = u1.to(dv), u2.to(dv)
            c1, c2 = (cam if dv == dev else cams_c[0]), (s.cams[1] if dv == dev else cams_c[1])
            F = ess.fundamental_8pt(a1, a2, weights=w)
            E = c2.K.T @ F @ c1.K
            R, t = ess.decompose_essential(E, cam_ops.normalize(c1, a1),
                                           cam_ops.normalize(c2, a2), inl.to(dv))
        same_inl[tag] = (R, t)
    print(f"[{model} refit, one inlier set] {int(inl.sum())} inliers (the CPU's RANSAC set): "
          f"card vs CPU R {angle(same_inl['card'][0], same_inl['cpu'][0]):.2e} rad, t "
          f"{dir_angle(same_inl['card'][1], same_inl['cpu'][1]):.2e} rad; from the ground truth: "
          f"card R {angle(same_inl['card'][0], R_gt):.2e}, CPU R {angle(same_inl['cpu'][0], R_gt):.2e} rad")
