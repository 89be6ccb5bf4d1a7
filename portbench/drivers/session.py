"""Drones' frames through a collaborative-localization session, a chunk a
request: `ColocSession.intra_pose_chunk`, replayed from CUDA graphs on
the card.

Set-up renders every drone's frames along its path, hands the session
the map (inputs/landmarks.py) and steps two chunks (the capture and a
replay). A request is the next chunk of the back-and-forth cycle over
the frames, its RANSAC draws seeded by the chunk's place in the cycle.
The session logs its poses (its pose log, written when the run ends).

The check judges the filter over every frame step the session took, from
the logged localizations, and the last frame step of the run stage by
stage, from what the captured step holds of it.
"""

from __future__ import annotations

import csv
import os
import shutil
import tempfile
from typing import Dict, List

import numpy as np
import torch

from portbench import common, roofline
from portbench.inputs import landmarks
from portbench.inputs import scene as scene_mod
from portbench.reference import geometry, judge, kalman, pipeline


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device):
        from coloc_tpu_torch import config as prog_config
        from coloc_tpu_torch import session
        from coloc_tpu_torch.types import MapDB

        self.device = device
        self.laps = lap = common.Laps(torch.cuda.synchronize if device.type == "cuda" else None)
        self.cfg_json, self.traffic = cfg, traffic
        self.D, self.F = traffic["drones"], traffic["chunk"]
        self.n_frames = traffic["frames_per_drone"]
        self.cycle = list(range(self.n_frames)) + list(range(self.n_frames - 1, -1, -1))
        if len(self.cycle) % self.F:
            raise ValueError("the back-and-forth cycle must hold whole chunks")
        self.period = len(self.cycle) // self.F        # chunks a cycle
        self.frames_per_request = self.D * self.F
        self.cfg = common.coloc_config(prog_config, cfg, self.D)
        K, dist = common.intrinsics(cfg)
        self.Ks = np.stack([K] * self.D)
        self.dists = np.stack([dist] * self.D)
        self.draw_seeds = [common.derive(seed, "draws", p) for p in range(self.period)]
        sc = traffic["scene"]
        self.scene = scene_mod.make_scene(cfg["detector"]["height"], cfg["detector"]["width"],
                                          K, common.derive(seed, "scene"), tuple(sc["depths"]),
                                          sc["near_coverage"])
        lap("textures")
        frames = self._render()                               # (n_frames, D, H, W)
        self.blocks = [frames[self._frame_index(p)].contiguous() for p in range(self.period)]
        lap("render")
        self.map = landmarks.build(self.scene, cfg["detector"], cfg["max_landmarks"], device)
        lap("map")
        self.log_dir = tempfile.mkdtemp(prefix="portbench-session-")
        self.sess = session.ColocSession(self.cfg, self.Ks, self.dists, out_dir=self.log_dir,
                                         device=device)
        self.sess.mapdb = MapDB(*(t.clone() for t in self.map))
        self.sess.map_ready = True
        self.history: List[dict] = []
        self.next_chunk = 0
        for w in range(traffic["warmup_chunks"]):
            self.request()
            lap(f"warm-up chunk {w}")

    def _render(self) -> torch.Tensor:
        paths = [scene_mod.trajectory(self.n_frames, d) for d in range(self.D)]
        Rs = np.stack([p[0] for p in paths], axis=1).reshape(-1, 3, 3)
        Cs = np.stack([p[1] for p in paths], axis=1).reshape(-1, 3)
        imgs = scene_mod.render(self.scene, Rs, Cs, self.device)
        return imgs.reshape(self.n_frames, self.D, *imgs.shape[1:])

    def _frame_index(self, p: int) -> torch.Tensor:
        return torch.tensor(self.cycle[p * self.F:(p + 1) * self.F], device=self.device)

    def _draws(self, p: int) -> torch.Tensor:
        """The uniforms of chunk place p, (F, D, 256, 3): as the session
        draws them, frame by frame, from its generator so seeded."""
        gen = torch.Generator(device=self.device).manual_seed(self.draw_seeds[p])
        return torch.stack([torch.rand((self.D, self.cfg.ransac.num_hypotheses, 3),
                                       generator=gen, device=self.device)
                            for _ in range(self.F)])

    def request(self) -> Dict[str, np.ndarray]:
        """The next chunk -> its outputs on the host, (F, D, ...) each."""
        c = self.next_chunk
        self.next_chunk += 1
        p = c % self.period
        self.sess.generator.manual_seed(self.draw_seeds[p])
        out = self.sess.intra_pose_chunk(self.blocks[p])
        rows = [out[d][f] for f in range(self.F) for d in range(self.D)]
        parts = [torch.stack([r.pose.R for r in rows]).reshape(len(rows), 9),
                 torch.stack([r.pose.C for r in rows]),
                 torch.stack([r.cov for r in rows]).reshape(len(rows), 36),
                 torch.stack([r.success for r in rows]).to(torch.float32)[:, None]]
        host = torch.cat(parts, dim=1).cpu().numpy().reshape(self.F, self.D, -1)
        res = {"chunk": c, "R": host[..., 0:9].reshape(self.F, self.D, 3, 3),
               "C": host[..., 9:12], "cov": host[..., 12:48].reshape(self.F, self.D, 6, 6),
               "success": host[..., 48] > 0.5}
        self.history.append(res)
        return res

    @staticmethod
    def localized(out) -> int:
        return int(out["success"].sum())

    # -- the traced run's counters ------------------------------------------

    def window_started(self) -> None:
        g = self.sess._graphs       # None off the card, where nothing is captured
        self.reads0 = g.host_reads if g is not None else 0
        self.chunk0 = self.next_chunk

    def counters(self) -> Dict[str, float]:
        g = self.sess._graphs
        if g is None:
            return {}
        steps = (self.next_chunk - self.chunk0) * self.F
        out = {"host_reads_per_step": (g.host_reads - self.reads0) / max(steps, 1)}
        nodes = g.node_count()
        if nodes is not None:
            out["graph_nodes_per_step"] = float(nodes)
        return out

    def traced_requests(self) -> int:
        return self.traffic["traced_chunks"]

    def request_bounds(self) -> Dict[str, float]:
        step = roofline.step_bounds(self.cfg_json, self.D, self.cfg.ransac.num_hypotheses)
        return {k: v * self.F for k, v in step.items()}

    def spans(self) -> Dict[str, List[float]]:
        return {}

    def release(self) -> None:
        """Keep what the check reads of the program (the last frame step as
        the captured step holds it, and the pose log), then free the
        program's state."""
        sess = self.sess
        g = sess._graphs
        if g is not None:
            fr = g.frame_t
            self.last = {"X": fr.X.clone(), "uv": fr.uv.clone(), "inliers": fr.inliers.clone(),
                         "idx": fr.idx.clone(), "matched": fr.matched.clone()}
        else:                        # the CPU's eager step keeps no frame: make it again
            self.last = self._eager_last_frame()
        sess.flush_logs()
        self.log = read_pose_log(os.path.join(self.log_dir, "poses.txt"), self.D)
        sess.close()
        shutil.rmtree(self.log_dir, ignore_errors=True)
        self.sess = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _eager_last_frame(self) -> dict:
        """The last frame step's head, run again by the program's own step
        (off the card only, where the step is not captured)."""
        from coloc_tpu_torch import session

        c = self.next_chunk - 1
        p = c % self.period
        sess = self.sess
        fr, _ = session._step_head(self.cfg, self.blocks[p][-1], sess.mapdb, sess._map_bank(),
                                   sess.Ks, sess.dists, uniforms=self._draws(p)[-1])
        return {"X": fr.X, "uv": fr.uv, "inliers": fr.inliers, "idx": fr.idx,
                "matched": fr.matched}

    # -- the check ------------------------------------------------------------

    def check(self, outs: List[dict], control: bool = False) -> Dict[str, float]:
        """The filter over every frame step, from the logged localizations;
        the last frame step's features, matches and localization. With
        `control`, the reference in float32 with TF32 takes the program's
        place."""
        dev = self.device
        X, words, valid = self.map
        D, F = self.D, self.F
        K = torch.as_tensor(self.Ks, device=dev)
        dist = torch.as_tensor(self.dists, device=dev)
        frames = self._render()              # made again from the seed
        c = self.history[-1]["chunk"]
        p = c % self.period
        last_frames = frames[self._frame_index(p)][-1]
        last_draws = self._draws(p)[-1]
        fcfg = self.cfg_json["filter"]
        if control:
            prog = self._control(frames, K, dist, fcfg)
        else:
            prog = self._program()
        numbers: Dict[str, float] = {}
        with pipeline.precision(False):
            common.merge_max(numbers, judge.filtered(prog["R"], prog["C"], prog["z"],
                                                     prog["cov3"], prog["rmse"], prog["ok"],
                                                     fcfg))
            ref = judge.reference_frontend(last_frames, self.cfg_json["detector"])
            lf = prog["last"]
            common.merge_max(numbers, judge.features(lf["uv"], lf["valid"], ref))
            common.merge_max(numbers, {"matches_differ": judge.matches_by_position(
                lf["uv"], lf["valid"], lf["idx"], ref, words, valid, self.cfg_json["matcher"])})
            common.merge_max(numbers, judge.localize(
                lf["R"], lf["C"], lf["cov"], lf["success"], lf["inliers"], lf["X"], lf["uv"],
                lf["corr"], K, dist, last_draws))
        return numbers

    def _program(self) -> dict:
        """The program's filtered poses and logged localizations of every
        frame step, and its last frame step."""
        dev = self.device
        hist = self.history
        t = {k: torch.as_tensor(np.concatenate([h[k] for h in hist]), device=dev)
             for k in ("R", "C", "cov", "success")}
        log = self.log
        n = t["R"].shape[0]
        if log["z"].shape[0] != n:
            raise RuntimeError(f"the pose log holds {log['z'].shape[0]} frame steps, "
                               f"the session took {n}")
        z, cov3, rmse = (torch.as_tensor(log[k], device=dev) for k in ("z", "cov3", "rmse"))
        lf = self.last
        ok_last = t["success"][-1]
        matched = lf["matched"].bool()
        return {"R": t["R"], "C": t["C"], "z": z, "cov3": cov3, "rmse": rmse,
                "ok": t["success"],
                "last": {"uv": lf["uv"], "valid": (lf["uv"] != 0).any(-1), "idx": lf["idx"].long(),
                         "X": lf["X"], "inliers": lf["inliers"], "corr": matched,
                         "R": geometry.rot_of(z[-1, :, 3:].double()), "C": z[-1, :, :3].double(),
                         "cov": t["cov"][-1], "success": ok_last}}

    def _control(self, frames, K, dist, fcfg: dict) -> dict:
        """The reference in float32 with TF32 over every frame step that
        the session took, in the program's place."""
        dev = self.device
        steps: Dict[int, dict] = {}
        with pipeline.precision(True):
            for p in range(self.period):
                block = frames[self._frame_index(p)]
                draws = self._draws(p)
                loc = pipeline.localize_frames(block.reshape(-1, *block.shape[2:]), self.cfg_json,
                                               *self.map, K.repeat(self.F, 1, 1),
                                               dist.repeat(self.F, 1),
                                               draws.reshape(-1, *draws.shape[2:]))
                steps[p] = loc
            order = [h["chunk"] % self.period for h in self.history]

            def seq(key):
                return torch.cat([steps[p][key].reshape(self.F, self.D, *steps[p][key].shape[1:])
                                  for p in order])
            R, C, cov, rmse, ok = seq("R"), seq("C"), seq("cov"), seq("rmse"), seq("success")
            z = torch.cat([C, geometry.euler_of(R)], -1)
            cov3 = cov[..., 3:, 3:]
            Rf, Cf = kalman.run(z, cov3, rmse, ok, fcfg)
        last = steps[order[-1]]
        sl = slice((self.F - 1) * self.D, self.F * self.D)
        kp = last["kp"]
        return {"R": Rf, "C": Cf, "z": z, "cov3": cov3, "rmse": rmse, "ok": ok,
                "last": {"uv": kp.xy[sl], "valid": kp.valid[sl], "idx": last["idx"][sl],
                         "X": last["X"][sl], "inliers": last["inliers"][sl],
                         "corr": last["corr"][sl], "R": last["R"][sl], "C": last["C"][sl],
                         "cov": last["cov"][sl], "success": last["success"][sl]}}


def read_pose_log(path: str, drones: int) -> Dict[str, np.ndarray]:
    """The session's pose log (frame, drone, ..., centre, centre
    covariance, bank, attitude, heading, rmse, tracks) -> z (N, D, 6),
    cov3 (N, D, 3, 3), rmse (N, D), in frame order."""
    with open(path) as fh:
        rows = list(csv.DictReader(fh))
    rows.sort(key=lambda r: (int(r["idx"]), int(r["dest"])))
    a = np.array([[float(r[k]) for k in ("x", "y", "z", "roll", "pitch", "yaw", "rmse")]
                  + [float(r[f"c{i}{j}"]) for i in range(3) for j in range(3)] for r in rows])
    n = len(rows) // drones
    a = a[:n * drones].reshape(n, drones, -1)
    return {"z": a[..., :6], "rmse": a[..., 6], "cov3": a[..., 7:16].reshape(n, drones, 3, 3)}
