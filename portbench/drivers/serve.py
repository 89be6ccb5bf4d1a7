"""Batched serving: B camera streams localized against one resident map,
all B frames a request (`ServingEngine.localize_frames`, eager).

Set-up renders each stream's frames along its own path, builds the map
(inputs/landmarks.py) and draws the RANSAC uniforms from the seed, a few
sets, handed in. Request i takes the streams' frame i mod
frames_per_stream and uniform set i mod uniform_sets, so a run's requests
are of a few kinds. The batched frontend's features of the kinds that
the check samples (drawn from the seed) are kept as the window makes
them; the check judges them and every output of those kinds' requests.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from portbench import common, roofline
from portbench.inputs import landmarks
from portbench.inputs import scene as scene_mod
from portbench.reference import judge, pipeline, trip


def stream_path(rng: np.random.Generator, B: int, J: int):
    """B streams' poses at J times each, every stream on a path of its own
    (a seeded start, phase and heading): (R (J, B, 3, 3), C (J, B, 3))."""
    base = rng.uniform([-0.3, -0.15, -0.2], [0.3, 0.15, 0.2], (B, 3))
    phase = rng.uniform(0.0, 1.0, B)
    yaw = rng.uniform(-0.03, 0.03, B)
    Rs, Cs = [], []
    for j in range(J):
        t = j / max(J - 1, 1)
        for b in range(B):
            s = 2 * np.pi * (t + phase[b])
            w = np.array([0.02 * np.sin(s), yaw[b] - 0.04 * t, 0.01 * np.cos(s)])
            Rs.append(scene_mod.so3_exp(w))
            Cs.append(base[b] + np.array([0.4 * t, 0.08 * np.sin(s), 0.05 * t]))
    return (np.stack(Rs).reshape(J, B, 3, 3).astype(np.float32),
            np.stack(Cs).reshape(J, B, 3).astype(np.float32))


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device):
        from coloc_tpu_torch import config as prog_config
        from coloc_tpu_torch import serving
        from coloc_tpu_torch.geometry.camera import Camera
        from coloc_tpu_torch.types import MapDB

        self.device = device
        self.laps = lap = common.Laps(torch.cuda.synchronize if device.type == "cuda" else None)
        self.cfg_json, self.traffic = cfg, traffic
        self.B, self.J = traffic["streams"], traffic["frames_per_stream"]
        self.U = traffic["uniform_sets"]
        self.kinds = self.J * self.U // math.gcd(self.J, self.U)
        self.frames_per_request = self.B
        self.cfg = common.coloc_config(prog_config, cfg, self.B)
        self.K, self.dist = common.intrinsics(cfg)
        rng = np.random.default_rng(common.derive(seed, "streams"))
        sc = traffic["scene"]
        H, W = cfg["detector"]["height"], cfg["detector"]["width"]
        self.scene = scene_mod.make_scene(H, W, self.K, common.derive(seed, "scene"),
                                          tuple(sc["depths"]), sc["near_coverage"])
        self.Rs, self.Cs = stream_path(rng, self.B, self.J)
        lap("textures")
        self.blocks = self._frames()
        lap("render")
        self.map = landmarks.build(self.scene, cfg["detector"], cfg["max_landmarks"], device)
        lap("map")
        self.uniform_seed = common.derive(seed, "uniforms")
        self.uniforms = self._uniforms()
        cam = Camera(K=torch.as_tensor(self.K, device=device),
                     dist=torch.as_tensor(self.dist, device=device))
        self.eng = serving.ServingEngine(MapDB(*(t.clone() for t in self.map)), cam, self.cfg,
                                         device=device)
        self.checked = sorted(rng.choice(self.kinds, size=traffic["checked_kinds"],
                                         replace=False).tolist())
        # the features that localize_frames makes, seen as it makes them
        self._serving, self._detect = serving, serving.detect_and_describe_batch
        self._made = None
        self.features = {}

        def seen(images, opts):
            self._made = self._detect(images, opts)
            return self._made

        serving.detect_and_describe_batch = seen
        self.next = 0
        for w in range(traffic["warmup_requests"]):
            self.request()
            lap(f"warm-up request {w}")

    def _frames(self) -> List[torch.Tensor]:
        """Request kind j's frames, (B, H, W) on the device, for each j."""
        frames = scene_mod.render(self.scene, self.Rs.reshape(-1, 3, 3),
                                  self.Cs.reshape(-1, 3), self.device)
        return list(frames.reshape(self.J, self.B, *frames.shape[1:]))

    def _uniforms(self) -> List[torch.Tensor]:
        gen = torch.Generator(device=self.device).manual_seed(self.uniform_seed)
        return [torch.rand((self.B, self.cfg.ransac.num_hypotheses, 3), generator=gen,
                           device=self.device) for _ in range(self.U)]

    def request(self) -> Dict[str, np.ndarray]:
        """The next request -> its outputs on the host, (B, ...) each."""
        i = self.next
        self.next += 1
        pwc, inl, mm = self.eng.localize_frames(self.blocks[i % self.J],
                                                uniforms=self.uniforms[i % self.U])
        if i % self.kinds in self.checked:
            self.features[i % self.kinds] = self._made
        B, Kp = inl.shape
        f = torch.cat([pwc.pose.R.reshape(B, 9), pwc.pose.C, pwc.cov.reshape(B, 36),
                       pwc.rmse[:, None], pwc.n_tracks.to(torch.float32)[:, None],
                       pwc.success.to(torch.float32)[:, None], inl.to(torch.float32),
                       mm.idx.to(torch.float32)], dim=1).cpu().numpy()
        return {"request": i, "R": f[:, 0:9].reshape(B, 3, 3), "C": f[:, 9:12],
                "cov": f[:, 12:48].reshape(B, 6, 6), "rmse": f[:, 48],
                "n_tracks": f[:, 49].astype(np.int64), "success": f[:, 50] > 0.5,
                "inliers": f[:, 51:51 + Kp] > 0.5, "idx": f[:, 51 + Kp:].astype(np.int64)}

    @staticmethod
    def localized(out) -> int:
        return int(out["success"].sum())

    # -- the traced run ---------------------------------------------------------

    def window_started(self) -> None:
        pass

    def counters(self) -> Dict[str, float]:
        return {}

    def traced_requests(self) -> int:
        return self.traffic["traced_requests"]

    def request_bounds(self) -> Dict[str, float]:
        """Each port kernel's least time over one request's launches."""
        return roofline.step_bounds(self.cfg_json, self.B, self.cfg.ransac.num_hypotheses)

    def spans(self) -> Dict[str, List[float]]:
        """The two halves of localize_frames, called one after the other
        by the benchmark and timed by CUDA events on the device: the
        batched frontend and localize_features. Nothing off the card."""
        if self.device.type != "cuda":
            return {}
        out: Dict[str, List[float]] = {"frontend": [], "localize": []}
        for k in range(self.traffic["split_requests"]):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            feats = self._detect(self.blocks[k % self.J], self.cfg.detector)
            ev[1].record()
            self.eng.localize_features(feats, uniforms=self.uniforms[k % self.U])
            ev[2].record()
            torch.cuda.synchronize()
            out["frontend"].append(ev[0].elapsed_time(ev[1]))
            out["localize"].append(ev[1].elapsed_time(ev[2]))
        return out

    def release(self) -> None:
        """Free the program's state; keep the features the check judges."""
        self._serving.detect_and_describe_batch = self._detect
        self.eng = self.blocks = self.uniforms = self._made = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ----------------------------------------------------------------

    def check(self, outs: List[dict], control: bool = False) -> Dict[str, float]:
        """The judged numbers of the checked kinds: the kept features and
        every distinct output of those kinds' requests in `outs`. With
        `control`, the reference in float32 with TF32 takes the
        program's place."""
        dev = self.device
        X, words, valid = self.map
        B = self.B
        K = torch.as_tensor(self.K, device=dev).expand(B, 3, 3)
        dist = torch.as_tensor(self.dist, device=dev).expand(B, 3)
        blocks, uniforms = self._frames(), self._uniforms()     # made again from the seed
        numbers: Dict[str, float] = {}
        for kind in self.checked:
            frames, draws = blocks[kind % self.J], uniforms[kind % self.U]
            if control:
                with pipeline.precision(True):
                    c = pipeline.localize_frames(frames, self.cfg_json, X, words, valid, K,
                                                 dist, draws)
                xy, kv, bits = c["kp"].xy, c["kp"].valid, c["kp"].bits
                dwords = trip.bits_to_words(bits)
                answers = [{k: c[k] for k in ("R", "C", "cov", "success", "inliers", "idx")}]
            else:
                f = self.features.get(kind)
                mine = [o for o in outs if o["request"] % self.kinds == kind]
                if f is None or not mine:
                    continue
                xy, kv, dwords = f.xy, f.valid, f.desc
                bits = trip.words_to_bits(dwords)
                answers = [{k: torch.as_tensor(v, device=dev) for k, v in o.items()
                            if k != "request"} for o in distinct(mine)]
            with pipeline.precision(False):
                common.merge_max(numbers, judge.features(
                    xy, kv, judge.reference_frontend(frames, self.cfg_json["detector"]), bits))
                for a in answers:
                    idx = a["idx"].long()
                    common.merge_max(numbers, {"matches_differ": judge.matches(
                        idx, dwords, kv, words, valid, self.cfg_json["matcher"])})
                    corr = (idx >= 0) & kv
                    common.merge_max(numbers, judge.localize(
                        a["R"], a["C"], a["cov"], a["success"], a["inliers"],
                        X[torch.clamp(idx, min=0)], xy, corr, K, dist, draws))
        return numbers if numbers else {"requests_checked": 0.0}


def distinct(outs: List[dict]) -> List[dict]:
    """The outputs that differ from every earlier one."""
    seen: List[dict] = []
    for o in outs:
        if not any(all(np.array_equal(o[k], s[k]) for k in o if k != "request") for s in seen):
            seen.append(o)
    return seen
