"""Batched multi-stream serving (counterpart of coloc_tpu.serving): B
independent camera streams localized against one resident map in one
dispatch of the step.

Beyond the reference, which serves two drones a frame at a time from ROS
callbacks (coloc_node.cpp:59, coloc.hpp:96-148). One frame leaves the card
underfilled: the RANSAC and refinement stages run tiny per-hypothesis
problems and B1's tiles are part full at one frame's queries. Batching B
streams shares ONE 2-NN over the B*K concatenated query descriptors
against the resident bank (B1 with Q = B*K) and localizes the streams over
a leading axis: one P3P launch of B x 256 samples (B2), one ranking launch
with the stream axis in its grid (B3) and one pose LM with a done mask per
stream. `localize_frames` adds the batched frontend (B4, B5). The step
runs eagerly; its times on the card are in PERF.md (chip_smoke.py 4m).

Two entry layers:

- `make_serve_step(config, cam)` — the plain step function
  (feats_b, mapdb, bank, generator=None, sample_idx=None, uniforms=None)
  -> (PoseWithCov (B, ...), inliers (B, K), Matches (B, K)).
- `ServingEngine` — holds the map and its packed bank (packed once,
  repacked by `set_map`) and serves `localize_features` /
  `localize_frames`.
- `make_sharded_serve_step(mesh, config)` — the step over a mesh of
  ranks (parallel/mesh): each rank is handed only its own B / n streams
  and serves them against its own copy of the map, with no collective.

Where coloc_tpu takes a JAX key, the port takes a torch.Generator that
draws the RANSAC samples, or the uniforms to draw them with (B, 256, 3),
or injected samples `sample_idx` (B, 256, 3) (how the parity tests replay
coloc_tpu's draws). A Camera with K (3, 3) is shared by every stream; one
with K (B, 3, 3) and dist (B, 3) gives each stream its own.

"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional, Tuple

import torch

from coloc_tpu_torch import matching
from coloc_tpu_torch.config import ColocConfig
from coloc_tpu_torch.frontend import detect_and_describe_batch
from coloc_tpu_torch.geometry.camera import Camera
from coloc_tpu_torch.ops import dispatch, hamming
from coloc_tpu_torch.profiling import span
from coloc_tpu_torch.sfm import localize
from coloc_tpu_torch.types import Features, MapDB, Matches, PoseWithCov

if TYPE_CHECKING:
    from coloc_tpu_torch.parallel.mesh import Mesh

# the pose LM's exit is read on the host every LM_CHECK_EVERY iterations,
# as in the eager session step
LM_CHECK_EVERY = 1


def _stream_cameras(cam: Camera, B: int) -> Camera:
    """A shared camera (K (3, 3)) broadcast to B streams; a batched one
    (K (B, 3, 3)) as it is."""
    if cam.K.dim() == 3:
        return cam
    return Camera(K=cam.K.expand(B, 3, 3).contiguous(),
                  dist=cam.dist.expand(B, 3).contiguous())


def make_serve_step(config: ColocConfig, cam: Camera):
    """The batched serving step for a fixed option set and camera:
    step(feats_b, mapdb, bank, generator=None, sample_idx=None,
    uniforms=None) -> (PoseWithCov with (B, ...) leaves, inliers (B, K)
    bool, Matches with (B, K) leaves: idx into the map's landmark slots, -1
    where rejected).

    `feats_b` is Features with a leading stream axis (B, K, ...), as
    detect_and_describe_batch gives it; `bank` must be
    matching.pack_map_bank(mapdb) of the same mapdb."""
    matcher, ransac, refiner = config.matcher, config.ransac, config.refiner

    def step(feats_b: Features, mapdb: MapDB, bank: hamming.Bank,
             generator: Optional[torch.Generator] = None,
             sample_idx: Optional[torch.Tensor] = None,
             uniforms: Optional[torch.Tensor] = None):
        B, kp = feats_b.valid.shape
        # one 2-NN over every stream's queries against the resident bank
        qv = feats_b.valid.reshape(-1)
        idx, best, second = hamming.hamming_2nn_bank(feats_b.desc.reshape(B * kp, -1), qv,
                                                     bank)
        m = matching._accept(idx, best, second, qv, matcher, matcher.margin_threshold)
        mm = Matches(*(t.reshape(B, kp) for t in m))
        pwc, inl = localize.localize_image(
            feats_b, mm, mapdb, _stream_cameras(cam, B), ransac, refiner,
            generator=generator, sample_idx=sample_idx, uniforms=uniforms,
            check_every=LM_CHECK_EVERY)
        return pwc, inl, mm

    return step


def make_sharded_serve_step(mesh: Mesh, config: ColocConfig):
    """Scale-out serving: B streams split over the mesh's ranks, b = B / n
    each, every rank holding the map and its bank. Serving is
    embarrassingly parallel, so there is no collective; and each rank is
    handed only its own streams, so it runs the frontend on its own b
    frames and n cards serve n x b streams at the one-card batched rate.

    Returns run(feats_b (b, K, ...), cams (K (b, 3, 3), dist (b, 3)),
    mapdb, bank, generator=None, sample_idx=None (b, 256, 3))
      -> (PoseWithCov (b, ...), inliers (b, K), Matches (b, K)) of this
         rank's streams, on the rank's device.

    coloc_tpu's run takes the global batch and shard_map hands each device
    its rows; here the rank at i on the mesh's first axis holds rows
    parallel.mesh.shard_rows(B, mesh, mesh.axis_names[0])[:2] of a global
    batch, and nothing is computed for another rank's. Cameras are per
    stream (broadcast a shared one); `bank` is
    matching.pack_map_bank(mapdb), packed once per rank. coloc_tpu folds
    its key with the axis index: here each rank's generator
    (parallel/mesh.rank_generator) or its injected draws."""

    def run(feats_b: Features, cams: Camera, mapdb: MapDB, bank: hamming.Bank,
            generator: Optional[torch.Generator] = None,
            sample_idx: Optional[torch.Tensor] = None):
        if cams.K.dim() != 3 or cams.K.shape[0] != feats_b.valid.shape[0]:
            raise ValueError("sharded serving takes a camera a stream: K (b, 3, 3)")
        if feats_b.valid.device != mesh.device:
            raise ValueError(f"streams on {feats_b.valid.device}, the rank on {mesh.device}")
        return make_serve_step(config, cams)(feats_b, mapdb, bank, generator=generator,
                                             sample_idx=sample_idx)

    return run


class ServingEngine:
    """Batched serving against a resident map.

    >>> eng = ServingEngine(mapdb, cam, config)
    >>> poses, inliers, matches = eng.localize_frames(images, generator=g)  # (B, H, W)

    The map's bank is packed once (setMapData parity, GPUMatcher.hpp:110-117)
    and stays on the device across calls; `set_map` replaces the map (after
    a session's update_map or extend_map, say) and repacks it. The map and
    camera are moved to `device` (None: cuda:0, raising where there is
    none; the CPU runs the kernels' plain twins)."""

    def __init__(self, mapdb: MapDB, cam: Camera, config: Optional[ColocConfig] = None,
                 device=None):
        self.config = config if config is not None else ColocConfig()
        self.device = dispatch.default_device(device)
        self.cam = Camera(*(t.to(self.device) for t in cam))
        self._step = make_serve_step(self.config, self.cam)
        self.set_map(mapdb)

    def set_map(self, mapdb: MapDB) -> None:
        """Swap the resident map and repack its bank."""
        self.mapdb = MapDB(*(t.to(self.device) for t in mapdb))
        self.bank = matching.pack_map_bank(self.mapdb)

    def localize_features(self, feats_b: Features,
                          generator: Optional[torch.Generator] = None,
                          sample_idx: Optional[torch.Tensor] = None,
                          uniforms: Optional[torch.Tensor] = None
                          ) -> Tuple[PoseWithCov, torch.Tensor, Matches]:
        """Match and localize B streams' extracted features, Features with
        (B, K, ...) leaves. Spans: `coloc.serve.request` over the call,
        holding `coloc.serve.localize`."""
        with span("coloc.serve.request"):
            feats_b = Features(*(t.to(self.device) for t in feats_b))
            with span("coloc.serve.localize"):
                return self._step(feats_b, self.mapdb, self.bank, generator=generator,
                                  sample_idx=sample_idx, uniforms=uniforms)

    def localize_frames(self, images: torch.Tensor,
                        generator: Optional[torch.Generator] = None,
                        sample_idx: Optional[torch.Tensor] = None,
                        uniforms: Optional[torch.Tensor] = None
                        ) -> Tuple[PoseWithCov, torch.Tensor, Matches]:
        """B raw frames (B, H, W) through the batched frontend (one launch a
        stage for every stream, frontend.detect_and_describe_batch), then
        match and localize. Spans: `coloc.serve.request` over the call,
        holding `coloc.serve.frontend` and `coloc.serve.localize`."""
        with span("coloc.serve.request"):
            images = torch.as_tensor(images, dtype=torch.float32).to(self.device)
            with span("coloc.serve.frontend"):
                feats_b = detect_and_describe_batch(images, self.config.detector)
            with span("coloc.serve.localize"):
                return self._step(feats_b, self.mapdb, self.bank, generator=generator,
                                  sample_idx=sample_idx, uniforms=uniforms)
