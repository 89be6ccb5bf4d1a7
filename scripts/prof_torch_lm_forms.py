"""Two ways to capture the port's frame step as CUDA graphs, timed in one
call on one CUDA card.

    python scripts/prof_torch_lm_forms.py

The pose LM ends when every drone's lane has stopped, which only the
device knows. The session (coloc_tpu_torch/session.py, _StepGraphs) keeps
form (b): a head graph runs the step through LM_GRAPH_STEPS iterations,
the host reads whether a lane is still active and replays a middle graph
of as many iterations while one is, then a tail graph finishes the frame.
This script also captures form (a), the closer analogue of coloc_tpu's
lax.scan: all max_iterations LM iterations masked inside one graph, no
host read, and that with CHAIN frames chained in one graph. Each form is
held to the eager step with torch.equal on every output, the filter bank
and the landmark support, from the same state and uniforms, then timed
in turns (p50 a frame over REPS replays of FRAMES frames, CUDA events),
with its graph nodes a frame and its capture time, beside the card's
name and power limit.

The workload is chip_smoke.py's phase 4h: the bench scene (make_scene(480,
752, K, seed=1)) along drones 0 and 1's trajectories, the reference
configuration (1024 keypoints, 8 levels, 4096 landmarks, 256 hypotheses),
a session bootstrapped on frame 0.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from coloc_tpu_torch import config, session  # noqa: E402
from coloc_tpu_torch.fusion import kalman  # noqa: E402
from coloc_tpu_torch.io import synthetic  # noqa: E402

H, W = 480, 752
FRAMES, CHAIN, REPS = 4, 4, 5


class ChainGraphs:
    """Form (a): `frames` chained steps in one graph, every LM iteration
    masked inside it, the carried state in static buffers."""

    def __init__(self, sess, frames: int):
        cfg, dev = sess.config, sess.device
        D, B = cfg.num_drones, cfg.ransac.num_hypotheses
        self.cfg, self.frames = cfg, frames
        self.mapdb, self.bank = sess.mapdb, sess._map_bank()
        self.Ks, self.dists = sess.Ks, sess.dists
        self.images = torch.zeros((frames, D, H, W), device=dev)
        self.draws = torch.zeros((frames, D, B, 3), device=dev)
        self.fb = kalman.FilterBank(*(t.clone() for t in sess.filter_bank))
        self.sup = sess.lm_support.clone()
        self.last = sess.lm_last_seen.clone()
        self.frame = torch.zeros((), dtype=torch.int32, device=dev)
        t0 = time.perf_counter()
        self.graph, self.out, self.record = session._StepGraphs._graph(self._chain)
        torch.cuda.synchronize()
        self.capture_seconds = time.perf_counter() - t0

    def _chain(self):
        outs = []
        for f in range(self.frames):
            fr, lm = session._step_head(self.cfg, self.images[f], self.mapdb, self.bank,
                                        self.Ks, self.dists, uniforms=self.draws[f])
            lm = session._step_lm(self.cfg, fr, lm, self.Ks, self.dists,
                                  self.cfg.refiner.max_iterations)
            pwcs, sup_inc = session._step_tail(self.cfg, fr, lm, self.Ks, self.dists,
                                               self.mapdb.X.shape[0])
            fb, filtered, dist_g, rej, eulers = session._filter_all(self.cfg, pwcs, self.fb)
            sup, last = session._support(self.sup, self.last, sup_inc, self.frame)
            for old, new in zip(self.fb, fb):
                old.copy_(new)
            self.sup.copy_(sup)
            self.last.copy_(last)
            self.frame.add_(1)
            outs.append(session._chunk_out(pwcs, filtered, rej, dist_g, eulers, fb.P))
        return session._ChunkOut(*(torch.stack(v) for v in zip(*outs)))

    load = session._StepGraphs.load

    def run(self, images, draws):
        """Frames (F, D, H, W) and draws (F, D, B, 3), F a multiple of
        `frames` -> their outputs, (F, D, ...) each."""
        outs = []
        for i in range(0, images.shape[0], self.frames):
            self.images.copy_(images[i:i + self.frames])
            self.draws.copy_(draws[i:i + self.frames])
            self.graph.replay()
            outs.append(session._ChunkOut(*(t.clone() for t in self.out)))
        return session._ChunkOut(*(torch.cat(v) for v in zip(*outs)))

    def node_count(self):
        n = session.graph_nodes(self.graph)
        return None if n is None else n // self.frames


class HeadTail:
    """Form (b), the session's _StepGraphs, behind the same run()."""

    def __init__(self, sess):
        self.g = session._StepGraphs(sess)
        self.capture_seconds = self.g.capture_seconds
        self.load = self.g.load
        self.node_count = self.g.node_count

    def run(self, images, draws):
        return session._ChunkOut(*(torch.stack(v) for v in zip(*(
            self.g.replay(images[f], draws[f]) for f in range(images.shape[0])))))


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card)

    K = np.array([[0.6 * W, 0, W / 2], [0, 0.6 * W, H / 2], [0, 0, 1]], np.float32)
    scene = synthetic.make_scene(H, W, K, seed=1)
    traj = [synthetic.trajectory(FRAMES + 1, d) for d in range(2)]
    frames = torch.from_numpy(np.stack([
        np.stack([synthetic.render(scene, traj[d][0][f], traj[d][1][f]) for d in range(2)])
        for f in range(FRAMES + 1)]).astype(np.float32)).to(dev)
    cfg = config.ColocConfig(num_drones=2, detector=config.DetectorOptions(
        width=W, height=H, max_keypoints=1024, num_levels=8, fast_threshold=12))
    sess = session.ColocSession(cfg, np.stack([K, K]), np.zeros((2, 3), np.float32),
                                seed=0, device=dev)
    assert sess.init_map({0: frames[0, 0], 1: frames[0, 1]})
    sess._ensure_support()
    images = frames[1:]
    draws = torch.stack([sess._draw(2) for _ in range(FRAMES)])

    # the eager step from the session's state: what every form must give
    want, fb, sup, last = [], sess.filter_bank, sess.lm_support, sess.lm_last_seen
    for f in range(FRAMES):
        pwcs, fb, filt, dist_g, rej, eulers, sup_inc = session.intra_all_device_step(
            cfg, images[f], sess.mapdb, sess._map_bank(), sess.Ks, sess.dists, fb,
            uniforms=draws[f])
        sup, last = session._support(sup, last, sup_inc, sess.frame + f)
        want.append(session._chunk_out(pwcs, filt, rej, dist_g, eulers, fb.P))
    want = session._ChunkOut(*(torch.stack(v) for v in zip(*want)))

    forms = {"(b) head, middle while active, tail": HeadTail(sess),
             "(a) all LM iterations, 1 frame a graph": ChainGraphs(sess, 1),
             f"(a) all LM iterations, {CHAIN} frames a graph": ChainGraphs(sess, CHAIN)}
    for name, form in forms.items():
        form.load(sess)
        out = form.run(images, draws)
        state = form.g if isinstance(form, HeadTail) else form
        ok = (all(torch.equal(a, b) for a, b in zip(out, want))
              and all(torch.equal(a, b) for a, b in zip(state.fb, fb))
              and torch.equal(state.sup, sup) and torch.equal(state.last, last))
        assert ok, f"form {name} differs from the eager step"
    ms = {name: [] for name in forms}
    for r in range(REPS):
        for name in (list(forms) if r % 2 else list(forms)[::-1]):
            form = forms[name]
            form.load(sess)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            form.run(images, draws)
            end.record()
            torch.cuda.synchronize()
            ms[name].append(start.elapsed_time(end) / FRAMES)
    for name, form in forms.items():
        nodes = form.node_count()
        print(f"[form {name}] equal to the eager step (torch.equal, every output, "
              f"{FRAMES} frames); p50 {np.percentile(ms[name], 50):.3f} ms a frame over "
              f"{REPS} runs of {FRAMES} frames, "
              f"{nodes if nodes is not None else 'not measured'} graph nodes a frame, "
              f"capture {form.capture_seconds:.3f} s  ({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
