"""The port's run and run_chunked with update_map_every, the port alone on
the CPU (the schedule itself is held to coloc_tpu's in
tests/test_torch_update_map.py): real frames, real rebuilds. The
auto-update trigger is tests/test_torch_update_auto.py's (a file of its
own, so that the suite's workers share the two).

The scene and sizes are tests/update_cases.py's; runs are kept to 3-4 frames,
because the port's eager CPU frames slow down many times under the
suite's parallel workers.
"""

import torch

from coloc_tpu_torch.session import ColocSession
from update_cases import CFG, DISTS, KS, recording, frames as scene_frames
from port_harness import one_torch_thread, time_limit  # noqa: F401


def test_run_and_run_chunked_update_the_map_alike():
    """run(update_map_every=2) over frames 0-2 (bootstrap on 0) rebuilds
    the map on frame 2 into a new map, every frame of both drones
    localized; run_chunked(chunk=2, update_map_every=2) rebuilds on the
    same frame (the chunk's last) and, drawing from the same generator in
    the same order on the CPU, gives the same poses and the same rebuilt
    map bit for bit."""
    frames = scene_frames(3)
    runs = {}
    for entry, kw in (("run", {}), ("run_chunked", dict(chunk=2))):
        s = ColocSession(CFG, KS, DISTS, seed=0, device="cpu")
        log = recording(s)
        out = getattr(s, entry)(frames, inter_every=0, update_map_every=2, **kw)
        runs[entry] = (s, log, out)
    s, log, out = runs["run"]
    assert [(f, ok) for f, ok, _, _ in log] == [(2, True)]
    assert log[0][3] is not log[0][2] and s.mapdb is log[0][3]
    for d in range(2):
        assert len(out[d]) == 2 and all(bool(p.success) for p in out[d])
    sc, logc, outc = runs["run_chunked"]
    assert [(f, ok) for f, ok, _, _ in logc] == [(3, True)]  # one past the chunk
    for d in range(2):
        for p, q in zip(out[d], outc[d]):
            assert torch.equal(p.pose.R, q.pose.R) and torch.equal(p.pose.C, q.pose.C)
            assert torch.equal(p.cov, q.cov)
    assert torch.equal(s.mapdb.X, sc.mapdb.X) and torch.equal(s.mapdb.valid, sc.mapdb.valid)
