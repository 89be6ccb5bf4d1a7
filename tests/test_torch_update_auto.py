"""The port's run with auto_update_map, the port alone on the CPU (the
schedule itself is held to coloc_tpu's in tests/test_torch_update_map.py):
real frames, a real rebuild attempt.

The scene and sizes are tests/update_cases.py's; runs are kept to 3-4 frames,
because the port's eager CPU frames slow down many times under the
suite's parallel workers.
"""

import numpy as np

from coloc_tpu_torch.session import ColocSession
from update_cases import CFG, DISTS, KS, H, W, recording, frames as scene_frames
from port_harness import one_torch_thread, time_limit  # noqa: F401


def test_run_auto_update_map_after_dead_frames():
    """run(auto_update_map=True, auto_update_patience=2) with frames 1 and
    2 blank (no drone can localize): update_map is called on frame 2, on
    the blank frames, so the rebuild fails and the map is kept; frame 3
    then localizes on it."""
    frames = scene_frames(4)
    blank = np.zeros((H, W), np.float32)
    for d in range(2):
        frames[d][1] = frames[d][2] = blank
    s = ColocSession(CFG, KS, DISTS, seed=0, device="cpu")
    log = recording(s)
    out = s.run(frames, inter_every=0, auto_update_map=True, auto_update_patience=2)
    assert s.map_ready
    assert [(f, ok) for f, ok, _, _ in log] == [(2, False)]
    assert log[0][3] is log[0][2] and s.mapdb is log[0][2]
    for d in range(2):
        ok = [bool(p.success) for p in out[d]]
        assert ok == [False, False, True], ok
