"""The port's SVG debug output, live view, landmark decimation and stage
profiler against coloc_tpu's on the CPU, and a session that writes the
overlays under coloc_tpu's file names and feeds the live view.

SVG and decimation are compared on the same numpy inputs (text-equal,
with PIL and with its import made to fail); LiveViz is held to
tests/test_liveviz.py's checks. The session cases bootstrap once at
tests/test_liveviz.py's 96x128 size (~4 s on the CPU); coloc_tpu's
frontend is not used, its file names are the ones coloc_tpu/session.py
writes.
"""

import json
import os
import sys
import urllib.request

import numpy as np
import pytest
import torch

from coloc_tpu.io import decimate_map_points as j_decimate
from coloc_tpu.io import svg as jsvg

from coloc_tpu_torch import checkpoint, robust
from coloc_tpu_torch import session as tsession
from coloc_tpu_torch.io import decimate_map_points as t_decimate
from coloc_tpu_torch.io import svg as tsvg
from coloc_tpu_torch.io import synthetic
from coloc_tpu_torch.io.liveviz import LiveViz
from coloc_tpu_torch.profiling import StageProfiler, trace_to
from coloc_tpu_torch.types import TwoViewGeometry

from plumbing_cases import H, W, cameras, config, frame, scene, session
from port_harness import one_torch_thread, time_limit  # noqa: F401


def _get(url):
    with urllib.request.urlopen(url, timeout=5) as r:
        return r.read().decode()


def _overlay_inputs():
    rng = np.random.default_rng(0)
    img1 = rng.uniform(0, 255, (H, W)).astype(np.float32)
    img2 = rng.uniform(0, 255, (H, W + 8)).astype(np.float32)
    xy1 = rng.uniform(0, W, (40, 2)).astype(np.float32)
    xy2 = rng.uniform(0, W, (50, 2)).astype(np.float32)
    idx = rng.integers(-1, 50, 40).astype(np.int32)
    return img1, img2, xy1, xy2, idx, idx >= 0, rng.uniform(size=40) < 0.7


@pytest.mark.parametrize("pil", [True, False], ids=["pil", "no_pil"])
@pytest.mark.parametrize("what", ["features", "matches"])
def test_svg_equals_reference(tmp_path, monkeypatch, pil, what):
    """The same overlay text as coloc_tpu's; without PIL the image is left
    out and the drawing stays."""
    if not pil:
        monkeypatch.setitem(sys.modules, "PIL", None)     # import PIL raises
    img1, img2, xy1, xy2, idx, mask, valid = _overlay_inputs()
    for name, mod in (("port", tsvg), ("ref", jsvg)):
        path = str(tmp_path / f"{name}.svg")
        if what == "features":
            mod.draw_features(path, img1, xy1, valid, color="red")
        else:
            mod.draw_matches(path, img1, img2, xy1, xy2, idx, mask)
    text = (tmp_path / "port.svg").read_text()
    assert text == (tmp_path / "ref.svg").read_text()
    assert text.startswith("<svg") and ("data:image/png" in text) == pil
    assert text.count("<circle") == (int(valid.sum()) if what == "features"
                                     else 2 * int(mask.sum()))


@pytest.mark.parametrize("case", [(None, 4096), ("mask", 4096), ("mask", 100), (None, 7)])
def test_decimate_map_points_equals_reference(case):
    rng = np.random.default_rng(1)
    X = rng.normal(size=(1000, 3)).astype(np.float32)
    valid = rng.uniform(size=1000) < 0.8 if case[0] else None
    want = j_decimate(X, valid, case[1])
    np.testing.assert_array_equal(t_decimate(X, valid, case[1]), want)
    # the session hands it host copies of its tensors; a CPU tensor works too
    np.testing.assert_array_equal(t_decimate(torch.from_numpy(X), valid, case[1]), want)


def test_liveviz_serves_page_and_state():
    viz = LiveViz(port=0)
    try:
        assert "coloc_tpu live" in _get(viz.url)
        assert json.loads(_get(viz.url + "state.json")) == {"poses": {}, "map": [],
                                                            "frame": None}
        viz.publish_pose(0, np.array([1.0, 2.0, 3.0]), cov3=np.eye(3) * 0.01, success=True,
                         frame=7)
        viz.publish_pose(1, np.array([-1.0, 0.5, 2.0]), success=False)
        viz.publish_map(np.array([[0, 0, 5], [1, 1, 6], [2, 0, 7]], np.float32),
                        valid=np.array([True, True, False]))
        state = json.loads(_get(viz.url + "state.json"))
        assert state["frame"] == 7 and state["poses"]["0"]["C"] == [1.0, 2.0, 3.0]
        assert state["poses"]["0"]["success"] is True
        assert state["poses"]["1"]["success"] is False
        assert len(state["map"]) == 2
    finally:
        viz.close()


def test_liveviz_view_config(tmp_path):
    """The repo-root coloc.view.json by default; a dict, a file and an
    unreadable file (a warning and the defaults) as tests/test_liveviz.py
    has them."""
    viz = LiveViz(port=0)
    try:
        view = json.loads(_get(viz.url + "view.json"))
        assert view["views"] == ["xz", "xy"] and view["trail"] == 500
        assert "view.json" in _get(viz.url)
    finally:
        viz.close()
    viz = LiveViz(port=0, view_config={"trail": 100, "views": ["zy"]})
    try:
        view = json.loads(_get(viz.url + "view.json"))
        assert view["trail"] == 100 and view["views"] == ["zy"] and view["point_size"] == 2
    finally:
        viz.close()
    p = tmp_path / "v.json"
    p.write_text(json.dumps({"bounds": [-2, 2, -1, 1]}))
    viz = LiveViz(port=0, view_config=str(p))
    try:
        assert json.loads(_get(viz.url + "view.json"))["bounds"] == [-2, 2, -1, 1]
    finally:
        viz.close()
    with pytest.warns(RuntimeWarning, match="view config"):
        viz = LiveViz(port=0, view_config=str(tmp_path / "missing.json"))
    try:
        assert json.loads(_get(viz.url + "view.json"))["trail"] == 500
    finally:
        viz.close()


def test_liveviz_map_downsampling():
    viz = LiveViz(port=0, max_map_points=100)
    try:
        viz.publish_map(np.random.default_rng(0).normal(size=(1000, 3)))
        assert 50 <= len(json.loads(_get(viz.url + "state.json"))["map"]) <= 100
    finally:
        viz.close()


def test_stage_profiler_summary_and_printer():
    lines = []
    prof = StageProfiler(enabled=True, printer=lines.append, device="cpu")
    for _ in range(3):
        with prof.stage("a"):
            torch.ones(8).sum()
    with prof.stage("b"):
        pass
    s = prof.summary()
    assert s["a"]["count"] == 3 and s["b"]["count"] == 1
    assert s["a"]["max_ms"] >= s["a"]["p50_ms"] >= 0.0
    assert len(lines) == 4 and lines[0].startswith("[a] ") and lines[0].endswith(" ms")
    report = []
    prof.report(printer=report.append)
    assert len(report) == 2 and "n=   3" in report[0]
    off = StageProfiler(enabled=False)
    with off.stage("a"):
        pass
    assert off.summary() == {}


def test_trace_to_writes_a_chrome_trace(tmp_path):
    with trace_to(str(tmp_path / "trace")):
        with StageProfiler(device="cpu").stage("traced_stage"):
            torch.ones(64).cumsum(0)
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json")
    text = (tmp_path / "trace" / files[0]).read_text()
    assert "traceEvents" in text and "traced_stage" in text
    with trace_to(""):                      # no directory: nothing traced
        pass


class _Recorder:
    """A live-view sink that records what the session publishes."""

    def __init__(self):
        self.poses, self.maps = [], []

    def publish_pose(self, drone, C, cov3=None, success=True, frame=None):
        self.poses.append((drone, frame, np.asarray(C), np.asarray(cov3), success))

    def publish_map(self, X, valid=None):
        self.maps.append((np.asarray(X), np.asarray(valid)))


@pytest.fixture(scope="module")
def debug_session(tmp_path_factory):
    """A D = 2 session with debug_dir, out_dir and a recording viz,
    bootstrapped at 96x128 (frame 0 of two trajectories), then frame 1 by
    intra_pose(0), intra_pose_all and a fusion of (0, 1)."""
    root = tmp_path_factory.mktemp("debug")
    viz = _Recorder()
    s = tsession.ColocSession(config(2), *cameras(2), viz=viz, debug_dir=str(root / "svg"),
                              out_dir=str(root / "logs"), device="cpu")
    frames = {}
    for d in range(2):
        Rs, Cs = synthetic.trajectory(3, d)
        frames[d] = [synthetic.render(scene(), Rs[f], Cs[f]).astype(np.float32)
                     for f in range(3)]
    assert s.init_map({d: frames[d][0] for d in range(2)})
    maps_after_init = len(viz.maps)
    s.frame = 1
    s.intra_pose(0, frames[0][1])
    s.intra_pose_all({d: frames[d][1] for d in range(2)})
    fused = s.inter_pose(0, 1, {d: frames[d][1] for d in range(2)})
    s.close()
    return s, viz, root, maps_after_init, fused, frames


def test_debug_dir_writes_reference_names(debug_session):
    s, _, root, _, fused, _ = debug_session
    assert fused is not None
    names = set(os.listdir(root / "svg"))
    want = {"init_features_d0.svg", "init_features_d1.svg", "init_putative_0_1.svg",
            "init_inlier_0_1.svg", "inter0001_s0_d1_putative.svg", "inter0001_s0_d1_guided.svg"}
    want |= {f"frame0001_d{d}_{k}.svg" for d in (0, 1) for k in ("features", "map_matches")}
    assert names == want
    for n in names:
        assert (root / "svg" / n).read_text().startswith("<svg")


def test_init_map_writes_the_map_ply(debug_session):
    """map.ply: the scene's valid landmarks and its two camera centres."""
    s, _, root, _, _, _ = debug_session
    rows = (root / "logs" / "map.ply").read_text().splitlines()
    n = int(s.scene.X_valid.sum()) + 2
    assert f"element vertex {n}" in rows and len(rows) == 10 + n
    assert rows[-1].endswith(" 0 255 0") and rows[10].endswith(" 255 255 255")


def test_viz_gets_the_map_and_every_frame(debug_session):
    """publish_map once after init_map; a pose of drone 0 from intra_pose,
    then one of each drone from intra_pose_all, with the filtered centre,
    the filter's position covariance and the frame."""
    s, viz, _, maps_after_init, _, _ = debug_session
    assert maps_after_init == 1
    X, valid = viz.maps[0]
    np.testing.assert_array_equal(valid, s.mapdb.valid.numpy())
    assert [(d, f) for d, f, *_ in viz.poses] == [(0, 1), (0, 1), (1, 1)]
    for d, _, C, cov3, ok in viz.poses[1:]:
        np.testing.assert_array_equal(C, s.last_pose[d].pose.C.numpy())
        np.testing.assert_array_equal(cov3, s.filter_bank.P[d, :3, :3].numpy())
        assert ok == bool(s.last_pose[d].success)


def test_viz_gets_chunk_frames_and_lifecycle_maps(debug_session, tmp_path):
    """intra_pose_chunk publishes every frame's poses; extend_map,
    merge_map_from and cull_map publish the map they leave."""
    base, _, _, _, _, frames = debug_session
    viz = _Recorder()
    s = tsession.ColocSession(config(2), *cameras(2), viz=viz, device="cpu")
    path = str(tmp_path / "s.npz")
    checkpoint.save_session(path, base)
    checkpoint.load_session(path, s)
    s.frame = 1
    block = np.stack([[frames[d][f] for d in range(2)] for f in (1, 2)])
    s.intra_pose_chunk(block)
    assert [(d, f) for d, f, *_ in viz.poses] == [(d, f) for f in (1, 2) for d in (0, 1)]
    s.extend_map({d: frames[d][2] for d in range(2)})
    s.merge_map_from(s.mapdb)
    s.frame = 500
    culled = s.cull_map(max_age=1, min_support=10 ** 6, keep_min=8)
    assert culled > 0
    np.testing.assert_array_equal(viz.maps[-1][1], s.mapdb.valid.numpy())


def test_liveviz_follows_a_session():
    """A real LiveViz on a session: its map and each drone's pose after a
    frame in /state.json."""
    viz = LiveViz(port=0)
    try:
        s = session(2, viz=viz)
        s._publish_map()
        s.intra_pose_all({d: frame() for d in range(2)})
        state = json.loads(_get(viz.url + "state.json"))
        assert len(state["map"]) == int(s.mapdb.valid.sum()) and set(state["poses"]) == {"0", "1"}
        assert state["poses"]["0"]["success"] is True
    finally:
        viz.close()


def test_debug_dir_names_at_d3(tmp_path, monkeypatch):
    """init_map over three drones writes each drone's features and each
    pair's putative and inlier matches, as coloc_tpu's names them, also
    when no pair's geometry succeeds (the relative pose made to fail)."""
    def failing(model, uv1, uv2, mask, *a, **k):
        z = torch.zeros((), dtype=torch.bool)
        return TwoViewGeometry(R=torch.eye(3), t=torch.zeros(3),
                               inliers=torch.zeros_like(mask), n_inliers=torch.zeros(
                                   (), dtype=torch.int32), success=z)

    monkeypatch.setattr(robust, "relative_pose", failing)
    s = tsession.ColocSession(config(3), *cameras(3), debug_dir=str(tmp_path), device="cpu")
    assert not s.init_map({d: frame() for d in range(3)})
    want = {f"init_features_d{d}.svg" for d in range(3)}
    want |= {f"init_{k}_{a}_{b}.svg" for a, b in ((0, 1), (0, 2), (1, 2))
             for k in ("putative", "inlier")}
    assert set(os.listdir(tmp_path)) == want
