"""The port's host ingest against coloc_tpu's on the CPU: io/stream
(FrameStream, ApproximateTimeSync, StreamInterface over a port session),
the EuRoC and KITTI readers on sequences written to tmp_path (as
tests/test_euroc.py and tests/test_kitti.py write them), synthetic's
write_dataset / write_png, and the native loader built in
coloc_tpu_torch/_build (never coloc_tpu/native's library).
"""

import os
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from coloc_tpu.io import disk as jdisk
from coloc_tpu.io import euroc as jeuroc
from coloc_tpu.io import kitti as jkitti
from coloc_tpu.io import synthetic as jsyn

from coloc_tpu_torch.io import disk, euroc, kitti, native_loader, stream, synthetic

import plumbing_cases
from test_euroc import _write_sequence as write_euroc
from test_kitti import _write_sequence as write_kitti
from port_harness import one_torch_thread, time_limit  # noqa: F401

H, W = 96, 128
K = np.array([[100.0, 0, 64], [0, 101.0, 48], [0, 0, 1]], np.float32)


@pytest.fixture(scope="module")
def jscene():
    """tests/test_euroc.py's scene, coloc_tpu's generator."""
    return jsyn.make_scene(H, W, K, seed=4)


# ------------------------------------------------------------- io/stream

def test_stream_push_pop():
    fs = stream.FrameStream(2)
    fs.push(0, np.zeros((4, 4), np.float32), timestamp=1.0)
    ts, _ = fs.pop(0, timeout=0.1)
    assert ts == 1.0
    assert fs.pop(1, timeout=0.05) is None


def test_stream_drop_oldest_when_full():
    fs = stream.FrameStream(1, maxsize=2)
    for i in range(5):
        fs.push(0, np.full((2, 2), i, np.float32), timestamp=float(i))
    assert fs.pop(0, timeout=0.1)[0] == 3.0  # 0..2 dropped


def test_stream_approximate_sync():
    fs = stream.FrameStream(2)
    sync = stream.ApproximateTimeSync(fs, 0, 1, slop=0.05)
    # drone 0's frame at t=0 has no partner (drone 1 at 0.2): dropped
    fs.push(0, np.zeros((2, 2), np.float32), timestamp=0.0)
    fs.push(0, np.ones((2, 2), np.float32), timestamp=0.21)
    fs.push(1, np.full((2, 2), 2, np.float32), timestamp=0.2)
    pair = sync.next_pair(timeout=0.5)
    assert pair is not None
    (ta, ia), (tb, _) = pair
    assert abs(ta - tb) <= 0.05 and ia[0, 0] == 1.0


def test_stream_live_feed_thread():
    fs = stream.FrameStream(1)

    def producer():
        for i in range(5):
            fs.push(0, np.full((2, 2), i, np.float32))
            time.sleep(0.005)

    t = threading.Thread(target=producer)
    t.start()
    got = []
    for _ in range(5):
        item = fs.pop(0, timeout=1.0)
        if item:
            got.append(int(item[1][0, 0]))
    t.join()
    assert got == [0, 1, 2, 3, 4]


def test_stream_interface_detects_on_the_session():
    """process_image_single / process_image_pair give the port session's
    detect of the popped frames, exactly; the frame counter counts."""
    sess = plumbing_cases.session(2)
    img = plumbing_cases.frame()
    fs = stream.FrameStream(2)
    iface = stream.StreamInterface(sess, fs)
    assert iface.process_image_single(0, timeout=0.05) is None
    ref = sess.detect(img)
    fs.push(0, img, timestamp=1.0)
    got = iface.process_image_single(0, timeout=1.0)
    assert all(torch.equal(a, b) for a, b in zip(got, ref)) and iface.frame_number == 1
    fs.push(0, img, timestamp=2.0)
    fs.push(1, img[:, ::-1].copy(), timestamp=2.01)
    fa, fb = iface.process_image_pair(0, 1, timeout=1.0)
    assert all(torch.equal(a, b) for a, b in zip(fa, ref))
    assert all(torch.equal(a, b) for a, b in zip(fb, sess.detect(img[:, ::-1].copy())))
    assert iface.frame_number == 2


# --------------------------------------------------------------- EuRoC

def _assert_same_dataset(ours, ref):
    """Reader outputs equal exactly: frames (dict of lists), K, dist, size
    and, where present, the timestamps / indices."""
    assert len(ours) == len(ref)
    for d in ref[0]:
        assert len(ours[0][d]) == len(ref[0][d])
        for a, b in zip(ours[0][d], ref[0][d]):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    for a, b in zip(ours[1:], ref[1:]):
        if isinstance(b, dict):
            assert a == b
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            assert np.asarray(a).dtype == np.asarray(b).dtype


def test_euroc_two_sequences_equal_reference(tmp_path, jscene):
    """Nearest-timestamp alignment of drone 1's clock (offset 20 ms): K,
    dist (radial terms kept, tangential dropped), size, frames and stamps
    equal coloc_tpu's reader exactly."""
    roots = [str(tmp_path / "seq0"), str(tmp_path / "seq1")]
    write_euroc(roots[0], 1_000_000_000, 5, jscene, 0)
    write_euroc(roots[1], 1_020_000_000, 5, jscene, 1)
    for kw in (dict(num_frames=4), dict(num_frames=0, stride=2, with_timestamps=True)):
        ours = euroc.load_dataset(roots, **kw)
        _assert_same_dataset(ours, jeuroc.load_dataset(roots, **kw))
    frames, Ks, dists, size = euroc.load_dataset(roots, num_frames=4)
    assert size == (W, H) and Ks.shape == (2, 3, 3)
    np.testing.assert_allclose(dists[0], [-0.28, 0.07, 0.0], atol=1e-6)
    assert not np.array_equal(frames[0][0], frames[1][0])
    assert euroc.list_frames(roots[1]) == jeuroc.list_frames(roots[1])
    yaml = os.path.join(roots[0], "mav0", "cam0", "sensor.yaml")
    for a, b in zip(euroc.read_sensor_yaml(yaml), jeuroc.read_sensor_yaml(yaml)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_euroc_sensor_yaml_missing_key(tmp_path):
    p = tmp_path / "sensor.yaml"
    p.write_text("sensor_type: camera\n")
    with pytest.raises(ValueError):
        euroc.read_sensor_yaml(str(p))


def test_euroc_groundtruth_equal_reference(tmp_path, jscene):
    """The ASL ground-truth csv and its nearest-timestamp association:
    exactly coloc_tpu's arrays; positions within 1e-9 of the written
    rows."""
    root = str(tmp_path / "seq0")
    write_euroc(root, 1_000_000_000, 4, jscene, 0)
    assert euroc.load_groundtruth(root) is None
    gt_dir = os.path.join(root, "mav0", "state_groundtruth_estimate0")
    os.makedirs(gt_dir)
    with open(os.path.join(gt_dir, "data.csv"), "w") as f:
        f.write("#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m], q_RS_w []\n")
        for i in range(40):
            f.write(f"{995_000_000 + i * 5_000_000},{0.1 * i},{0.2 * i},{-0.05 * i},"
                    "1.0,0.0,0.0,0.0\n")
    (ts, pos), (jts, jpos) = euroc.load_groundtruth(root), jeuroc.load_groundtruth(root)
    np.testing.assert_array_equal(ts, jts)
    np.testing.assert_array_equal(pos, jpos)
    _, _, _, _, stamps = euroc.load_dataset([root], num_frames=3, with_timestamps=True)
    at = euroc.groundtruth_at(ts, pos, stamps[0])
    np.testing.assert_allclose(at, jeuroc.groundtruth_at(jts, jpos, stamps[0]), atol=1e-9)
    np.testing.assert_allclose(at[0], [0.1, 0.2, -0.05], atol=1e-9)


# --------------------------------------------------------------- KITTI

def test_kitti_calib_frames_times_equal_reference(tmp_path, jscene):
    seq = write_kitti(str(tmp_path), "00", 5, jscene, 0)
    for cam in ("image_0", "image_1"):
        for a, b in zip(kitti.read_calib(seq, cam), jkitti.read_calib(seq, cam)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(kitti.read_calib(seq)[0], K, atol=1e-4)
    assert kitti.list_frames(seq) == jkitti.list_frames(seq)
    assert [i for i, _ in kitti.list_frames(seq)] == list(range(5))
    np.testing.assert_array_equal(kitti.read_times(seq), jkitti.read_times(seq))
    with pytest.raises(FileNotFoundError):
        kitti.read_calib(str(tmp_path))


def test_kitti_two_sequences_equal_reference(tmp_path, jscene):
    """Index alignment truncated to the shorter sequence, with stride:
    frames, K, dist, size and indices equal coloc_tpu's exactly."""
    s0 = write_kitti(str(tmp_path), "00", 5, jscene, 0)
    s1 = write_kitti(str(tmp_path), "01", 7, jscene, 1)
    for kw in (dict(num_frames=4, with_indices=True), dict(stride=2, with_indices=True),
               dict(num_frames=2)):
        _assert_same_dataset(kitti.load_dataset([s0, s1], **kw),
                             jkitti.load_dataset([s0, s1], **kw))
    frames, _, _, size, idx = kitti.load_dataset([s0, s1], num_frames=4, with_indices=True)
    assert size == (W, H) and idx[0] == idx[1] == [0, 1, 2, 3]
    assert not np.array_equal(frames[0][0], frames[1][0])


def test_kitti_groundtruth_equal_reference(tmp_path, jscene):
    seq = write_kitti(str(tmp_path), "03", 4, jscene, 0, with_poses=False)
    assert kitti.load_groundtruth(seq) is None
    seq = write_kitti(str(tmp_path / "gt"), "03", 4, jscene, 0)
    (idx, pos), (jidx, jpos) = kitti.load_groundtruth(seq), jkitti.load_groundtruth(seq)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(pos, jpos)
    _, Cs = jsyn.trajectory(4, 0)
    np.testing.assert_allclose(pos, Cs, atol=1e-6)
    at = kitti.groundtruth_at(idx, pos, [1, 3, 99])
    np.testing.assert_allclose(at, jkitti.groundtruth_at(jidx, jpos, [1, 3, 99]), atol=1e-9)
    np.testing.assert_allclose(at[2], Cs[3], atol=1e-6)
    # a poses.txt inside the sequence directory is read too
    inner = write_kitti(str(tmp_path / "in"), "04", 3, jscene, 0, with_poses=False)
    Rs, Cs = jsyn.trajectory(3, 0)
    with open(os.path.join(inner, "poses.txt"), "w") as f:
        for i in range(3):
            M = np.hstack([Rs[i].T, Cs[i].reshape(3, 1)])
            f.write(" ".join(f"{v:.9e}" for v in M.ravel()) + "\n")
    np.testing.assert_array_equal(kitti.load_groundtruth(inner)[1],
                                  jkitti.load_groundtruth(inner)[1])


# --------------------------------------------------- write_png / write_dataset

@pytest.mark.parametrize("shape", [(1, 1), (3, 7), (96, 128)])
def test_write_png_decodes_exactly(tmp_path, shape):
    """An 8-bit grayscale PNG that PIL (coloc_tpu.io.disk) and the port's
    native loader both decode to the array written, exactly."""
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    img.flat[0], img.flat[-1] = 0, 255
    path = str(tmp_path / "img.png")
    synthetic.write_png(path, img)
    with Image.open(path) as im:
        assert im.mode == "L" and im.size == (shape[1], shape[0])
    np.testing.assert_array_equal(jdisk.load_image(path), img.astype(np.float32))
    np.testing.assert_array_equal(native_loader.decode_image(path, *shape),
                                  img.astype(np.float32))


def test_write_dataset_against_reference(tmp_path, jscene):
    """The same scene through both packages' write_dataset: the files'
    names, the port's frames equal to its own renders truncated to uint8,
    groundtruth.npz's Cs equal and Rs within 1.2e-7 (two float32 ulps;
    measured 6e-8: the port's so3.exp rounds a few entries of drone 1's
    rotations one ulp apart from jax's). Decoded pixels equal coloc_tpu's
    exactly where the rotations agree bit for bit; elsewhere within one
    grey level on at most 0.1% of pixels (measured: none differ at this
    size, 6 of 1.5M pixels at 240x320 over 20 frames)."""
    mine, ref = tmp_path / "port", tmp_path / "ref"
    gt = synthetic.write_dataset(str(mine), jscene, 2, 3)
    jsyn.write_dataset(str(ref), jscene, 2, 3)
    assert sorted(os.listdir(mine)) == sorted(os.listdir(ref))
    g, jg = np.load(mine / "groundtruth.npz"), np.load(ref / "groundtruth.npz")
    np.testing.assert_array_equal(g["Cs"], jg["Cs"])
    np.testing.assert_allclose(g["Rs"], jg["Rs"], rtol=0, atol=1.2e-7)
    np.testing.assert_array_equal(g["Rs"], gt["Rs"])
    for d in range(2):
        for f in range(3):
            ours = jdisk.load_image(disk.frame_path(str(mine), d, f))
            np.testing.assert_array_equal(
                ours, synthetic.render(jscene, gt["Rs"][d, f], gt["Cs"][d, f])
                .astype(np.uint8).astype(np.float32))
            theirs = jdisk.load_image(disk.frame_path(str(ref), d, f))
            if np.array_equal(g["Rs"][d, f], jg["Rs"][d, f]):
                np.testing.assert_array_equal(ours, theirs)
            else:
                diff = np.abs(ours - theirs)
                assert diff.max() <= 1.0 and (diff > 0).mean() <= 1e-3


# ---------------------------------------------------------- native loader

@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """tests/test_native_loader.py's dataset, written by the port."""
    folder = str(tmp_path_factory.mktemp("native_ds"))
    K2 = np.array([[100.0, 0, 80], [0, 100.0, 60], [0, 0, 1]], np.float32)
    synthetic.write_dataset(folder, synthetic.make_scene(120, 160, K2, seed=5), 2, 3)
    return folder


def test_native_png_decode_matches_disk(dataset):
    assert native_loader.available()
    path = disk.frame_path(dataset, 0, 0)
    out = native_loader.decode_image(path, 120, 160)
    assert out is not None and out.dtype == np.float32
    np.testing.assert_array_equal(out, disk.load_image(path))
    np.testing.assert_array_equal(out, jdisk.load_image(path))
    assert native_loader.decode_image(path, 60, 80) is None  # wrong size


def test_native_prefetch_loader_all_frames(dataset):
    with native_loader.NativeLoader(dataset, 2, 3, 120, 160) as loader:
        for f in range(3):
            for d in range(2):
                np.testing.assert_array_equal(loader.get(d, f),
                                              disk.load_frame(dataset, d, f))


def test_native_random_access(dataset):
    with native_loader.NativeLoader(dataset, 2, 3, 120, 160) as loader:
        np.testing.assert_array_equal(loader.get(1, 2), disk.load_frame(dataset, 1, 2))
        np.testing.assert_array_equal(loader.get(0, 0), disk.load_frame(dataset, 0, 0))


def test_native_missing_file_errors(dataset):
    with native_loader.NativeLoader(dataset, 2, 10, 120, 160) as loader:
        assert loader.get(0, 0).shape == (120, 160)
        with pytest.raises(IOError):
            loader.get(0, 7)
