"""The port's command-line entry points on the CPU: `cli.main` with --cpu
on a synthetic dataset (write_dataset + the native loader), on a folder
and calib.txt through io/disk, and on EuRoC and KITTI sequences with
ground truth (tests/test_euroc.py's and tests/test_kitti.py's runpaths),
printing ATE and writing the logs; the option rules; and the device rule
of all three entry points (cli, serve, distributed): with no CUDA device
and no --cpu they raise before doing any work.
"""

import os

import numpy as np
import pytest
import torch

from coloc_tpu.io import synthetic as jsyn

from coloc_tpu_torch import cli, distributed, serve
from coloc_tpu_torch.io import disk, native_loader, synthetic

from test_euroc import _write_sequence as write_euroc
from test_kitti import _write_sequence as write_kitti
from port_harness import one_torch_thread, time_limit  # noqa: F401

H, W = 96, 128
K = np.array([[100.0, 0, 64], [0, 101.0, 48], [0, 0, 1]], np.float32)
SMALL = ["--maxkp", "256", "--fast-threshold", "10", "--inter-every", "0", "--cpu"]
LOGS = ("poses.txt", "poses_filtered.txt", "mahalanobis.txt", "map.ply")


def test_cli_synthetic_on_the_cpu(tmp_path, capsys):
    """--synthetic writes the dataset (PNG frames and groundtruth.npz), the
    native loader reads it, every frame after the bootstrap localizes, the
    logs are written; --publish 0 starts a broker for the poses."""
    out, folder = tmp_path / "out", tmp_path / "synth"
    assert cli.main(["--synthetic", "--frames", "3", "--folder", str(folder), "--out",
                     str(out), "--publish", "0", *SMALL]) == 0
    text = capsys.readouterr().out
    assert "session on cpu" in text and "frames: native loader" in text
    assert "transport: broker on 127.0.0.1:" in text
    line = [ln for ln in text.splitlines() if ln.startswith("processed")][0]
    n = int(line.split()[1])
    assert n == 4 and f"{n}/{n} localized" in line
    assert (folder / "groundtruth.npz").is_file() and (folder / "img__Quad1_0002.png").is_file()
    for name in LOGS:
        assert (out / name).is_file(), name
    assert len((out / "poses.txt").read_text().splitlines()) == 1 + n


def test_cli_folder_and_calib_through_disk(tmp_path, capsys, monkeypatch):
    """--folder / --calib with the native loader unavailable: the frames
    come from io/disk, and the command says so."""
    folder = tmp_path / "data"
    synthetic.write_dataset(str(folder), synthetic.make_scene(H, W, K, seed=4), 2, 3)
    disk.write_calib(str(folder / "calib.txt"), (W, H), np.stack([K, K]),
                     np.zeros((2, 3), np.float32))
    monkeypatch.setattr(native_loader, "available", lambda: False)
    assert cli.main(["--folder", str(folder), "--calib", str(folder / "calib.txt"), "--out",
                     str(tmp_path / "out"), *SMALL]) == 0
    text = capsys.readouterr().out
    assert "frames: io/disk" in text
    line = [ln for ln in text.splitlines() if ln.startswith("processed")][0]
    assert int(line.split()[1]) > 0


def _euroc_with_gt(tmp_path, scene):
    roots = []
    for d in range(2):
        root = str(tmp_path / f"seq{d}")
        write_euroc(root, 1_000_000_000, 6, scene, d, dist="[0.0, 0.0, 0.0, 0.0]")
        _, Cs = jsyn.trajectory(6, d)
        gt_dir = os.path.join(root, "mav0", "state_groundtruth_estimate0")
        os.makedirs(gt_dir)
        with open(os.path.join(gt_dir, "data.csv"), "w") as f:
            f.write("#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m], q_RS_w []\n")
            for i in range(6):
                f.write(f"{1_000_000_000 + i * 50_000_000},{Cs[i][0]},{Cs[i][1]},{Cs[i][2]},"
                        "1,0,0,0\n")
        roots.append(root)
    return roots


@pytest.mark.parametrize("dataset", ["euroc", "kitti"])
def test_cli_dataset_with_groundtruth_reports_ate(tmp_path, capsys, dataset):
    """--euroc / --kitti: two mock sequences with ground truth, the session
    runs, and each drone's ATE / RPE line prints; the logs are written."""
    scene = jsyn.make_scene(H, W, K, seed=4)
    if dataset == "euroc":
        roots = _euroc_with_gt(tmp_path, scene)
    else:
        roots = [write_kitti(str(tmp_path), f"{d:02d}", 6, scene, d) for d in range(2)]
    out = tmp_path / "run_out"
    assert cli.main([f"--{dataset}", *roots, "--out", str(out), *SMALL]) == 0
    text = capsys.readouterr().out
    assert f"loaded 2 {'EuRoC' if dataset == 'euroc' else 'KITTI'} sequences" in text
    assert "ATE=" in text, text
    assert "drone 0:" in text and "drone 1:" in text
    for name in LOGS:
        assert (out / name).is_file(), name


def test_cli_option_rules():
    """--euroc and --kitti together are an error; --folder needs --calib;
    the defaults are coloc_tpu's (FAST 40, --maxkp 1024, inter_every 10)."""
    with pytest.raises(SystemExit):
        cli.main(["--euroc", "a", "--kitti", "b"])
    with pytest.raises(SystemExit):
        cli.main(["--folder", "x", "--cpu"])
    args = cli._parser().parse_args([])
    assert (args.fast_threshold, args.maxkp, args.inter_every, args.model, args.drones) == \
        (40, 1024, 10, "E", 2)


@pytest.mark.parametrize("entry", ["cli", "serve", "distributed"])
def test_entry_points_raise_without_a_card_or_cpu(tmp_path, monkeypatch, entry):
    """With no CUDA device and no --cpu, each entry point raises before it
    reads, writes or binds anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {
        "cli": (cli.main, ["--synthetic", "--frames", "2", "--folder", str(tmp_path / "s"),
                           "--out", str(tmp_path / "o")]),
        "serve": (serve.main, ["--map", "m.npz", "--calib", "c.txt", "--publish", "1"]),
        "distributed": (distributed.main, ["--drone", "0", "--peers", "1", "--map", "m.npz",
                                           "--calib", "c.txt", "--folder", "f", "--broker",
                                           "1"]),
    }
    fn, args = argv[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn(args)
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("entry", ["ServeRunner", "DronePeer"])
def test_runtime_classes_default_to_the_card(monkeypatch, entry):
    """device None means cuda:0: with no CUDA device the runner and the
    peer raise rather than run on the CPU (and subscribe to nothing);
    device="cpu" is the caller's explicit choice."""
    import plumbing_cases as pc

    from coloc_tpu_torch import convert

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mapdb = convert.mapdb_from_numpy(pc.map_arrays(), "cpu")

    class Node:
        def __init__(self):
            self.topics = []

        def subscribe(self, topic, depth=16):
            self.topics.append(topic)

    make = {
        "ServeRunner": lambda node, **kw: serve.ServeRunner(
            mapdb, pc.config(1), pc.K, np.zeros(3), node, 2, **kw),
        "DronePeer": lambda node, **kw: distributed.DronePeer(
            0, pc.config(2), pc.K, np.zeros(3), mapdb, node, peers=[1], **kw),
    }[entry]
    node = Node()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make(node)
    assert node.topics == []
    obj = make(node, device="cpu")
    assert obj.device == torch.device("cpu") and len(node.topics) in (1, 2)
