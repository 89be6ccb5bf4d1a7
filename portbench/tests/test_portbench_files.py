"""BENCHMARK.json and the files each cell is found by."""

from __future__ import annotations

import importlib
import json
import re
import shutil
import subprocess
import sys

import pytest

from portbench import common, run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def test_benchmark_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"] and 1 <= bench["run_seconds"] <= 51
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("portbench/")
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and len(w["why"]) <= 200 and w["chips"] == 1
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert "setup_s" in names
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and set(m) <= {"name", "unit", "better", "source", "layer",
                                                 "moves", "workloads"}


@pytest.mark.parametrize("cell", [w["name"] for w in common.load_json(
    common.REPO / "BENCHMARK.json")["workloads"]])
def test_cell_resolves(bench, cell):
    """Each cell finds its configuration, traffic mix, driver, limits and
    the readers of its per-layer metrics by name."""
    _, entry, cfg, traffic = run.cell_files(cell)
    assert cfg["name"] == entry["config"]
    assert hasattr(importlib.import_module(f"portbench.drivers.{traffic['driver']}"), "Cell")
    assert (common.ROOT / "limits" / f"{cell}.json").exists()
    metrics = run.per_layer(bench, cell)
    assert metrics
    for m in metrics:
        assert callable(run.reader(m["name"]))
    assert {m["name"] for m in run.end_to_end(bench, cell)} >= {"setup_s", "frames_per_s"}


def test_new_files_found_without_edits(tmp_path):
    """A configuration, a traffic mix, a metric and a cell dropped into a
    copy are found by name, with no file of the harness edited."""
    root = tmp_path / "repo"
    shutil.copytree(common.ROOT, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = common.load_json(common.REPO / "BENCHMARK.json")
    cfg = common.load_json(common.ROOT / "configs" / "koral-752x480.json")
    cfg["name"] = "koral-b"
    (root / "portbench" / "configs" / "koral-b.json").write_text(json.dumps(cfg))
    mix = common.load_json(common.ROOT / "traffic" / "serve-b64.json")
    mix["streams"] = 8
    (root / "portbench" / "traffic" / "serve-b8.json").write_text(json.dumps(mix))
    (root / "portbench" / "metrics" / "new_metric.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    (root / "portbench" / "limits" / "koral-b-serve-b8.json").write_text("{}")
    bench["configs"].append({"name": "koral-b", "source": "x", "file":
                             "portbench/configs/koral-b.json", "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "koral-b-serve-b8", "config": "koral-b",
                               "traffic": "serve-b8", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "new_metric", "unit": "count", "better": "lower",
                               "source": "program_counter", "layer": "serving",
                               "moves": "frames_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, sys; from portbench import run;"
            "b, e, c, t = run.cell_files('koral-b-serve-b8');"
            "m = [x['name'] for x in run.per_layer(b, 'koral-b-serve-b8')];"
            "print(json.dumps([c['name'], t['streams'], 'new_metric' in m,"
            " run.reader('new_metric')({})]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, check=True).stdout
    assert json.loads(out.strip().splitlines()[-1]) == ["koral-b", 8, True, 42.0]


def test_no_card_no_result(tmp_path):
    """Without a card the command exits non-zero and prints no result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "koral-serve-b64", "--seed", "1", "--seconds", "1"],
                       cwd=common.REPO, capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_alone_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and portbench/ (no
    program), the command exits non-zero and prints no result."""
    shutil.copytree(common.ROOT, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(common.REPO / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "koral-session-d2", "--seed", "1", "--seconds", "1"],
                       cwd=tmp_path, capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout.strip() == ""
