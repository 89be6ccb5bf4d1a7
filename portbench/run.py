"""Run one cell of the benchmark and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration and its traffic mix are read from
BENCHMARK.json at the checkout's root; the mix names its driver under
`drivers/`, each per-layer metric is read by `metrics/<name>.py`, and the
cell's limits are `limits/<cell>.json`. Set-up (inputs made on the card
from the seed, the program's kernels built or loaded, every shape warmed
up) ends at the first timed request. The window then sends requests back
to back for --seconds, each timed from its call to its outputs on the
host. With --trace 1 the run also counts in the window, times the
layers' spans and profiles a few more requests. Then the program's state
is freed and the plain reference judges, stage by stage, what the window
produced (portbench/reference/judge.py). The last stdout line is one JSON
object; the numbers compared, each beside its limit, are the last lines
of stderr.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

from portbench import common  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "coloc_tpu")


def cell_files(name: str):
    """BENCHMARK.json and the cell's entry, configuration and traffic mix."""
    bench = common.load_json(common.REPO / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return (bench, cell, common.load_json(common.REPO / conf["file"]),
            common.load_json(common.ROOT / "traffic" / f"{cell['traffic']}.json"))


def make_cell(cfg: dict, traffic: dict, seed: int, device):
    driver = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    return driver.Cell(cfg, traffic, seed, device)


def window(cell, seconds: float):
    """Requests back to back for `seconds` -> (outputs, latencies s, the
    window's length s)."""
    outs, lat = [], []
    t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        outs.append(cell.request())
        end = time.perf_counter()
        lat.append(end - t)
        if end - t0 >= seconds:
            return outs, lat, end - t0


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def reader(name: str):
    """The per-layer metric `name`'s reader, metrics/<name>.py."""
    path = common.ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def per_layer(bench: dict, name: str) -> List[dict]:
    """The per-layer metrics the cell reports: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def end_to_end(bench: dict, name: str) -> List[dict]:
    return [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]


def check_lines(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    return {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}


def passes(checks: Dict[str, dict]) -> bool:
    return all(c["limit"] is not None and c["value"] <= c["limit"] for c in checks.values())


def _on_card(device) -> bool:
    return device.type == "cuda"


def measure(bench: dict, name: str, cell, seconds: float, trace_on: bool,
            t_start: float) -> dict:
    """The cell's window (and traced requests), then the check -> the
    result line's object. On the CPU (the tests) the device's numbers
    read 0."""
    import torch

    from portbench import trace

    card = _on_card(cell.device)
    if card:
        torch.cuda.synchronize()
    setup_peak = torch.cuda.max_memory_allocated() if card else 0
    if card:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    # set-up's objects leave the collector's generations, so that a full
    # collection in the window does not walk them
    gc.collect()
    gc.freeze()
    cell.window_started()
    outs, lat, window_s = window(cell, seconds)
    window_peak = torch.cuda.max_memory_allocated() if card else 0
    p95_ms = 1e3 * (statistics.quantiles(lat, n=20)[18] if len(lat) >= 2 else lat[0])
    work = cell.counters()          # what the window's requests cost the program
    ctx = {"frames": 0, "counters": {}, "spans": {}, "bounds": {}, "trace": None,
           "window_peak_bytes": window_peak, "latency_ms_p95": p95_ms}
    if trace_on:
        ctx["counters"] = work
        ctx["spans"] = cell.spans()
        traces: list = []
        with trace.traced(traces, card):
            n = cell.traced_requests()
            outs += [cell.request() for _ in range(n)]
        ctx["trace"] = traces[0]
        ctx["frames"] = n * cell.frames_per_request
    memory_peak = max(setup_peak, window_peak,
                      torch.cuda.max_memory_allocated() if card else 0)

    attempted = len(lat) * cell.frames_per_request
    failed = attempted - sum(cell.localized(o) for o in outs[:len(lat)])
    if trace_on:
        ctx["bounds"] = {k: v * n for k, v in cell.request_bounds().items()}
    cell.release()
    limits_path = common.ROOT / "limits" / f"{name}.json"
    limits = common.load_json(limits_path) if limits_path.exists() else {}
    checks = check_lines(cell.check(outs), limits)

    if trace_on:
        metrics = {}
        for m in per_layer(bench, name):
            v = reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {"frames_per_s": (attempted - failed) / window_s,
                  "latency_ms_p95": p95_ms, "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in end_to_end(bench, name) if m["name"] in values}
    device_info = {"platform": "gpu" if card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if card else "cpu",
                   "count": 1, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": passes(checks), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if trace_on:
        tr = ctx["trace"]
        device_info["busy_s"] = tr.busy_s()
        device_info["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": trace.top_device_ops(tr),
                               "idle_gaps": trace.idle_gaps(tr)}
    result["checks"] = checks
    print(f"set-up {setup_s:.3f} s: imports and CUDA {setup_s - sum(cell.laps.laps.values()):.3f}"
          f" s, {cell.laps}", file=sys.stderr)
    slow = max(range(len(lat)), key=lat.__getitem__)
    print(f"window: {len(lat)} requests, {window_s:.3f} s; median {1e3 * statistics.median(lat):.2f}"
          f" ms, slowest {1e3 * lat[slow]:.2f} ms (request {slow}); work: {work}",
          file=sys.stderr)
    return result


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench, entry, cfg, traffic = cell_files(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"needs {entry['chips']} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    cell = make_cell(cfg, traffic, args.seed, torch.device("cuda", 0))
    result = measure(bench, args.workload, cell, args.seconds, bool(args.trace), T_START)
    found = forbidden_modules()
    if found:
        print(f"the process holds {', '.join(found)} after the window: no result",
              file=sys.stderr)
        return 4
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
