"""Readings that a cell's limits are set from (not run by the benchmark's
own runs).

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 --seconds 5 \\
        [--control-seeds 1,2,3]

For each seed, in one process: the cell's set-up, a window of --seconds,
and the judged numbers of the program (the lower readings); for the
control seeds, also those of the control, the reference in float32 with
its products in TF32 put in the program's place and judged in the same
way (the upper readings). With --fault, the program runs with that fault of
portbench/faults.py planted: its readings are the upper readings of the
numbers that the control does not move. One JSON line a seed, then the
largest program reading and the smallest control reading of each number.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from portbench import faults, run


def readings(cell, seconds: float, control: bool):
    outs, _, _ = run.window(cell, seconds)
    cell.release()
    t0 = time.perf_counter()
    out = {"program": cell.check(outs)}
    out["check_s"] = time.perf_counter() - t0
    if control:
        out["control"] = cell.check(outs, control=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--fault", default="", help="a fault of portbench/faults.py planted "
                    "in the program: its readings are upper readings")
    args = ap.parse_args(argv)
    _, _, cfg, traffic = run.cell_files(args.workload)
    dev = torch.device("cuda", 0)
    ctl_seeds = {int(s) for s in args.control_seeds.split(",") if s}
    lower, upper = {}, {}
    for s in (int(x) for x in args.seeds.split(",")):
        with faults.planted(args.fault) if args.fault else contextlib.nullcontext():
            cell = run.make_cell(cfg, traffic, s, dev)
            r = readings(cell, args.seconds, s in ctl_seeds)
        del cell
        torch.cuda.empty_cache()
        print(json.dumps({"seed": s, **r}), flush=True)
        for k, v in r["program"].items():
            lower[k] = max(lower.get(k, v), v)
        for k, v in r.get("control", {}).items():
            upper[k] = min(upper.get(k, v), v)
    print(json.dumps({"fault": args.fault, "lower": lower, "upper": upper}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
