"""The readings that the limits of `correct` are set from: for each seed,
one run of the cell (set-up, window, check) and then its control and,
for a training cell, its faults, each compared with the reference as the
program is. The benchmark's own runs never run this.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3
                                 --seconds <s>

Prints one JSON line per seed: the program's compared numbers under
"program", and the traffic module's control(...) readings.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    spec = importlib.util.spec_from_file_location("portbench_run",
                                                  HERE / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    sys.path.insert(0, str(run.ROOT))
    workload = run.load_json(HERE / "workloads" / f"{args.workload}.json")
    cfg = run.load_json(HERE / "configs" / f"{workload['config']}.json")
    traffic = run.load_module(HERE / "traffic" / f"{workload['traffic']}.py",
                              "portbench_traffic_" + workload["traffic"])
    for seed in (int(s) for s in args.seeds.split(",")):
        ns = argparse.Namespace(seed=seed, seconds=args.seconds, trace=0)
        ctx = run.Context(ns, workload, cfg)
        st = traffic.setup(ctx)
        result = traffic.window(st, ctx)
        checks = traffic.judge(st, ctx)
        line = {"seed": seed, "attempted": result["attempted"],
                "program": {n: v for n, v, _ in checks}}
        line.update(traffic.control(st, ctx))
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
