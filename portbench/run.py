"""The port's benchmark: one run of one cell of BENCHMARK.json.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

Everything is found by name: the cell is portbench/workloads/<cell>.json,
its configuration portbench/configs/<config>.json, its traffic kind the
module portbench/traffic/<traffic>.py, and each per-layer metric the
module portbench/metrics/<metric>.py. BENCHMARK.json says which metrics a
cell reports. A traffic module provides

    setup(ctx) -> state          everything before the window
    window(state, ctx) -> dict   the timed loop, inside `with ctx.measure()`
    judge(state, ctx) -> list    (name, value, limit) after the window

and a metric module `read(r) -> float | None`, where r carries the
trace, the window's counts and the configuration.

The run prints, as the last line of its standard output, one JSON
object: correct, attempted, failed, metrics, device and, traced, the
breakdown; and, as the last lines of its standard error, each number
compared beside its limit. It exits non-zero without a result when the
card or the program is missing, or when JAX was loaded.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "katago_tpu")


def _process_start() -> float:
    """time.time() at which this process started (Linux /proc), else now."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19]) / ticks
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - (uptime - start)
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = _process_start()


def host_sample() -> tuple:
    """(wall seconds, this process's CPU seconds) for the noise look."""
    t = os.times()
    return time.time(), t.user + t.system


def host_line(a: tuple, b: tuple) -> str:
    """The window's host reading, from two host_sample()s: a process that
    gets less CPU than the wall clock runs waited on the card or on the
    host's other work."""
    return (f"window host: process cpu {b[1] - a[1]:.2f} s over "
            f"{b[0] - a[0]:.2f} s wall")


def fail(msg: str, code: int = 2):
    print(f"portbench: {msg}", file=sys.stderr)
    sys.exit(code)


def load_module(path: Path, name: str):
    if not path.is_file():
        fail(f"no file {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: Path) -> dict:
    if not path.is_file():
        fail(f"no file {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


def cell_metrics(bench: dict, cell: str):
    """The end-to-end and per-layer metric entries that `cell` reports."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if cell in m.get("workloads", [cell] if m["moves"] in names
                              else [])]
    return e2e, layer


class Context:
    """What a traffic module gets: the cell, its configuration, the seed,
    the window length, the device, and the measuring helpers."""

    def __init__(self, args, workload: dict, cfg: dict, device=None):
        import torch
        self.workload, self.cfg = workload, cfg
        self.seed, self.seconds = args.seed, args.seconds
        self.trace_on = bool(args.trace)
        self.device = torch.device(device or "cuda")
        self.tmpdir = Path(os.environ.get("TMPDIR", "/tmp"))
        self.window_start = None
        self.window_end = None
        self.trace = None
        self.counters: dict = {}

    def past_deadline(self, now: float) -> bool:
        return now - self.window_start >= self.seconds

    @contextlib.contextmanager
    def measure(self):
        """The measured window: from entry, after a synchronize, to the
        synchronize at exit; traced under the profiler with --trace 1."""
        import torch
        from portbench import trace as TR
        torch.cuda.synchronize()
        self.host = [host_sample()]
        if self.trace_on:
            with TR.traced() as holder:
                self.window_start = time.time()
                yield self
                torch.cuda.synchronize()
                self.window_end = time.time()
            self.trace = holder.trace
        else:
            self.window_start = time.time()
            yield self
            torch.cuda.synchronize()
            self.window_end = time.time()
        self.host.append(host_sample())


class Reading:
    """What a per-layer metric reads: the trace, the window's counts
    (units of work, positions evaluated, rows), the counters the traced
    run kept, and the configuration."""

    def __init__(self, ctx: Context, result: dict):
        self.trace, self.cfg = ctx.trace, ctx.cfg
        self.counts = result["counts"]
        self.counters = ctx.counters
        self.chips = ctx.workload["chips"]


def smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def main(argv=None, device=None) -> int:
    """One run; `device` replaces the card only in the CPU tests."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ["USE_FLAX"] = "0"
    cache = ROOT / ".portbench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    sys.path.insert(0, str(ROOT))

    bench = load_json(ROOT / "BENCHMARK.json")
    workload = load_json(HERE / "workloads" / f"{args.workload}.json")
    cfg = load_json(HERE / "configs" / f"{workload['config']}.json")
    traffic = load_module(HERE / "traffic" / f"{workload['traffic']}.py",
                          f"portbench_traffic_{workload['traffic']}")
    e2e, layer = cell_metrics(bench, args.workload)
    readers = {m["name"]: load_module(HERE / "metrics" / f"{m['name']}.py",
                                      "portbench_metric_"
                                      + m["name"].replace(".", "_"))
               for m in layer} if args.trace else {}

    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    if torch.cuda.device_count() < workload["chips"]:
        fail(f"the cell needs {workload['chips']} cards, "
             f"{torch.cuda.device_count()} present")
    try:
        import katago_torch  # noqa: F401  the program under test
    except ImportError as e:
        fail(f"the program is missing: {e}")
    print(f"portbench: card {smi()}; peaks bf16 989 TFLOP/s, float32 67 "
          f"TFLOP/s, HBM 3.35 TB/s (at 700 W)", file=sys.stderr)

    ctx = Context(args, workload, cfg, device)
    state = traffic.setup(ctx)
    result = traffic.window(state, ctx)
    setup_s = ctx.window_start - T_START
    window_s = ctx.window_end - ctx.window_start
    peak = max(torch.cuda.max_memory_allocated(i)
               for i in range(workload["chips"]))
    checks = traffic.judge(state, ctx)
    del state
    correct = all(v <= lim for _, v, lim in checks)
    print(f"portbench: {host_line(*ctx.host)}; torch threads "
          f"{torch.get_num_threads()}", file=sys.stderr)

    loaded = sorted({m.split(".")[0] for m in sys.modules}
                    & set(FORBIDDEN))
    if loaded:
        fail(f"the run loaded {', '.join(loaded)}")

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": workload["chips"], "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": int(result["attempted"]),
           "failed": int(result["failed"])}
    if args.trace:
        r = Reading(ctx, result)
        metrics = {}
        for m in layer:
            v = readers[m["name"]].read(r)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device["busy_s"] = ctx.trace.busy_s()
        device["window_s"] = ctx.trace.window_s
        out["breakdown"] = ctx.trace.breakdown()
    else:
        values = dict(result["e2e"], setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in e2e}
    out["metrics"] = metrics
    out["device"] = device
    out["window_s"] = window_s
    out["compared"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    for n, v, lim in checks:
        print(f"compared {n}: {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
