"""Profile a window of playout steps late in one search of the PyTorch
port, at the selfplay shape chip_smoke.py drives (19x19, b18c384nbt,
bf16, 128 games, ladder planes on) on one CUDA device.

    python3 tools/profile_torch_search.py [--visits 600] [--rows 25]

Runs the search's first --visits minus 8 playouts without the profiler,
so the trees reach the depth of a full search, then its last 8 playout
steps under torch.profiler (CPU + CUDA activities), and prints the
wall time, the device-busy share of the wall time (summed kernel time
over wall time, an upper bound on busy time where kernels overlap), the
host syncs and kernel launches per playout step (one step = one leaf per
game), the host syncs and host time of each phase of a playout (select,
leaf state, legality, chase ladders, features, net, leaf eval,
insert/backup), and the top operators by device time and by host time.
The profiler's own overhead inflates the wall time, so take playouts/s
from chip_smoke.py; this script says where the time goes.
"""

from __future__ import annotations

import argparse
import functools
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from katago_torch.game import history as H  # noqa: E402
from katago_torch.game import ladder as LAD  # noqa: E402
from katago_torch.game import rules as R  # noqa: E402
from katago_torch.models import config as MC  # noqa: E402
from katago_torch.models import features as F  # noqa: E402
from katago_torch.models import model as M  # noqa: E402
from katago_torch.models import weights as W  # noqa: E402
from katago_torch.ops import _build  # noqa: E402
from katago_torch.search import mcts  # noqa: E402
from katago_torch.search.params import SearchParams  # noqa: E402

SIZE = 19
GAMES = 128
MODEL = "b18c384nbt"
WINDOW = 8                    # playout steps profiled, at the search's end

SYNC_KEYS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
             "cudaEventSynchronize")
LAUNCH_KEYS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
               "cuLaunchKernelEx")
# the functions one playout step calls, in order; each is wrapped in a
# profiler range named "phase: <function>"
PHASES = ((mcts, "select_path"), (mcts, "make_leaf_gamestate"),
          (H, "legal_moves"), (LAD, "ladder_map_chase_batch"),
          (F, "fill_features"), (mcts, "nn_leaf_eval"),
          (mcts, "terminal_eval"), (mcts, "insert_and_backup"))


def _in_range(fn, name):
    @functools.wraps(fn)
    def wrapped(*a, **k):
        with record_function(name):
            return fn(*a, **k)
    return wrapped


class _NetInRange(torch.nn.Module):
    """The net's forward inside a "phase: net" profiler range."""

    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, *a):
        with record_function("phase: net"):
            return self.net(*a)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--visits", type=int, default=600)
    ap.add_argument("--rows", type=int, default=25)
    args = ap.parse_args()
    if args.visits <= WINDOW:
        raise SystemExit(f"profile_torch_search: --visits must exceed "
                         f"{WINDOW}")
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_search: no CUDA device")
    dev = torch.device("cuda")
    _build.build_all()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(f"card {smi.stdout.strip()}")

    model = M.KataGoModel(MC.get_config(MODEL), SIZE, torch.bfloat16)
    model = W.init_weights(model, seed=0).to(dev).eval()
    sp = SearchParams.for_selfplay().to_arr(dev)
    for mod, name in PHASES:
        setattr(mod, name, _in_range(getattr(mod, name), f"phase: {name}"))
    net = _NetInRange(model)
    roots = H.new_game(SIZE, R.Rules.tromp_taylorish(), 160, g=GAMES,
                       device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    playouts = functools.partial(mcts.run_playouts, net, size=SIZE,
                                 max_visits=args.visits + 1)
    with torch.no_grad():
        ss = mcts.init_search(net, roots, sp, gen, size=SIZE,
                              max_nodes=args.visits + 3)
        t0 = time.time()
        playouts(ss, sp, gen, num_sims=args.visits - WINDOW)
        torch.cuda.synchronize()
        print(f"unprofiled: {args.visits - WINDOW} playout steps in "
              f"{time.time() - t0:.2f} s; tree nodes per game "
              f"{int(ss.tree.num_nodes.float().mean())} (mean)")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            playouts(ss, sp, gen, num_sims=WINDOW)
            torch.cuda.synchronize()
            wall = time.time() - t0
    rv = ss.tree.visits[:, 0]
    print(f"root visits {int(rv.min())}..{int(rv.max())} (a playout voided "
          f"by superko is not topped up here)")
    events = prof.key_averages()
    steps = WINDOW
    syncs = sum(e.count for e in events if e.key in SYNC_KEYS)
    kernel_launches = sum(e.count for e in events if e.key in LAUNCH_KEYS)
    print(f"window: {GAMES} games, playout steps {args.visits - WINDOW + 1}"
          f"-{args.visits} of a {args.visits}-visit search; wall under the "
          f"profiler {wall:.3f} s ({wall / steps * 1e3:.1f} ms per playout "
          f"step)")
    dev_us = sum(e.self_device_time_total for e in events
                 if getattr(e, "device_type", None) == DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False))
    print(f"device {torch.cuda.get_device_name(0)}: summed kernel time "
          f"{dev_us / 1e6:.3f} s = {100 * dev_us / 1e6 / wall:.1f}% of "
          f"wall ({dev_us / 1e3 / steps:.2f} ms per playout step)")
    print(f"host syncs {syncs} ({syncs / steps:.1f} per playout step); "
          f"kernel launches {kernel_launches} "
          f"({kernel_launches / steps:.0f} per playout step)")
    by_phase = {}
    for e in prof.events():
        if e.name not in SYNC_KEYS:
            continue
        p = e.cpu_parent
        while p is not None and not p.name.startswith("phase: "):
            p = p.cpu_parent
        where = p.name[7:] if p is not None else "search loop"
        by_phase[where] = by_phase.get(where, 0) + 1
    print("host syncs per playout step by phase: " + ", ".join(
        f"{k} {v / steps:.1f}" for k, v in
        sorted(by_phase.items(), key=lambda kv: -kv[1])))
    print(events.table(sort_by="self_device_time_total",
                       row_limit=args.rows))
    print("host ms per playout step by phase (each inclusive of the calls "
          "inside it):")
    host_ranges = (e for e in events if e.key.startswith("phase: ")
                   and getattr(e, "device_type", None) == DeviceType.CPU)
    for e in sorted(host_ranges, key=lambda e: -e.cpu_time_total):
        print(f"  {e.key[7:]:<24} {e.cpu_time_total / 1e3 / steps:9.2f} ms "
              f"({e.count} calls)")
    print(events.table(sort_by="self_cpu_time_total", row_limit=args.rows))

if __name__ == "__main__":
    main()
