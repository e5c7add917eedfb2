"""Training loop — python/selfplay/synchronous_loop.sh equivalent, plus
the reference's asynchronous production mode (SelfplayTraining.md
"asynchronous training": selfplay and the learner run concurrently over
the shared directory tree); port of katago_tpu/cli/loop_cmd.py.

Directory tree (SelfplayTraining.md:4-10):

  base/
    models/            accepted nets (selfplay reads newest)
    test-models/       candidates awaiting gatekeeping
    rejected-models/
    selfplay/          npz + sgf shards per model
    shuffleddata/      training shards
    ckpts/             learner state

Every stage is restart-elastic: each reads its inputs from directories and
can resume after being killed, as in the reference ("safe if killed at any
point").

-mode async runs the selfplay generator in a background thread that
keeps producing data with the newest accepted net (switching nets
mid-stream via the models-dir poll) while the main thread cycles
shuffle -> train -> gatekeeper. The coupling is only through the
filesystem, like the reference's multi-process fleet; a thread suffices
in-process because torch releases the GIL in its kernels. Both threads
share one device; each stage makes its own torch.Generator from its seed,
so the threads draw from no common generator.

Both modes hold the SIGINT/SIGTERM drain handler in a `with` block, so
it is restored when a stage raises.

Usage: python -m katago_torch.cli.loop_cmd -base-dir D [-cycles 1]
         [-size 7] [-config b2c16] [-games-per-cycle 16] [-visits 32]
         [-train-steps 50] [-batch-size 64] [-lr 3e-4] [-gate-games 8]
         [-max-moves N] [-mode sync|async] [-device cpu]

Runs on CUDA unless `-device cpu` is given; with no CUDA device and no
-device it raises.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import threading
import time

from katago_torch.cli.gatekeeper_cmd import run_gatekeeper
from katago_torch.cli.selfplay_cmd import run_selfplay
from katago_torch.cli.train_cmd import run_training
from katago_torch.device import resolve_device
from katago_torch.train.shuffle import shuffle_npz_files
from katago_torch.utils.signals import GracefulShutdown

DIRS = ("models", "test-models", "rejected-models", "selfplay",
        "shuffleddata", "ckpts")


def _make_dirs(base_dir: str) -> dict:
    dirs = {name: os.path.join(base_dir, name) for name in DIRS}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    return dirs


def _selfplay_shards(dirs: dict) -> list[str]:
    """The finished selfplay shards: not the `.tmp.npz` a running
    selfplay writes before renaming it (async mode reads while it runs)."""
    return sorted(p for p in glob.glob(os.path.join(
        dirs["selfplay"], "*", "tdata", "*.npz"))
        if not p.endswith(".tmp.npz"))


def _shuffle(shards: list[str], dirs: dict, cycle: int) -> str:
    """Shuffle the selfplay shards into this cycle's training directory;
    raises ValueError when the window holds no row."""
    out_dir = os.path.join(dirs["shuffleddata"], f"c{cycle:04d}")
    out_shards = shuffle_npz_files(shards, out_dir, seed=cycle)
    if not out_shards:
        raise ValueError(
            f"cycle {cycle}: the shuffle window of {len(shards)} selfplay "
            f"shards holds no rows; nothing written to {out_dir}")
    return out_dir


def run_loop(base_dir: str, *, cycles: int, size: int, config_name: str,
             games_per_cycle: int, visits: int, train_steps: int,
             batch_size: int, lr: float, gate_games: int, seed: int = 0,
             max_moves: int | None = None, device=None,
             log=print) -> list[dict]:
    """`cycles` cycles of selfplay -> shuffle -> train -> gatekeeper.
    max_moves cuts every selfplay game and gate match (default: about 1.6
    moves per point)."""
    dev = resolve_device(device)
    dirs = _make_dirs(base_dir)
    summary = []
    with GracefulShutdown(log) as stop_ctx:
        for cycle in range(cycles):
            if stop_ctx.requested:
                log("loop: drain requested, stopping before next cycle")
                break
            log(f"=== cycle {cycle} ===")
            sp_stats = run_selfplay(
                dirs["selfplay"], dirs["models"], size=size,
                games_per_batch=games_per_cycle, visits=visits,
                max_batches=1, config_name=config_name,
                seed=seed * 1000 + cycle, data_quality="test",
                max_moves=max_moves, device=dev, log=log)

            shards = _selfplay_shards(dirs)
            out_dir = _shuffle(shards, dirs, cycle)
            log(f"shuffled {len(shards)} shards -> "
                f"{len(glob.glob(os.path.join(out_dir, '*.npz')))}")

            tr_stats = run_training(
                out_dir, dirs["ckpts"], dirs["test-models"], size=size,
                config_name=config_name, batch_size=batch_size,
                steps=train_steps, lr=lr, seed=seed, device=dev, log=log)

            gk = run_gatekeeper(
                dirs["test-models"], dirs["models"], dirs["rejected-models"],
                size=size, config_name=config_name, games=gate_games,
                visits=visits, seed=cycle, max_moves=max_moves, device=dev,
                log=log)

            summary.append({"cycle": cycle, "selfplay": sp_stats,
                            "train": tr_stats, "gatekeeper": gk})
    return summary


def run_loop_async(base_dir: str, *, cycles: int, size: int,
                   config_name: str, games_per_cycle: int, visits: int,
                   train_steps: int, batch_size: int, lr: float,
                   gate_games: int, seed: int = 0,
                   max_moves: int | None = None, device=None,
                   log=print) -> list[dict]:
    """Asynchronous mode: a producer thread generates selfplay data
    continuously (mid-stream net switching) while the main thread cycles
    shuffle -> train -> gatekeeper until `cycles` training cycles ran."""
    dev = resolve_device(device)
    dirs = _make_dirs(base_dir)
    stop = threading.Event()
    sp_totals: dict = {}

    def producer():
        batch_i = 0
        while not stop.is_set():
            stats = run_selfplay(
                dirs["selfplay"], dirs["models"], size=size,
                games_per_batch=games_per_cycle, visits=visits,
                max_batches=1, config_name=config_name,
                seed=seed * 1000 + batch_i, data_quality="test",
                switch_nets=True, max_moves=max_moves, device=dev,
                log=lambda *a: None)
            for k, v in stats.items():
                sp_totals[k] = sp_totals.get(k, 0) + v
            batch_i += 1

    t = threading.Thread(target=producer, daemon=True)
    summary = []
    with GracefulShutdown(log) as stop_ctx:
        t.start()
        try:
            for cycle in range(cycles):
                if stop_ctx.requested:
                    log("loop: drain requested")
                    break
                # wait for fresh data beyond what we already trained on
                shards = []
                while not stop_ctx.requested:
                    shards = _selfplay_shards(dirs)
                    if len(shards) > cycle:
                        break
                    if not t.is_alive():
                        raise RuntimeError("loop: the selfplay producer "
                                           "stopped before writing data")
                    time.sleep(0.5)
                if not shards:
                    break
                log(f"=== async cycle {cycle}: {len(shards)} shards ===")
                out_dir = _shuffle(shards, dirs, cycle)
                tr_stats = run_training(
                    out_dir, dirs["ckpts"], dirs["test-models"], size=size,
                    config_name=config_name, batch_size=batch_size,
                    steps=train_steps, lr=lr, seed=seed, device=dev,
                    log=log)
                gk = run_gatekeeper(
                    dirs["test-models"], dirs["models"],
                    dirs["rejected-models"], size=size,
                    config_name=config_name, games=gate_games,
                    visits=visits, seed=cycle, max_moves=max_moves,
                    device=dev, log=log)
                summary.append({"cycle": cycle, "train": tr_stats,
                                "gatekeeper": gk})
        finally:
            stop.set()
            t.join(timeout=600)
    summary.append({"selfplay_totals": sp_totals})
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-base-dir", required=True)
    ap.add_argument("-cycles", type=int, default=1)
    ap.add_argument("-size", type=int, default=7)
    ap.add_argument("-config", default="b2c16")
    ap.add_argument("-games-per-cycle", type=int, default=16)
    ap.add_argument("-visits", type=int, default=32)
    ap.add_argument("-train-steps", type=int, default=50)
    ap.add_argument("-batch-size", type=int, default=64)
    ap.add_argument("-lr", type=float, default=3e-4)
    ap.add_argument("-gate-games", type=int, default=8)
    ap.add_argument("-max-moves", type=int, default=None,
                    help="cut every selfplay game and gate match after "
                         "this many moves")
    ap.add_argument("-mode", default="sync", choices=["sync", "async"],
                    help="async = selfplay producer thread + concurrent "
                         "learner (SelfplayTraining.md asynchronous mode)")
    ap.add_argument("-device", default=None,
                    help="torch device (default: cuda; 'cpu' to run on "
                         "the CPU)")
    args = ap.parse_args(argv)
    fn = run_loop if args.mode == "sync" else run_loop_async
    out = fn(args.base_dir, cycles=args.cycles, size=args.size,
             config_name=args.config,
             games_per_cycle=args.games_per_cycle, visits=args.visits,
             train_steps=args.train_steps, batch_size=args.batch_size,
             lr=args.lr, gate_games=args.gate_games,
             max_moves=args.max_moves, device=args.device)
    print(json.dumps(out, default=str)[:2000])


if __name__ == "__main__":
    main()
