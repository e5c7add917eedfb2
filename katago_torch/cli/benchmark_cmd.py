"""benchmark command — throughput measurement and batch-size tuning; port
of katago_tpu/cli/benchmark_cmd.py.

The reference's `katago benchmark` (cpp/command/benchmark.cpp:23-294)
sweeps numSearchThreads and prints visits/s plus an Elo-impact estimate
per setting. Here the tunable axis is the *games batch* (lockstep
searches share every NN eval), so this sweeps games-per-batch, reports
playouts/s, and estimates the Elo effect the same way the reference does:
more parallelism raises throughput but spends visits on a wider, shallower
front (benchmark.cpp computeEloEffect — here the analogue discounts by the
log-visits utilization of the batch).

Each timing is taken after torch.cuda.synchronize() on the card.
"compile_s" keeps the JAX package's key: here it is the first call at
each batch size, which also builds the CUDA kernels on their first use.
"device" names the card (torch.cuda.get_device_name) or "cpu".

Usage: python -m katago_torch.cli.benchmark_cmd [-model M] [-config b6c96]
         [-size 19] [-visits 64] [-batches 1,8,32,64] [-iters 3]
         [-no-ladders] [-train] [-device cpu]

Runs on CUDA unless `-device cpu` is given; with no CUDA device and no
-device it raises.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from katago_torch.device import resolve_device


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" \
        else dev.type


def run_benchmark(*, size: int, visits: int, batch_sizes: list[int],
                  config_name: str = "b6c96", model_path: str | None = None,
                  iters: int = 3, with_ladders: bool = True, device=None,
                  log=print) -> dict:
    """Searches of `visits` playouts on fresh boards at each games-per-
    batch; a config's net is seeded and in bfloat16 (the JAX package's
    default dtype), a .bin.gz runs as a float32 DescNet."""
    from katago_torch.cli.match_cmd import load_net
    from katago_torch.game import history as H
    from katago_torch.game import rules as R
    from katago_torch.search import mcts
    from katago_torch.search.params import SearchParams

    dev = resolve_device(device)
    net, name = load_net(model_path, config_name, size, dev,
                         dtype=torch.bfloat16)

    sp = SearchParams.for_selfplay().to_arr(dev)
    results = []
    log(f"benchmarking {name} at {size}x{size}, {visits} visits/move on "
        f"{device_name(dev)}")
    for g in batch_sizes:
        roots = H.new_game(size, R.Rules.tromp_taylorish(), 2 * size * size,
                           g=g, device=dev)
        gen = torch.Generator(device=dev).manual_seed(0)

        def search():
            with torch.no_grad():
                return mcts.run_search(net, roots, sp, gen, size=size,
                                       num_sims=visits,
                                       max_nodes=visits + 3,
                                       with_ladders=with_ladders)
        _sync(dev)
        t0 = time.time()
        search()
        _sync(dev)
        compile_s = time.time() - t0
        t0 = time.time()
        for _ in range(iters):
            search()
        _sync(dev)
        dt = (time.time() - t0) / iters
        pps = g * visits / dt
        results.append({"games_per_batch": g, "playouts_per_s": pps,
                        "s_per_search": dt, "compile_s": compile_s})
        log(f"  batch {g:4d}: {pps:10.1f} playouts/s "
            f"({dt*1000:.0f} ms/search, first call {compile_s:.1f}s)")

    # Elo-effect estimate in the spirit of benchmark.cpp:120-200: doubling
    # playouts is worth ~+120 Elo at these scales; a bigger batch helps by
    # raising throughput (more playouts per second of wall clock per game
    # when amortized over a full selfplay/match workload).
    base = results[0]["playouts_per_s"]
    for r in results:
        speedup = r["playouts_per_s"] / max(base, 1e-9)
        r["elo_effect_vs_first"] = 120.0 * np.log2(max(speedup, 1e-9))
    best = max(results, key=lambda r: r["playouts_per_s"])
    log(f"recommended games-per-batch: {best['games_per_batch']} "
        f"({best['playouts_per_s']:.0f} playouts/s, "
        f"{best['elo_effect_vs_first']:+.0f} Elo vs batch "
        f"{results[0]['games_per_batch']})")
    return {"results": results, "recommended": best["games_per_batch"],
            "device": device_name(dev)}


def run_train_benchmark(*, size: int, batch_sizes: list[int],
                        config_name: str = "b6c96", steps: int = 8,
                        device=None, log=print) -> dict:
    """Training-step throughput on synthetic reference-schema batches
    (the benchmark_fresh_model.py role): rows/s per batch size, float32
    with the port's train step (cli/train_cmd.py's)."""
    from katago_torch.cli.train_cmd import make_model
    from katago_torch.models import config as MC
    from katago_torch.train.train_step import (init_train_state,
                                               make_optimizer,
                                               make_train_step)

    dev = resolve_device(device)
    cfg = MC.get_config(config_name)
    model = make_model(size, config_name, dev)
    params = dict(model.named_parameters())
    tx = make_optimizer()
    train_step = make_train_step(model, tx)
    nn = size * size
    sb = cfg.scorebelief_len(size)
    rng = np.random.default_rng(0)
    results = []
    for b in batch_sizes:
        state = init_train_state(params, tx)
        batch = {
            "binaryInputNCHW": np.ones((b, 22, size, size), np.float32),
            "globalInputNC": np.zeros((b, 19), np.float32),
            "globalTargetsNC": rng.random((b, 80)).astype(np.float32),
            "policyTargetsNCMove": np.ones((b, 2, nn + 1), np.float32),
            "scoreDistrN": np.ones((b, sb), np.float32),
            "valueTargetsNCHW": np.zeros((b, 5, size, size), np.float32),
            "qValueTargetsNCMove": np.zeros((b, 3, nn + 1), np.float32),
        }
        batch["globalTargetsNC"][:, 25] = 1.0
        batch["globalTargetsNC"][:, 26] = 1.0
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        state, _ = train_step(state, batch)   # warm-up
        _sync(dev)
        t0 = time.time()
        for _ in range(steps):
            state, metrics = train_step(state, batch)
        _sync(dev)
        dt = (time.time() - t0) / steps
        results.append({"batch_size": b, "steps_per_s": round(1.0 / dt, 2),
                        "rows_per_s": round(b / dt, 1)})
        log(f"  train bench b={b}: {b / dt:.1f} rows/s")
    return {"train_results": results, "device": device_name(dev)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-model", default=None)
    ap.add_argument("-config", default="b6c96")
    ap.add_argument("-size", type=int, default=19)
    ap.add_argument("-visits", type=int, default=64)
    ap.add_argument("-batches", default="1,8,32,64")
    ap.add_argument("-iters", type=int, default=3)
    ap.add_argument("-no-ladders", action="store_true")
    ap.add_argument("-train", action="store_true",
                    help="benchmark the training step instead of search "
                         "(benchmark_fresh_model.py)")
    ap.add_argument("-steps", type=int, default=8,
                    help="timed steps per batch size with -train")
    ap.add_argument("-device", default=None,
                    help="torch device (default: cuda; 'cpu' to run on "
                         "the CPU)")
    args = ap.parse_args(argv)
    batches = [int(x) for x in args.batches.split(",")]
    if args.train:
        out = run_train_benchmark(size=args.size, batch_sizes=batches,
                                  config_name=args.config, steps=args.steps,
                                  device=args.device)
    else:
        out = run_benchmark(size=args.size, visits=args.visits,
                            batch_sizes=batches, config_name=args.config,
                            model_path=args.model, iters=args.iters,
                            with_ladders=not args.no_ladders,
                            device=args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
