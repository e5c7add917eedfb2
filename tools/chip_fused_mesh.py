"""The fused actor-learner across cards against one card.

    python3 tools/chip_fused_mesh.py [--world 4]

Starts one process per card (torch.distributed over NCCL at
tcp://127.0.0.1, rank r on cuda:r). Each runs selfplay/fused.py's fused
step with a mesh: chip_smoke's fused shape (19x19, b18c384nbt in bf16,
2 moves a chunk, 32 visits) with --games-per-rank games and
--batch-per-rank learner rows on every card, at temperature 0 with no
root noise, for --steps steps (the first a warm-up, the last timed),
after the mesh's first collective (timed: it sets up NCCL). Then one
process runs the same global shape on one card (world size 1, no mesh)
from the same seeds.

Checks: every rank's replica of the ring (rows, cursor, filled) and its
parameters equal rank 0's exactly; filled and cursor equal the one-card
run's; finite losses; each rank launched K1 and K2 (on the cards).
Reports, beside the cards' name and power limit: each side's seconds
for the timed step and env-steps/s (all cards together), launches per
rank, the NCCL set-up, and how far the W-card run is from the one-card
run (the share of ring rows equal, the losses, the parameters against
the largest update): the one card searches all games in one batch, each
of the W cards its share, a bf16 net may round a batch of another size
differently, and the W cards sum their bf16 gradients in float32.

--device cpu rehearses it on the CPU with gloo (use a small --config,
--size and counts); the last line is one JSON object of the results.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import multiprocessing as mp
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

TEMPERATURE_ZERO = {"chosen_move_temperature": 0.0,
                    "chosen_move_temperature_early": 0.0}


def _device(args, rank: int) -> torch.device:
    return torch.device("cpu") if args.device == "cpu" else \
        torch.device("cuda", rank)


def _counts() -> dict:
    from katago_torch.ops import chase as K1
    from katago_torch.ops import labels as K2
    return {"chase_lanes": K1.launches, "connected_labels": K2.launches}


def _reset_counts() -> None:
    from katago_torch.ops import chase as K1
    from katago_torch.ops import labels as K2
    K1.reset_launches()
    K2.reset_launches()


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(args, world: int, rank: int, url: str | None, out: Path) -> None:
    """world ranks (world 1: no mesh) of args' global shape; this rank's
    ring, parameters, losses, seconds and launches to out."""
    from katago_torch.cli import selfplay_cmd as SP
    from katago_torch.parallel import mesh as PM
    from katago_torch.search.params import SearchParams
    from katago_torch.selfplay import fused as FU

    if args.device == "cpu":
        torch.set_num_threads(1)
    dev = _device(args, rank)
    mesh = None
    setup_s = 0.0
    if world > 1:
        mesh = PM.initialize_multihost(url, world, rank, dev)
        t0 = time.time()
        PM.all_reduce_sum([torch.zeros(1, device=dev)], mesh)
        _sync(dev)
        setup_s = time.time() - t0
    try:
        ranks = args.world
        model = SP.make_model(args.size, args.config, torch.bfloat16, dev,
                              args.seed)
        opt = torch.optim.SGD(model.parameters(), lr=1e-3, momentum=0.9)
        sp = dataclasses.replace(SearchParams.for_selfplay(),
                                 root_noise_enabled=False,
                                 **TEMPERATURE_ZERO)
        step = FU.make_fused_step(
            model, opt, size=args.size, visits=args.visits,
            batch_size=args.batch_per_rank * ranks,
            moves_per_chunk=args.moves, search_params=sp, mesh=mesh)
        games = FU.new_games(args.size, args.games_per_rank * ranks,
                             device=dev, mesh=mesh)
        ring = FU.ReplayRing.create(args.capacity, args.size, dev, mesh)
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        init = {k: v.detach().clone() for k, v in model.state_dict().items()}
        losses = []
        for _ in range(args.steps):
            _reset_counts()
            _sync(dev)
            t0 = time.time()
            games, metrics = step(games, ring, gen)
            _sync(dev)
            secs = time.time() - t0
            launches = _counts()
            losses.append(float(metrics["loss"]))
        torch.save({"ring": {k: ring.rows(k).cpu() for k in FU.RING_FIELDS},
                    "cursor": int(ring.cursor), "filled": int(ring.filled),
                    "params": {k: v.detach().cpu() for k, v in
                               model.state_dict().items()},
                    "update_max": max(
                        float((v.float() - init[k].float()).abs().max())
                        for k, v in model.state_dict().items()),
                    "losses": losses, "seconds": secs,
                    "launches": launches, "setup_s": setup_s},
                   out / f"world{world}_rank{rank}.pt")
    finally:
        if mesh is not None:
            PM.shutdown()


def _rank_main(args, rank, url, out):
    run(args, args.world, rank, url, out)


def compare(args, out: Path) -> dict:
    """The checks and the numbers of the module docstring."""
    ranks = [torch.load(out / f"world{args.world}_rank{r}.pt",
                        weights_only=True) for r in range(args.world)]
    one = torch.load(out / "world1_rank0.pt", weights_only=True)
    first = ranks[0]
    for r, res in enumerate(ranks[1:], 1):
        for k, v in first["ring"].items():
            if not torch.equal(res["ring"][k], v):
                raise AssertionError(f"rank {r}'s ring {k} differs")
        for k, v in first["params"].items():
            if not torch.equal(res["params"][k], v):
                raise AssertionError(f"rank {r}'s parameter {k} differs")
        if (res["cursor"], res["filled"]) != (first["cursor"],
                                              first["filled"]):
            raise AssertionError(f"rank {r}'s cursor or filled differs")
    if (first["cursor"], first["filled"]) != (one["cursor"], one["filled"]):
        raise AssertionError("cursor or filled differ from one card's")
    losses = [x for res in ranks + [one] for x in res["losses"]]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"losses {losses}")
    for r, res in enumerate(ranks):
        for k, n in res["launches"].items():
            # (the CPU runs the kernels' plain versions: nothing launches)
            if n <= 0 and args.device == "cuda":
                raise AssertionError(f"rank {r} launched no {k}")
    n = first["filled"]
    same = torch.ones(n, dtype=torch.bool)
    for k, v in first["ring"].items():
        same &= (v[:n] == one["ring"][k][:n]).reshape(n, -1).all(1)
    diff = max(float((one["params"][k].float() -
                      first["params"][k].float()).abs().max())
               for k in one["params"])
    env = args.games_per_rank * args.world * args.moves
    secs = max(res["seconds"] for res in ranks)
    return {
        "world": args.world, "games": args.games_per_rank * args.world,
        "visits": args.visits, "moves": args.moves,
        "batch": args.batch_per_rank * args.world,
        "seconds": {"world": secs, "one": one["seconds"]},
        "env_steps_per_s": {"world": env / secs, "one": env / one["seconds"]},
        "nccl_setup_s": max(res["setup_s"] for res in ranks),
        "launches_per_rank": [res["launches"] for res in ranks],
        "launches_one": one["launches"],
        "ring_rows": n, "ring_rows_equal": int(same.sum()),
        "loss": {"world": first["losses"], "one": one["losses"]},
        "params_diff_of_largest_update": diff / one["update_max"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--config", default="b18c384nbt")
    ap.add_argument("--size", type=int, default=19)
    ap.add_argument("--games-per-rank", type=int, default=128)
    ap.add_argument("--batch-per-rank", type=int, default=64)
    ap.add_argument("--visits", type=int, default=32)
    ap.add_argument("--moves", type=int, default=2)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--capacity", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds the ranks may take together")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < args.world:
            print(f"chip_fused_mesh: {args.world} CUDA devices needed",
                  file=sys.stderr)
            return 2
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        print(f"cards: {smi}", flush=True)
    from katago_torch.ops import _build
    from katago_torch.parallel import mesh as PM
    if args.device == "cuda":
        print(f"build: {_build.build_all():.1f} s", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        url = f"tcp://127.0.0.1:{PM.free_port()}"
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_rank_main, args=(args, r, url, out))
                 for r in range(args.world)]
        t0 = time.time()
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=max(1.0, t0 + args.timeout - time.time()))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if [p.exitcode for p in procs] != [0] * args.world:
            raise SystemExit(f"ranks exited {[p.exitcode for p in procs]}")
        print(f"world {args.world}: {time.time() - t0:.1f} s of command "
              f"time", flush=True)
        t0 = time.time()
        run(args, 1, 0, None, out)
        print(f"world 1: {time.time() - t0:.1f} s of command time",
              flush=True)
        res = compare(args, out)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
