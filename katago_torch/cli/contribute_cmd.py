"""contribute command — volunteer distributed-training client
(cpp/command/contribute.cpp: task loop contribute.cpp:1086-1418,
runAndUploadSingleGame contribute.cpp:116); port of
katago_tpu/cli/contribute_cmd.py.

Polls the server for tasks, downloads the task's model (.bin.gz,
sha256-verified), runs a batch of selfplay games with the port's engine
(the .bin.gz served by DescNet), writes reference-schema npz + an SGF,
and uploads them.

Two faults of the JAX command are not copied: its games are seeded
from Python's salted `hash(task_id)` (another seed in every process),
and its representative SGF has no moves. Here the seed is the first
four bytes of the task id's sha256, and the SGF is the first game's
record (selfplay_cmd.game_records).

Usage: python -m katago_torch.cli.contribute_cmd -server URL -username U
         -password P -base-dir DIR [-size 19] [-visits 64]
         [-games-per-task 2] [-max-tasks N] [-max-moves M] [-device cpu]

-max-moves cuts every game after M moves (beyond the JAX command's
surface: for smoke runs and tests); by default games are played out.

Runs on CUDA unless `-device cpu` is given; with no CUDA device and no
-device it raises.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os

import torch

from katago_torch.device import resolve_device
from katago_torch.distributed.client import Connection


def task_seed(task_id: str) -> int:
    """The games' seed: the task id's sha256, first four bytes, below
    2**31 (the same in every process)."""
    digest = hashlib.sha256(task_id.encode()).digest()
    return int.from_bytes(digest[:4], "little") % (2 ** 31)


def run_one_task(conn: Connection, task, base_dir: str, *, size: int,
                 visits: int, games: int, max_moves: int | None = None,
                 device=None, log=print) -> dict:
    """Download, verify and load the task's model, play `games` selfplay
    games (cut at max_moves moves when given), write and upload the npz
    rows and the first game's SGF; returns the server's answer."""
    from katago_torch.cli.selfplay_cmd import game_records
    from katago_torch.dataio import trainingwrite as TW
    from katago_torch.models import desc as D
    from katago_torch.search.params import SearchParams
    from katago_torch.selfplay.loop import play_games

    dev = resolve_device(device)
    model_dir = os.path.join(base_dir, "models")
    path = conn.download_model_if_not_present(task.model_black, model_dir)
    net = D.load_net(path, dev)

    gen = torch.Generator(device=dev).manual_seed(task_seed(task.task_id))
    data, stats = play_games(
        net, size=size, num_games=games, visits=visits,
        search_params=SearchParams.for_selfplay(), gen=gen,
        max_moves=max_moves, device=dev)
    arrays = data.to_npz_arrays(size, stats["white_minus_black"],
                                komi_white=stats.get("komi_white"))

    out_dir = os.path.join(base_dir, "uploads")
    os.makedirs(out_dir, exist_ok=True)
    npz_path = os.path.join(out_dir, f"{task.task_id or 'task'}.npz")
    TW.write_npz(npz_path, arrays)
    # one representative SGF (the first game)
    sgf_path = os.path.join(out_dir, f"{task.task_id or 'task'}.sgf")
    with open(sgf_path, "w") as f:
        f.write(game_records(data, stats, size, 1, None)[0])

    rows = int(arrays["globalTargetsNC"].shape[0])
    resp = conn.upload_training_game_and_data(task, sgf_path, npz_path,
                                              rows)
    log(f"contribute: uploaded task {task.task_id}: {rows} rows")
    return resp


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-server", required=True)
    ap.add_argument("-username", required=True)
    ap.add_argument("-password", required=True)
    ap.add_argument("-base-dir", required=True)
    ap.add_argument("-size", type=int, default=19)
    ap.add_argument("-visits", type=int, default=64)
    ap.add_argument("-games-per-task", type=int, default=2)
    ap.add_argument("-max-tasks", type=int, default=0, help="0 = forever")
    ap.add_argument("-max-moves", type=int, default=None,
                    help="cut every game after this many moves")
    ap.add_argument("-device", default=None,
                    help="torch device (default: cuda; 'cpu' to run on "
                         "the CPU)")
    args = ap.parse_args(argv)

    from katago_torch.utils.signals import GracefulShutdown
    dev = resolve_device(args.device)
    conn = Connection(args.server, args.username, args.password)
    me = conn.test_connection()
    print(f"contribute: connected as {me.get('username', args.username)}")
    done = 0
    with GracefulShutdown(print) as stop:
        while args.max_tasks == 0 or done < args.max_tasks:
            if stop.requested:
                print("contribute: drain requested, stopping after "
                      f"{done} tasks")
                break
            task = conn.get_next_task()
            run_one_task(conn, task, args.base_dir, size=args.size,
                         visits=args.visits, games=args.games_per_task,
                         max_moves=args.max_moves, device=dev)
            done += 1
    print(json.dumps({"tasks_completed": done}))


if __name__ == "__main__":
    main()
