"""selfplay command — training-data generator (reference
cpp/command/selfplay.cpp); port of katago_tpu/cli/selfplay_cmd.py.

Polls a models dir for the newest export of the trainer
(train/checkpoint.py::find_latest_model, selfplay.cpp:140-151
semantics), plays batched MCTS games, and writes reference-schema npz
shards + sgf records per model into the output dir structure the
reference loop uses: outdir/<model>/{tdata,sgfs}/. Without -models-dir
(or with an empty one) the net has seeded random weights
(models/weights.py) and the model is named "random-init". -switch-nets
polls the models dir every 16 moves and lets a newer export take over
the rest of the batch's games.

Usage: python -m katago_torch.cli.selfplay_cmd -output-dir D
         [-models-dir M [-switch-nets]] [-device cpu] [-dtype float32]
         [-size 9] [-games-per-batch 32] [-visits 64] [-max-batches N]
         [-config b2c16] [-multi-host -dist-url U -world-size N -rank R]

-multi-host splits each batch's games over the ranks of a
torch.distributed process group (parallel/mesh.py), one process per
card; rank 0 writes the output.

Runs on CUDA unless `-device cpu` is given; with no CUDA device and no
-device it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from katago_torch.dataio import sgf as S
from katago_torch.device import resolve_device
from katago_torch.game import rules as R
from katago_torch.models import config as MC
from katago_torch.models import model as M
from katago_torch.models import weights as W
from katago_torch.search.params import SearchParams
from katago_torch.selfplay import gameinit as GI
from katago_torch.selfplay.loop import play_games
from katago_torch.selfplay.playsettings import PlaySettings
from katago_torch.train import checkpoint as C
from katago_torch.utils.signals import GracefulShutdown

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def make_model(size: int, config_name: str, dtype, device,
               seed: int = 0) -> M.KataGoModel:
    """The named net with seeded random weights, on device, in eval mode."""
    model = M.KataGoModel(MC.get_config(config_name), size, dtype)
    return W.init_weights(model, seed=seed).to(device).eval()


def run_selfplay(output_dir: str, models_dir: str | None, *, size: int,
                 games_per_batch: int, visits: int, max_batches: int,
                 config_name: str = "b2c16", rules: R.Rules | None = None,
                 seed: int = 0, data_quality: str = "selfplay",
                 game_init=None, switch_nets: bool = False,
                 ladder_mode: str = "chase", device=None,
                 dtype=torch.float32, max_moves: int | None = None,
                 mesh=None, log=print) -> dict:
    """max_moves: cut every game after this many moves (default: the
    play_games default, about 1.6 moves per point).

    mesh: a parallel.mesh.Mesh — each batch (size bucket) whose games
    divide by its ranks is split over them (the reference's multi-GPU
    selfplay, nneval.h:97); every rank plays the same batches and rank
    0 alone writes the shards and records."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    writer = mesh is None or mesh.rank == 0
    if mesh is not None and games_per_batch % mesh.world_size == 0:
        log(f"selfplay game axis split over {mesh.world_size} ranks")
    model = make_model(size, config_name, dtype, dev)
    model_name = "random-init"
    if models_dir:
        latest = C.find_latest_model(models_dir)
        if latest:
            model.load_state_dict(C.load_params(latest, model.state_dict()))
            model_name = os.path.basename(latest)
    log(f"selfplay: model={model_name} size={size} games/batch="
        f"{games_per_batch} visits={visits} device={dev}")

    tdata_dir = os.path.join(output_dir, model_name, "tdata")
    sgf_dir = os.path.join(output_dir, model_name, "sgfs")
    os.makedirs(tdata_dir, exist_ok=True)
    os.makedirs(sgf_dir, exist_ok=True)

    gen = torch.Generator(device=dev).manual_seed(seed)
    host_rng = np.random.default_rng(seed * 77777 + 5)
    totals = {"games": 0, "rows": 0, "playouts": 0, "resignations": 0}
    sp = SearchParams.for_selfplay()
    ps = PlaySettings.for_selfplay() if data_quality == "selfplay" \
        else PlaySettings.for_testing(visits)
    # one module per board size sharing the weights (every layer is
    # size-independent, like the reference's nets)
    models_by_size = {size: model}

    def model_for(s: int) -> M.KataGoModel:
        if s not in models_by_size:
            m = M.KataGoModel(MC.get_config(config_name), s, dtype)
            m.load_state_dict(model.state_dict())
            models_by_size[s] = m.to(dev).eval()
        return models_by_size[s]

    params_provider = None
    if switch_nets and models_dir:
        current = {"name": model_name}

        def params_provider():
            latest = C.find_latest_model(models_dir)
            if latest and os.path.basename(latest) != current["name"]:
                current["name"] = os.path.basename(latest)
                log(f"  switching to net {current['name']} mid-game")
                return C.load_params(latest, model.state_dict())
            return None

    with GracefulShutdown(log) as stop:
        for batch_i in range(max_batches):
            if stop.requested:
                log("selfplay: drain requested, stopping before next batch")
                break
            t0 = time.time()
            # GameInitializer: per-game sizes/rules/komi/handicap; one
            # lockstep bucket per sampled board size (play.h:76-150)
            if game_init is not None:
                specs = GI.sample_game_specs(game_init, games_per_batch,
                                             host_rng)
                buckets = GI.group_specs_by_size(specs)
            else:
                buckets = {size: None}
            b_rows, b_playouts, b_resigns, b_games = 0, 0, 0, 0
            shard_arrays = []
            sgf_lines = []
            for bsize, bspecs in sorted(buckets.items()):
                if bspecs is None:
                    n_games, grules, nh, comp, fork, starts = (
                        games_per_batch, None, None, None, None, None)
                else:
                    grules, nh, comp, fork, starts = \
                        GI.specs_to_rules_arrays(bspecs, dev)
                    n_games = len(bspecs)
                bmesh = mesh if (mesh is not None and
                                 n_games % mesh.world_size == 0) else None
                data, stats = play_games(
                    model_for(bsize), size=bsize, num_games=n_games,
                    visits=visits, rules=rules, search_params=sp, gen=gen,
                    device=dev, play_settings=ps, game_rules=grules,
                    num_handicap=nh, compensate_komi=comp, early_fork=fork,
                    start_samples=starts, ladder_mode=ladder_mode,
                    max_moves=max_moves, params_provider=params_provider,
                    mesh=bmesh)
                arrays = data.to_npz_arrays(
                    bsize, stats["white_minus_black"],
                    komi_white=stats.get("komi_white"))
                shard_arrays.append((bsize, arrays))
                sgf_lines += game_records(data, stats, bsize, n_games, rules)
                b_rows += data.spatial.shape[0]
                b_playouts += stats["total_playouts"]
                b_resigns += stats.get("resignations", 0)
                b_games += n_games
            dt = time.time() - t0
            # one shard per (batch, size): mixed sizes can't share one npz
            # (spatial dims differ); the shuffler/trainer consume per-size
            for bsize, arrays in (shard_arrays if writer else []):
                shard = os.path.join(
                    tdata_dir, f"batch{batch_i:06d}_{seed}_s{bsize}.npz")
                # write-then-rename so concurrent readers never see a
                # half-written file
                tmp = shard + ".tmp.npz"
                np.savez_compressed(tmp, **arrays)
                os.replace(tmp, shard)
            if writer:
                with open(os.path.join(sgf_dir,
                                       f"batch{batch_i:06d}_{seed}.sgfs"),
                          "w") as f:
                    f.write("\n".join(sgf_lines) + "\n")

            totals["games"] += b_games
            totals["rows"] += b_rows
            totals["playouts"] += b_playouts
            totals["resignations"] += b_resigns
            log(f"  batch {batch_i}: {b_games} games "
                f"({len(shard_arrays)} size buckets), {b_rows} rows, "
                f"{dt:.1f}s ({b_playouts / max(dt, 1e-9):.0f} playouts/s)")
    return totals


def game_records(data, stats: dict, size: int, n_games: int,
                 rules: R.Rules | None) -> list[str]:
    """One sgf per game: the recorded rows' most visited moves, komi and
    result."""
    out = []
    for g in range(n_games):
        score = stats["white_minus_black"][g]
        result = (f"W+{score:g}" if score > 0
                  else f"B+{-score:g}" if score < 0 else "0")
        moves = [(int(data.to_move[i]), int(np.argmax(data.policy_target[i])))
                 for i in np.flatnonzero(data.game_idx == g)]
        komi_g = float(stats["komi_white"][g]) if "komi_white" in stats \
            else (rules or R.Rules.tromp_taylorish()).komi
        out.append(S.write_sgf(moves, size, size, komi=komi_g,
                               result=result))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-output-dir", required=True)
    ap.add_argument("-models-dir", default=None,
                    help="directory of the trainer's exports; the newest "
                         "is loaded")
    ap.add_argument("-size", type=int, default=9)
    ap.add_argument("-games-per-batch", type=int, default=32)
    ap.add_argument("-visits", type=int, default=64)
    ap.add_argument("-max-batches", type=int, default=4)
    ap.add_argument("-config", default="b2c16")
    ap.add_argument("-seed", type=int, default=0)
    ap.add_argument("-device", default=None,
                    help="torch device (default: cuda; 'cpu' to run on "
                         "the CPU)")
    ap.add_argument("-dtype", default="float32", choices=sorted(DTYPES),
                    help="the net's compute dtype")
    ap.add_argument("-data-quality", default="test",
                    choices=["selfplay", "test"],
                    help="selfplay = policy-init + cheap/full mixing + komi "
                         "randomization (production data); test = every "
                         "move full-searched and recorded")
    ap.add_argument("-init-config", default=None,
                    help="reference-style selfplay cfg with GameInitializer "
                         "keys (bSizes/bSizeRelProbs/koRules/scoringRules/"
                         "taxRules/komiStdev/handicapProb/...)")
    ap.add_argument("-switch-nets", action="store_true",
                    help="poll -models-dir every 16 moves and switch to a "
                         "newer export mid-game")
    ap.add_argument("-multi-host", action="store_true",
                    help="split each batch's games over a torch.distributed "
                         "process group (NCCL on CUDA, gloo on the CPU)")
    ap.add_argument("-dist-url", default=None,
                    help="-multi-host rendezvous, tcp://host:port (default "
                         "at world size 1: a free localhost port)")
    ap.add_argument("-world-size", type=int, default=1)
    ap.add_argument("-rank", type=int, default=0)
    ap.add_argument("-ladder-mode", default="chase",
                    choices=["chase", "exact"],
                    help="in-search leaf ladder featurization (per-move "
                         "data writing is always exact)")
    args = ap.parse_args(argv)
    game_init = None
    if args.init_config:
        from katago_torch.selfplay.gameinit import GameInitParams
        from katago_torch.utils.config_parser import ConfigParser
        cp = ConfigParser(args.init_config)
        game_init = GameInitParams.from_config(
            {k: cp.get_string(k) for k in cp.keys()})
    mesh = None
    if args.multi_host:
        from katago_torch.parallel import mesh as PM
        mesh = PM.initialize_multihost(args.dist_url, args.world_size,
                                       args.rank, args.device)
    try:
        totals = run_selfplay(
            args.output_dir, args.models_dir, size=args.size,
            games_per_batch=args.games_per_batch, visits=args.visits,
            max_batches=args.max_batches, config_name=args.config,
            seed=args.seed, data_quality=args.data_quality,
            game_init=game_init, switch_nets=args.switch_nets,
            ladder_mode=args.ladder_mode, device=args.device,
            dtype=DTYPES[args.dtype], mesh=mesh)
    finally:
        if mesh is not None:
            PM.shutdown()
    print(json.dumps(totals))


if __name__ == "__main__":
    main()
