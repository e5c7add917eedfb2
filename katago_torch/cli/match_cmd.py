"""match command — engine-vs-engine games with Elo (reference
cpp/command/match.cpp); port of katago_tpu/cli/match_cmd.py.

Plays batched games between two nets (alternating colors), scores them, and
reports the win record + Elo estimate with uncertainty via utils.elo —
the machinery the gatekeeper builds on (reference cpp/command/gatekeeper.cpp).

Usage: python -m katago_torch.cli.match_cmd -bot-a A -bot-b B
         [-size 9] [-games 16] [-visits 32] [-seed 0] [-device cpu]
       python -m katago_torch.cli.match_cmd -bots A,B,C ...
A bot is a .bin.gz file (DescNet) or random:<config>[:<seed>] (a
KataGoModel with the port's seeded weights). Runs on CUDA unless
`-device cpu` is given; with no CUDA device and no -device it raises.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from katago_torch.device import resolve_device
from katago_torch.game import board as B
from katago_torch.game import history as H
from katago_torch.game import rules as R
from katago_torch.search import mcts
from katago_torch.search.params import SearchParams
from katago_torch.utils import elo as E


def play_match(model_a, model_b, *, size: int, num_games: int, visits: int,
               rules: R.Rules | None = None, seed: int = 0,
               max_moves: int | None = None, device=None,
               log=print) -> dict:
    """num_games games; bot A is black in even games, white in odd games.
    Both sides search with identical deterministic-ish settings.

    model_a, model_b: nets (KataGoModel or DescNet) on `device`. Each
    move, both bots search every game and each game keeps the move of
    the bot that owns its player to move (as the JAX package does, so
    the records equal its). Finished games are still stepped; a step
    leaves a finished game unchanged."""
    dev = resolve_device(device)
    rules = rules or R.Rules.tromp_taylorish()
    nn = size * size
    max_moves = max_moves or int(nn * 1.6) + 20
    sp = SearchParams(
        root_noise_enabled=False,
        chosen_move_temperature=0.2, chosen_move_temperature_early=0.6,
        cpuct_exploration_log=0.45,
        static_score_utility_factor=0.1,
        dynamic_score_utility_factor=0.3).to_arr(dev)

    games = H.new_game(size, rules, max_moves + 8, g=num_games, device=dev)
    a_is_black = (np.arange(num_games) % 2 == 0)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def search(model):
        return mcts.run_search(model, games, sp, gen, size=size,
                               num_sims=visits, max_nodes=visits + 3,
                               feature_version=net_feature_version(model))

    with torch.no_grad():
        for _ in range(max_moves):
            if bool(games.pos.game_over.all()):
                break
            # both bots search every position; each game then takes the
            # move of whichever bot owns the player to move
            res_a = search(model_a)
            res_b = search(model_b)
            mv_a = mcts.choose_moves(res_a, sp, games.pos.move_num, gen)
            mv_b = mcts.choose_moves(res_b, sp, games.pos.move_num, gen)
            to_move_black = (games.pos.to_move == B.BLACK).cpu().numpy()
            a_to_move = (a_is_black & to_move_black) | \
                (~a_is_black & ~to_move_black)
            moves = torch.where(torch.from_numpy(a_to_move).to(dev),
                                mv_a, mv_b)
            games, _ = H.step(games, moves, size)

        _, score_w = H.final_score_area(games, size)
    score_w = score_w.cpu().numpy()
    black_won = score_w < 0
    a_won = (a_is_black & black_won) | (~a_is_black & ~black_won
                                         & (score_w != 0))
    draws = int((score_w == 0).sum())
    wins = int(a_won.sum())
    losses = num_games - wins - draws
    elo, elo_sd = E.estimate_elo(wins, losses, draws)
    result = {"games": num_games, "a_wins": wins, "a_losses": losses,
              "draws": draws, "a_elo_diff": round(elo, 1),
              "elo_stdev": round(elo_sd, 1),
              "finished": bool(games.pos.game_over.all())}
    log(f"match: A {wins}-{losses}-{draws} vs B; "
        f"Elo {elo:+.0f} +- {elo_sd:.0f}")
    return result


def net_feature_version(model) -> int:
    """The net's input-feature version: a DescNet's own, else V7."""
    desc = getattr(model, "desc", None)
    return desc.input_version if desc is not None else 7


def play_round_robin(bots: list, *, size: int, games_per_pair: int,
                     visits: int, rules: R.Rules | None = None,
                     seed: int = 0, device=None, log=print) -> dict:
    """All-pairs tournament (reference MatchPairer, play.h:214-264: cycles
    through every bot pairing) with multi-player MLE Elos + stdevs
    (ComputeElos, cpp/core/elo.{h,cpp}).

    bots: list of (name, model). win_matrix[a][b] counts
    (a-playing-black wins, a-playing-white wins) vs b, the layout
    compute_elos consumes."""
    n = len(bots)
    win_matrix = np.zeros((n, n, 2), np.float64)
    records = []
    for ai in range(n):
        for bi in range(ai + 1, n):
            name_a, model_a = bots[ai]
            name_b, model_b = bots[bi]
            r = play_match(model_a, model_b, size=size,
                           num_games=games_per_pair, visits=visits,
                           rules=rules, seed=seed + ai * 1000 + bi,
                           device=device, log=lambda s: None)
            # play_match alternates colors evenly, so split each side's
            # wins across the two seatings; wm[x][y] = (x's wins, y's
            # wins) in the games x played first. Draws = half win each.
            aw, al, dr = r["a_wins"], r["a_losses"], r["draws"]
            win_matrix[ai, bi, 0] += aw / 2.0 + dr / 4.0  # A first: A wins
            win_matrix[ai, bi, 1] += al / 2.0 + dr / 4.0  # A first: B wins
            win_matrix[bi, ai, 0] += al / 2.0 + dr / 4.0  # B first: B wins
            win_matrix[bi, ai, 1] += aw / 2.0 + dr / 4.0  # B first: A wins
            records.append({"a": name_a, "b": name_b, "a_wins": aw,
                            "a_losses": al, "draws": dr})
            log(f"  {name_a} vs {name_b}: {aw}-{al}-{dr}")
    elos = E.compute_elos(win_matrix)
    sds = E.compute_approx_elo_stdevs(elos, win_matrix)
    table = sorted(zip([b[0] for b in bots], elos, sds),
                   key=lambda t: -t[1])
    for name, elo, sd in table:
        log(f"  {name:24s} {elo:+7.1f} +- {sd:.1f}")
    return {"elos": {name: round(e, 1) for name, e, _ in table},
            "elo_stdevs": {name: round(s, 1) for name, _, s in table},
            "pair_records": records}


def load_net(model: str | None, config_name: str, size: int, device,
             dtype=torch.float32, seed: int = 0):
    """(net, name): a .bin.gz as a float32 DescNet, or the named config
    as a KataGoModel in dtype with the port's seeded random weights (the
    JAX tools init theirs from a JAX key, so those weights differ)."""
    if model:
        from katago_torch.models import desc as D
        net = D.load_net(model, device)
        return net, net.desc.name
    from katago_torch.cli.selfplay_cmd import make_model
    return make_model(size, config_name, dtype, device, seed), \
        f"random-init-{config_name}"


def _load_bot(spec: str, size: int, device=None) -> torch.nn.Module:
    """spec: path to .bin.gz (DescNet) or 'random:<config>[:<seed>]'
    (float32 KataGoModel with the port's seeded weights)."""
    dev = resolve_device(device)
    if spec.startswith("random:"):
        parts = spec.split(":")
        seed = int(parts[2]) if len(parts) > 2 else 0
        return load_net(None, parts[1], size, dev, seed=seed)[0]
    return load_net(spec, None, size, dev)[0]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-bot-a", default=None)
    ap.add_argument("-bot-b", default=None)
    ap.add_argument("-bots", default=None,
                    help="comma-separated bot specs: round-robin "
                         "tournament over all pairs with multi-player "
                         "Elos (MatchPairer + ComputeElos)")
    ap.add_argument("-size", type=int, default=9)
    ap.add_argument("-games", type=int, default=16,
                    help="games per pairing")
    ap.add_argument("-visits", type=int, default=32)
    ap.add_argument("-seed", type=int, default=0)
    ap.add_argument("-device", default=None,
                    help="torch device (default: cuda; 'cpu' to run on "
                         "the CPU)")
    args = ap.parse_args(argv)
    if args.bots:
        specs = [s.strip() for s in args.bots.split(",") if s.strip()]
        bots = [(s, _load_bot(s, args.size, args.device)) for s in specs]
        out = play_round_robin(bots, size=args.size,
                               games_per_pair=args.games,
                               visits=args.visits, seed=args.seed,
                               device=args.device)
    else:
        if not (args.bot_a and args.bot_b):
            ap.error("need -bot-a and -bot-b, or -bots for a tournament")
        model_a = _load_bot(args.bot_a, args.size, args.device)
        model_b = _load_bot(args.bot_b, args.size, args.device)
        out = play_match(model_a, model_b, size=args.size,
                         num_games=args.games, visits=args.visits,
                         seed=args.seed, device=args.device)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
