"""SGF commands — port of katago_tpu/cli/sgf_cmds.py, first part: the
main-line replay (`_replay`, `_replay_moves`) and evalsgf
(cpp/command/evalsgf.cpp: analyze one SGF position, print values).

The other subcommands of the JAX module (writetrainingdata, startposes,
samplesgfs, dataminesgfs, viewstartposes, checksgfhintpolicy) are not
ported yet (ROADMAP M12): they raise NotImplementedError.

Usage:
  python -m katago_torch.cli.sgf_cmds evalsgf game.sgf [-move-num N]
      [-model M] [-config b6c96] [-visits 64] [-device cpu]

Runs on CUDA unless `-device cpu` is given; with no CUDA device and no
-device it raises.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from katago_torch.dataio import sgf as S
from katago_torch.device import resolve_device
from katago_torch.game import board as B
from katago_torch.game import history as H
from katago_torch.game import rules as R

NOT_PORTED = ("writetrainingdata", "startposes", "samplesgfs",
              "dataminesgfs", "viewstartposes", "checksgfhintpolicy")


def _replay_moves(game: S.SgfGame, moves, device=None):
    """Replay an explicit move list (of game's sgf locs) after game's
    setup stones; returns (grid size, rules, states list incl. initial,
    moves in engine-grid space). States are one-game batches.
    Rectangular SGFs play on the max(x,y) square grid with WALL-filled
    off-board rows."""
    dev = resolve_device(device)
    xs, ys = game.size
    size = max(xs, ys)
    shape = None
    if xs != ys:
        m = np.zeros((size, size), bool)
        m[:ys, :xs] = True
        shape = torch.from_numpy(m.reshape(-1))
    rules = R.Rules.tromp_taylorish()
    rules = R.Rules(**{**rules.__dict__, "komi": game.komi})
    gs = H.new_game(size, rules, 2 * size * size + 32, device=dev,
                    shape_mask=shape)
    for color, loc in game.setup_stones():
        gs = H.setup_stone(gs, S.remap_to_grid(loc, xs, ys, size), color,
                           size)
    states = [gs]
    gmoves = [(p, S.remap_to_grid(l, xs, ys, size)) for p, l in moves]

    def one(v):
        return torch.tensor([v], dtype=torch.int64, device=dev)

    for player, loc in gmoves:
        gs = H.replace_pos(gs, to_move=one(player))
        gs, _ = H.step(gs, one(loc), size)
        states.append(gs)
    return size, rules, states, gmoves


def _replay(game: S.SgfGame, upto: int | None = None, device=None):
    """Replay a game's main line (its first `upto` moves); returns
    (grid size, rules, states list incl. initial, moves in engine-grid
    space)."""
    moves = game.moves()
    if upto is not None:
        moves = moves[:upto]
    return _replay_moves(game, moves, device)


def cmd_evalsgf(args):
    dev = resolve_device(args.device)
    with open(args.sgf) as f:
        games = S.parse_sgf(f.read())
    game = games[0]
    size, rules, states, moves = _replay(game, args.move_num, dev)
    gs = states[-1]

    from katago_torch.cli.match_cmd import load_net, net_feature_version
    from katago_torch.search import mcts
    from katago_torch.search.params import SearchParams
    net, _ = load_net(args.model, args.config, size, dev)
    sp = SearchParams(use_lcb_for_selection=True).to_arr(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    with torch.no_grad():
        res = mcts.run_search(net, gs, sp, gen, size=size,
                              num_sims=args.visits,
                              max_nodes=args.visits + 3,
                              feature_version=net_feature_version(net))
    print(B.board_to_string(gs.pos.board.stones[0].cpu().numpy(), size))
    mover = "black" if int(gs.pos.to_move[0]) == B.BLACK else "white"
    print(f"move {len(moves)}, {mover} to play")
    print(f"winloss (white persp): {float(res.root_winloss[0]):+.3f}  "
          f"score: {float(res.root_score_mean[0]):+.1f}  "
          f"visits: {int(res.root_visits[0])}")
    # int32, as the JAX search returns them: numpy orders ties the same
    cv = res.child_visits[0].cpu().numpy().astype(np.int32)
    cwl = res.child_winloss[0].cpu().numpy()
    order = np.argsort(cv)[::-1]
    cols = "ABCDEFGHJKLMNOPQRSTUVWXYZ"
    for a in order[:8]:
        if cv[a] == 0:
            break
        mv = "pass" if a >= size * size else \
            f"{cols[a % size]}{size - a // size}"
        print(f"  {mv:>5}: {int(cv[a])} visits, "
              f"wl {float(cwl[a]):+.3f}")


def _not_ported(args):
    raise NotImplementedError(
        f"sgf_cmds {args.command} is not ported to katago_torch yet "
        "(ROADMAP Queue 1, M12)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="command", required=True)

    ev = sub.add_parser("evalsgf")
    ev.add_argument("sgf")
    ev.add_argument("-move-num", type=int, default=None)
    ev.add_argument("-model", default=None)
    ev.add_argument("-config", default="b6c96")
    ev.add_argument("-visits", type=int, default=64)
    ev.add_argument("-device", default=None,
                    help="torch device (default: cuda; 'cpu' to run on "
                         "the CPU)")
    ev.set_defaults(fn=cmd_evalsgf)

    for name in NOT_PORTED:
        sub.add_parser(name).set_defaults(fn=_not_ported)

    # the unported subcommands take the JAX module's arguments unchecked
    args, rest = ap.parse_known_args(argv)
    if rest and args.fn is not _not_ported:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")
    args.fn(args)


if __name__ == "__main__":
    main()
