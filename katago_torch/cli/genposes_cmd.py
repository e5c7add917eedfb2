"""genposes — random/clumpy starting-position generation
(python/genrandomposes.py, genclumpyposes.py); port of
katago_tpu/cli/genposes_cmd.py.

Generates batches of random positions for selfplay seeding
(startPosesFiles), writing Sgf::PositionSample JSON lines. G games play
random legal moves in lockstep (one batched legality, draw and step per
move; games past their move budget freeze), clumpy mode biasing move
sampling toward points adjacent to own stones (the reference's clumped
fight-like shapes); then one batched NN forward scores every candidate
and a fairness filter keeps positions whose score is balanced enough
(genrandomposes.py is_fair_enough_pos: reject |score| > cap, keep with
prob 1/(1 + pickiness * |score|)).

Usage:
  python -m katago_torch.cli.genposes_cmd -out poses.jsonl -n 32
      [-size 9] [-mode random|clumpy] [-min-moves 6] [-max-moves 40]
      [-config b2c16 | -model M.bin.gz] [-max-score 60]
      [-score-rejection-pickiness 0.1] [-seed 0] [-device cpu]

Runs on CUDA unless `-device cpu` is given; with no CUDA device and no
-device it raises. The moves are drawn from a torch.Generator seeded by
-seed, so they differ from the JAX package's (its key draws).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from katago_torch import _tensortree as T
from katago_torch.device import resolve_device
from katago_torch.game import board as B
from katago_torch.game import history as H
from katago_torch.game import rules as R


def generate_positions(g: int, size: int, max_moves: int,
                       gen: torch.Generator | None, move_budget, *,
                       clumpy: bool = False, device=None,
                       gumbel: torch.Tensor | None = None) -> H.GameState:
    """Play `move_budget[i]` random legal moves in game i (lockstep;
    games past their budget freeze). Returns the final GameState batch.

    Each move is the argmax of logits plus Gumbel noise (a categorical
    draw): noise from gen, or, when gumbel (float32[max_moves, G, NN])
    is given, its rows in turn (the tests pass the JAX package's
    draws)."""
    dev = resolve_device(device)
    games = H.new_game(size, R.Rules.tromp_taylorish(), max_moves + 8,
                       g=g, device=dev)
    budget = torch.as_tensor(np.asarray(move_budget), dtype=torch.int64,
                             device=dev)
    nn = size * size
    last = min(max_moves, int(budget.max()) if g else 0)
    for t in range(last):
        legal = H.legal_moves(games, size)
        logits = torch.where(legal[:, :nn], 0.0, -1e30)   # board moves only
        if clumpy:
            nbr = B.shift4(games.pos.board.stones, size, B.WALL)
            own = (nbr == games.pos.to_move[:, None, None]).float().sum(1)
            logits = logits + 2.0 * own        # clump toward own stones
        if gumbel is not None:
            noise = gumbel[t].to(dev)
        else:
            u = torch.rand(logits.shape, generator=gen, device=dev)
            noise = -torch.log(-torch.log(torch.clamp(u, min=1e-20,
                                                      max=1.0 - 1e-7)))
        moves = torch.argmax(logits + noise, dim=1)
        stepped, _ = H.step(games, moves, size)
        games = T.where(t < budget, stepped, games)
    return games


def lead_white(net, games: H.GameState, size: int) -> np.ndarray:
    """The net's lead estimate (miscvalue[:, 2] * 20) of each game, from
    white's view: one batched evaluation without ladders."""
    from katago_torch.cli.match_cmd import net_feature_version
    from katago_torch.models import features as F
    from katago_torch.search import mcts
    evaluator = mcts.make_nn_evaluator(
        net, size, with_ladders=False,
        feature_version=net_feature_version(net))
    raw, _, _ = evaluator(games, F.FeatureParams.default(
        games.hist_len.device))
    lead_mover = raw["miscvalue"][:, 2].float().cpu().numpy() * 20.0
    to_move = games.pos.to_move.cpu().numpy()
    return np.where(to_move == B.WHITE, lead_mover, -lead_mover)


def fair_samples(games: H.GameState, lead: np.ndarray, size: int,
                 host_rng: np.random.Generator, *, max_score: float,
                 pickiness: float, mode: str) -> list:
    """The fairness filter: PositionSamples of the games whose white
    lead is within max_score, each kept with prob 1/(1 + pickiness *
    |lead|) by host_rng."""
    from katago_torch.dataio.poses import PositionSample
    stones = games.pos.board.stones.cpu().numpy().astype(np.int8)
    to_move = games.pos.to_move.cpu().numpy()
    move_nums = games.pos.move_num.cpu().numpy()
    out = []
    for i in range(stones.shape[0]):
        score = float(lead[i])
        if abs(score) > max_score:
            continue
        keep_prob = 1.0 / (1.0 + pickiness * abs(score))
        if host_rng.random() >= keep_prob:
            continue
        out.append(PositionSample(
            x_size=size, y_size=size, stones=stones[i],
            next_pla=int(to_move[i]), moves=[],
            initial_turn_number=int(move_nums[i]),
            weight=1.0, metadata=f"genposes-{mode}"))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-out", required=True)
    ap.add_argument("-n", type=int, default=32)
    ap.add_argument("-size", type=int, default=9)
    ap.add_argument("-mode", default="random", choices=["random", "clumpy"])
    ap.add_argument("-min-moves", type=int, default=6)
    ap.add_argument("-max-moves", type=int, default=40)
    ap.add_argument("-model", default=None)
    ap.add_argument("-config", default="b2c16")
    ap.add_argument("-max-score", type=float, default=60.0)
    ap.add_argument("-score-rejection-pickiness", type=float, default=0.1)
    ap.add_argument("-seed", type=int, default=0)
    ap.add_argument("-device", default=None,
                    help="torch device (default: cuda; 'cpu' to run on "
                         "the CPU)")
    args = ap.parse_args(argv)

    from katago_torch.cli.match_cmd import load_net
    dev = resolve_device(args.device)
    size = args.size
    host_rng = np.random.default_rng(args.seed)
    budget = host_rng.integers(args.min_moves, args.max_moves + 1,
                               size=args.n)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    games = generate_positions(args.n, size, args.max_moves, gen, budget,
                               clumpy=(args.mode == "clumpy"), device=dev)
    # fairness filter: one batched raw forward (the reference queries a
    # 400-visit search per candidate; the net's own lead estimate is the
    # cheap equivalent at generation scale)
    net, _ = load_net(args.model, args.config, size, dev)
    with torch.no_grad():
        lead = lead_white(net, games, size)
    samples = fair_samples(games, lead, size, host_rng,
                           max_score=args.max_score,
                           pickiness=args.score_rejection_pickiness,
                           mode=args.mode)
    with open(args.out, "w") as f:
        for sample in samples:
            f.write(sample.to_json_line() + "\n")
    print(json.dumps({"generated": args.n, "kept": len(samples),
                      "out": args.out, "mode": args.mode}))


if __name__ == "__main__":
    main()
