"""genboard — train / run the position-generation net
(python/genboard_train.py, genboard_run.py); port of
katago_tpu/cli/genboard_cmd.py.

  train   build masked-position examples from SGF games and train
          GenBoardModel (point CE + 0.3 aux CE, SGD momentum like the
          reference); writes the port's checkpoint (.pt: the widths and
          the state_dict)
  run     complete a partially-specified board pattern: '.' empty,
          'X' black, 'O' white, '?' unknown (autoregressive sampling,
          one batched forward per point); -model takes the port's .pt or
          the JAX package's params .npz (carried over)

Usage:
  python -m katago_torch.cli.genboard_cmd train -sgf-dir D -out model.pt
      [-size 19] [-channels 96] [-blocks 8] [-steps 200] [-batch 16]
      [-device cpu]
  python -m katago_torch.cli.genboard_cmd run -model model.pt
      -board "<size*size chars>" -turn 50 -turnstdev 10 -source 0
      [-batchsize 4] [-device cpu]

Runs on CUDA unless `-device cpu` is given; with no CUDA device and no
-device it raises.
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
import random

import numpy as np
import torch

from katago_torch.device import resolve_device
from katago_torch.models import genboard as GB


def _random_subinterval(rand: random.Random, size: int):
    """genboard_train.py:77-94: half the time a triangular-shrunk
    interval, half the time uniform endpoints; may be empty."""
    def tri():
        return (size + 1) * (1.0 - math.sqrt(rand.random())) - 1
    if rand.random() < 0.5:
        x0, x1 = tri(), tri()
    else:
        x0, x1 = rand.randint(0, size - 1), rand.randint(0, size - 1)
    lo, hi = sorted((int(max(x0, 0)), int(max(x1, 0))))
    if rand.random() < 0.5:
        return 1, 0   # empty interval: nothing always-known
    return lo, hi


def make_examples(games, size: int, batch: int, rand: random.Random,
                  replays: dict | None = None, device=None):
    """Masked-position training batch from replayed SGF positions
    (numpy arrays). The games are replayed on device (CUDA unless the
    caller names another); replays caches each game's replayed boards
    (int32[len(states), NN], on the host) by index across calls."""
    from katago_torch.cli.sgf_cmds import _replay
    dev = resolve_device(device)
    replays = {} if replays is None else replays
    stones_b, known_b, pts, labels, aux_b, turns, stds = \
        [], [], [], [], [], [], []
    nn_ = size * size
    while len(stones_b) < batch:
        gi = rand.randrange(len(games))
        if gi not in replays:
            try:
                _, _, states, _ = _replay(games[gi], device=dev)
            except ValueError:   # a malformed record (SgfError)
                replays[gi] = None
            else:
                replays[gi] = torch.stack(
                    [s.pos.board.stones[0] for s in states]
                ).to(torch.int32).cpu().numpy()
        boards = replays[gi]
        if boards is None:
            continue
        if len(boards) < 3:
            continue
        turn = rand.randint(1, len(boards) - 1)
        stones = boards[turn]
        if stones.shape[0] != nn_:
            continue
        # always-known subrectangle + random visible prefix of the rest
        x0, x1 = _random_subinterval(rand, size)
        y0, y1 = _random_subinterval(rand, size)
        always = np.zeros((size, size), bool)
        always[y0:y1 + 1, x0:x1 + 1] = True
        always = always.reshape(-1)
        rest = np.flatnonzero(~always)
        rand.shuffle(rest)
        num_known = rand.randint(0, max(len(rest) - 1, 0))
        known = always.copy()
        known[rest[:num_known]] = True
        if len(rest) == 0:
            continue
        point = int(rest[num_known])
        # turn-number noise (genboard_train.py:212-217)
        if rand.random() < 0.3:
            noisy_turn, std = float(turn), 0.0
        else:
            std = (rand.random() ** 2.0) * 100
            noisy_turn = turn + rand.normalvariate(0.0, std)
        stones_b.append(stones)
        known_b.append(known)
        pts.append(point)
        labels.append(int(stones[point]))
        aux_b.append(stones)
        turns.append(noisy_turn)
        stds.append(std)
    return (np.stack(stones_b), np.stack(known_b), np.asarray(pts),
            np.asarray(labels), np.stack(aux_b),
            np.asarray(turns, np.float32), np.asarray(stds, np.float32))


def batch_inputs(example, size: int, dev):
    """(inputs [B,H,W,8], point labels, aux labels) on dev of one
    make_examples batch, source 0."""
    stones, known, pts, labels, aux, turns, stds = example
    t = {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in
         dict(stones=stones, known=known, pts=pts, turns=turns,
              stds=stds).items()}
    src = torch.zeros((stones.shape[0],), dtype=torch.float32, device=dev)
    inputs = GB.build_inputs(t["stones"], t["known"], t["pts"], t["turns"],
                             t["stds"], src, size)
    return inputs, torch.from_numpy(labels).to(dev), \
        torch.from_numpy(aux).to(dev)


def train_step(model, opt, inputs, point_label, aux_label):
    """One SGD step on the reference loss; returns (main, aux)."""
    pl, al = model(inputs)
    main, aux = GB.genboard_loss(pl, al, point_label, aux_label, inputs)
    opt.zero_grad(set_to_none=True)
    (main + aux).backward()
    opt.step()
    return main.detach(), aux.detach()


def read_games(sgf_dir: str, size: int) -> list:
    """Every parseable game of the .sgf / .sgfs files under sgf_dir (one
    game per line) at size x size."""
    from katago_torch.dataio import sgf as S
    games = []
    for f in sorted(glob.glob(os.path.join(sgf_dir, "**", "*.sgf*"),
                              recursive=True)):
        with open(f) as fh:
            for chunk in fh.read().split("\n"):
                if chunk.strip():
                    try:
                        games += S.parse_sgf(chunk)
                    except Exception:
                        pass
    return [g for g in games if g.size == (size, size)]


def cmd_train(args):
    dev = resolve_device(args.device)
    games = read_games(args.sgf_dir, args.size)
    if not games:
        raise SystemExit("no usable SGF games found")
    rand = random.Random(args.seed)
    model = GB.init_weights(
        GB.GenBoardModel(num_channels=args.channels,
                         num_blocks=args.blocks), args.seed).to(dev)
    opt = torch.optim.SGD(model.parameters(), lr=args.lr, momentum=0.9)
    replays: dict = {}
    for step in range(args.steps):
        inputs, labels, aux = batch_inputs(
            make_examples(games, args.size, args.batch, rand, replays,
                          dev), args.size, dev)
        main, aux_l = train_step(model, opt, inputs, labels, aux)
        if step % max(1, args.steps // 10) == 0:
            print(f"  step {step}: main={float(main):.4f} "
                  f"aux={float(aux_l):.4f}")
    save_model(args.out, model, args.size)
    print(json.dumps({"out": args.out, "steps": args.steps,
                      "games": len(games)}))


def save_model(path: str, model: GB.GenBoardModel, size: int):
    """The port's GenBoard checkpoint: widths, board size, state_dict."""
    tmp = path + ".tmp"
    torch.save({"channels": model.num_channels, "blocks": model.num_blocks,
                "size": size,
                "state_dict": {k: v.detach().cpu() for k, v in
                               model.state_dict().items()}}, tmp)
    os.replace(tmp, path)


def load_model(path: str, device):
    """(model on device, board size) from the port's .pt or the JAX
    package's params .npz (its keys are the Flax paths as
    "['params']/['Conv_0']/['kernel']", plus __channels, __blocks and
    __size)."""
    if path.endswith(".npz"):
        from katago_torch.models.weights import from_flax_params
        with np.load(path) as data:
            channels, blocks, size = (int(data[k]) for k in
                                      ("__channels", "__blocks", "__size"))
            tree: dict = {}
            for k in data.files:
                if k.startswith("__"):
                    continue
                node = tree
                *parts, leaf = [p.strip("[]'\"") for p in k.split("/")][1:]
                for p in parts:
                    node = node.setdefault(p, {})
                node[leaf] = data[k]
        state = from_flax_params(tree)
    else:
        ck = torch.load(path, map_location="cpu", weights_only=True)
        channels, blocks, size = ck["channels"], ck["blocks"], ck["size"]
        state = ck["state_dict"]
    model = GB.GenBoardModel(num_channels=channels, num_blocks=blocks)
    model.load_state_dict(state)
    return model.to(device).eval(), size


def parse_board(board: str, size: int):
    """(stones int32[NN], known bool[NN]) of a '.XO?' board string."""
    nn_ = size * size
    board = board.replace("\n", "").replace(" ", "")
    board = board.replace(",", ".").replace("*", ".")
    if len(board) != nn_:
        raise SystemExit(f"board must be {nn_} chars, got {len(board)}")
    stones = np.zeros((nn_,), np.int32)
    known = np.zeros((nn_,), bool)
    for i, c in enumerate(board):
        if c == "X":
            stones[i], known[i] = 1, True
        elif c == "O":
            stones[i], known[i] = 2, True
        elif c == ".":
            known[i] = True
        elif c != "?":
            raise SystemExit(f"bad board char {c!r}")
    return stones, known


def cmd_run(args):
    dev = resolve_device(args.device)
    model, size = load_model(args.model, dev)
    stones, known = parse_board(args.board, size)
    b = args.batchsize
    stones_b = torch.from_numpy(stones).to(dev).expand(b, -1)
    known_b = torch.from_numpy(known).to(dev).expand(b, -1)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    out = GB.sample_fill(model, stones_b, known_b, size=size, gen=gen,
                         turn=args.turn, turn_stdev=args.turnstdev,
                         source=float(args.source)).cpu().numpy()
    for g in range(b):
        rows = []
        for y in range(size):
            rows.append(" ".join(
                ".XO"[out[g, y * size + x]] for x in range(size)))
        print("\n".join(rows))
        print()


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="command", required=True)
    p = sub.add_parser("train")
    p.add_argument("-sgf-dir", required=True)
    p.add_argument("-out", required=True)
    p.add_argument("-size", type=int, default=19)
    p.add_argument("-channels", type=int, default=96)
    p.add_argument("-blocks", type=int, default=8)
    p.add_argument("-steps", type=int, default=200)
    p.add_argument("-batch", type=int, default=16)
    p.add_argument("-lr", type=float, default=1e-5)
    p.add_argument("-seed", type=int, default=0)
    p.set_defaults(fn=cmd_train)
    r = sub.add_parser("run")
    r.add_argument("-model", required=True)
    r.add_argument("-board", required=True)
    r.add_argument("-turn", type=float, default=50.0)
    r.add_argument("-turnstdev", type=float, default=10.0)
    r.add_argument("-source", type=int, default=0)
    r.add_argument("-batchsize", type=int, default=1)
    r.add_argument("-seed", type=int, default=0)
    r.set_defaults(fn=cmd_run)
    for q in (p, r):
        q.add_argument("-device", default=None,
                       help="torch device (default: cuda; 'cpu' to run on "
                            "the CPU)")
    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
