"""play — interactive terminal Go vs a trained net (python/play.py); port
of katago_tpu/cli/play_cmd.py.

The reference's play.py loads a torch checkpoint and lets a human play
against the raw policy/search in a terminal. Here the same loop drives
the engine layer (GTPEngine: search, time controls, resignation).

Usage:
  python -m katago_torch.cli.play_cmd [-model M.bin.gz] [-size 9]
      [-visits 64] [-color black|white] [-device cpu]

Commands at the prompt: a vertex like D4, `pass`, `undo`, `genmove`
(let the engine move for you), `policy` (print the net's top raw-policy
moves), `score`, `quit`. Runs on CUDA unless `-device cpu` is given;
with no CUDA device and no -device it raises.
"""

from __future__ import annotations

import argparse

import numpy as np

from katago_torch.game import board as B

COLS = "ABCDEFGHJKLMNOPQRSTUVWXYZ"


def board_str(stones: np.ndarray, size: int, last: int | None) -> str:
    out = []
    header = "   " + " ".join(COLS[:size])
    out.append(header)
    for y in range(size):
        row = [f"{size - y:2d} "]
        for x in range(size):
            loc = y * size + x
            s = stones[loc]
            c = "X" if s == B.BLACK else "O" if s == B.WHITE else "."
            if last is not None and loc == last:
                c = f"({c})"
                row[-1] = row[-1][:-1]  # tighten spacing around the mark
            row.append(c)
        out.append(" ".join(row) + f" {size - y}")
    out.append(header)
    return "\n".join(out)


def parse_vertex(s: str, size: int) -> int | None:
    s = s.strip().upper()
    if s == "PASS":
        return size * size
    if len(s) < 2 or s[0] not in COLS[:size]:
        return None
    try:
        y = int(s[1:])
    except ValueError:
        return None
    if not (1 <= y <= size):
        return None
    return (size - y) * size + COLS.index(s[0])


def loc_str(loc: int, size: int) -> str:
    if loc is None:
        return "resign"
    if loc >= size * size:
        return "pass"
    return f"{COLS[loc % size]}{size - loc // size}"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-model", default=None)
    ap.add_argument("-size", type=int, default=9)
    ap.add_argument("-visits", type=int, default=64)
    ap.add_argument("-color", default="black", choices=["black", "white"],
                    help="the human's color")
    ap.add_argument("-device", default=None,
                    help="torch device (default: cuda; 'cpu' to run on "
                         "the CPU)")
    args = ap.parse_args(argv)

    from katago_torch.cli.gtp import GTPEngine
    engine = GTPEngine(model_path=args.model, size=args.size,
                       visits=args.visits, allow_resignation=True,
                       device=args.device)
    human = B.BLACK if args.color == "black" else B.WHITE
    size = args.size
    last = None
    print(f"playing vs {engine.model_name}; you are {args.color}. "
          "Enter a vertex (e.g. D4), pass, undo, genmove, policy, "
          "score, quit.")

    while True:
        print(board_str(engine.stones_np(), size, last))
        to_move = engine.to_move()
        if bool(engine.gs.pos.game_over[0]):
            print("game over.")
        if to_move != human:
            mv = engine.genmove(to_move)
            print(f"engine plays {loc_str(mv, size)}")
            if mv is None:
                print("engine resigns — you win!")
                return
            last = mv if mv < size * size else None
            continue
        try:
            line = input(f"{'black' if to_move == B.BLACK else 'white'}> ")
        except EOFError:
            return
        cmd = line.strip().lower()
        if cmd in ("quit", "exit"):
            return
        if cmd == "undo":
            engine.undo()
            engine.undo()   # engine's reply + our move
            last = None
            continue
        if cmd == "genmove":
            mv = engine.genmove(human)
            print(f"playing {loc_str(mv, size)} for you")
            if mv is None:
                print("resigned for you.")
                return
            last = mv if mv < size * size else None
            continue
        if cmd == "policy":
            res = engine.search_root(human, visits=2)
            pol = res.root_policy_prior[0].cpu().numpy()
            top = np.argsort(pol)[::-1][:8]
            print("  ".join(f"{loc_str(int(a), size)}:{pol[a]:.3f}"
                            for a in top if pol[a] > 0))
            continue
        if cmd == "score":
            res = engine.search_root(human, visits=max(2, args.visits // 4))
            wl = float(res.root_winloss[0])
            sm = float(res.root_score_mean[0])
            print(f"white winloss {wl:+.3f}, score {sm:+.1f}")
            continue
        loc = parse_vertex(line, size)
        if loc is None:
            print("? unknown command or vertex")
            continue
        try:
            engine.play(human, loc)
            last = loc if loc < size * size else None
        except Exception as e:  # illegal move
            print(f"illegal: {e}")


if __name__ == "__main__":
    main()
