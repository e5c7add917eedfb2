"""summarize_sgfs — Elo table from a collection of SGF games
(python/summarize_sgfs.py); port of katago_tpu/cli/summarize_sgfs_cmd.py.

Walks directories of .sgf/.sgfs files, collects per-player win/loss
records from the PB/PW/RE properties, and prints a Bradley-Terry Elo
table with approximate stdevs (katago/utils/elo.py semantics via
katago_torch.utils.elo). Host-only: no device is used.

Usage:
  python -m katago_torch.cli.summarize_sgfs_cmd DIR [DIR...]
      [-elo-prior-games 2.0] [-json]
"""

from __future__ import annotations

import argparse
import json
import os

from katago_torch.dataio.sgfscan import scan_sgf
from katago_torch.utils import elo as E


def collect_records(paths: list[str]):
    """Returns (players, win_matrix[n][n][2], num_games). win_matrix
    convention follows compute_elos: [a][b] = (a's wins, b's wins) over
    games where a played first (black)."""
    records = []   # (black, white, winner)  winner: 1 black, 2 white, 0
    files = []
    for p in paths:
        if os.path.isdir(p):
            for root, _, names in os.walk(p):
                files += [os.path.join(root, n) for n in names
                          if n.endswith((".sgf", ".sgfs"))]
        else:
            files.append(p)
    for f in sorted(files):
        with open(f) as fh:
            text = fh.read()
        for chunk in text.split("\n"):
            chunk = chunk.strip()
            if not chunk:
                continue
            g = scan_sgf(chunk)
            if g is None:
                continue
            black = g.black_name or "black"
            white = g.white_name or "white"
            winner = g.result if g.result in (1, 2) else 0
            records.append((black, white, winner))
    players = sorted({r[0] for r in records} | {r[1] for r in records})
    idx = {p: i for i, p in enumerate(players)}
    n = len(players)
    wm = [[[0.0, 0.0] for _ in range(n)] for _ in range(n)]
    for black, white, winner in records:
        a, b = idx[black], idx[white]
        if winner == 1:
            wm[a][b][0] += 1
        elif winner == 2:
            wm[a][b][1] += 1
        else:   # draw/no-result counts half each way (elo.cpp drawlogic)
            wm[a][b][0] += 0.5
            wm[a][b][1] += 0.5
    return players, wm, len(records)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("paths", nargs="+")
    ap.add_argument("-elo-prior-games", type=float, default=2.0)
    ap.add_argument("-json", action="store_true")
    args = ap.parse_args(argv)

    players, wm, num_games = collect_records(args.paths)
    if not players:
        print("no games found")
        return
    elos = E.compute_elos(wm, prior_wl=args.elo_prior_games)
    stdevs = E.compute_approx_elo_stdevs(elos, wm,
                                         prior_wl=args.elo_prior_games)
    order = sorted(range(len(players)), key=lambda i: -elos[i])
    if args.json:
        print(json.dumps({
            "games": num_games,
            "players": [{"name": players[i], "elo": round(elos[i], 1),
                         "stdev": round(stdevs[i], 1)} for i in order]}))
        return
    print(f"{num_games} games, {len(players)} players")
    print(f"{'player':<32} {'elo':>8} {'stdev':>7}")
    for i in order:
        print(f"{players[i]:<32} {elos[i]:>8.1f} {stdevs[i]:>7.1f}")


if __name__ == "__main__":
    main()
