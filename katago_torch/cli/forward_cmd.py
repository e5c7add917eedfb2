"""forward — run the raw net on positions, print every head
(python/forward_model.py); port of katago_tpu/cli/forward_cmd.py.

Debugging tool: loads a .bin.gz model (DescNet) or a config's seeded
net, featurizes a position (empty board, or an SGF at a given turn),
runs one forward pass (no search), and prints the post-processed outputs
as JSON: value, lead, score stats, shortterm errors, top-policy moves,
and optionally full policy/ownership grids.

Usage:
  python -m katago_torch.cli.forward_cmd [-model M.bin.gz | -config b6c96]
      [-size 19] [-sgf game.sgf [-turn N]] [-full] [-device cpu]

Runs on CUDA unless `-device cpu` is given; with no CUDA device and no
-device it raises.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from katago_torch.device import resolve_device
from katago_torch.game import history as H
from katago_torch.game import rules as R


def load_position(args, device=None):
    """(one-game GameState, board size) of -sgf at -turn, or the empty
    -size board."""
    if args.sgf:
        from katago_torch.cli.sgf_cmds import _replay
        from katago_torch.dataio import sgf as S
        with open(args.sgf) as f:
            game = S.parse_sgf(f.read())[0]
        _, _, states, _ = _replay(game, upto=args.turn, device=device)
        return states[-1], game.size[0]
    size = args.size
    gs = H.new_game(size, R.Rules.tromp_taylorish(), 8, device=device)
    return gs, size


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-model", default=None)
    ap.add_argument("-config", default="b2c16")
    ap.add_argument("-size", type=int, default=19)
    ap.add_argument("-sgf", default=None)
    ap.add_argument("-turn", type=int, default=None)
    ap.add_argument("-full", action="store_true",
                    help="include full policy/ownership grids")
    ap.add_argument("-device", default=None,
                    help="torch device (default: cuda; 'cpu' to run on "
                         "the CPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    gs, size = load_position(args, dev)

    from katago_torch.cli.match_cmd import load_net
    from katago_torch.models import features as F
    from katago_torch.models.model import postprocess_outputs
    net, name = load_net(args.model, args.config, size, dev)
    legal = H.legal_moves(gs, size)
    sp_feat, gl_feat = F.fill_features_v7(gs, size,
                                          F.FeatureParams.default(dev),
                                          legal)
    with torch.no_grad():
        raw = net(sp_feat.reshape(1, size, size, F.NUM_SPATIAL_V7), gl_feat)
        out = postprocess_outputs(raw)
    pol = np.exp(out["policy_log_probs"][0].cpu().numpy())
    pol = np.where(legal[0].cpu().numpy(), pol, 0.0)
    vp = out["value_probs"][0].cpu().numpy()
    to_move = int(gs.pos.to_move[0])
    cols = "ABCDEFGHJKLMNOPQRSTUVWXYZ"

    def loc_str(a):
        if a >= size * size:
            return "pass"
        return f"{cols[a % size]}{size - a // size}"

    def scalar(k):
        return float(out[k][0])

    top = np.argsort(pol)[::-1][:10]
    result = {
        "model": name,
        "toMove": "black" if to_move == 1 else "white",
        "win": float(vp[0]), "loss": float(vp[1]),
        "noResult": float(vp[2]) if vp.shape[0] > 2 else 0.0,
        "scoreMean": scalar("score_mean"),
        "scoreStdev": scalar("score_stdev"),
        "lead": scalar("lead"),
        "varianceTime": scalar("variance_time"),
        "shorttermWinlossError": scalar("shortterm_value_error"),
        "shorttermScoreError": scalar("shortterm_score_error"),
        "topPolicy": [{"move": loc_str(int(a)), "prob": float(pol[a])}
                      for a in top if pol[a] > 0],
    }
    if args.full:
        result["policy"] = pol.tolist()
        result["ownership"] = out["ownership"][0].cpu().numpy().reshape(
            -1).tolist()
    print(json.dumps(result))


if __name__ == "__main__":
    main()
