"""humanslnet server — JSON-lines eval server for human-SL nets, port of
katago_tpu/cli/humanslnet_server.py (the reference's
python/humanslnet_server.py).

Protocol (one JSON object per line on stdin, one response per line on
stdout):
  {"command":"start","board_x_size":N,"board_y_size":N,"rules":...}
  {"command":"play","pla":1|2,"loc":loc}       loc: 0..NN-1, NN=pass
  {"command":"undo"} / {"command":"redo"}
  {"command":"get_model_outputs","sgfmeta":{...camelCase SGFMetadata...}}
      -> {"outputs": {"moves_and_probs0": [[loc,prob]...],
                      "value": [win,loss,noresult],
                      "lead": x, "scorestdev": y}}

The sgfmeta conditions the net's metadata encoder when it has one; for
other nets it is accepted and ignored, as the reference does with
non-humanSL checkpoints. The net runs on `-device` (CUDA unless
`-device cpu`; with no CUDA and no -device it raises).

Usage:
  python -m katago_torch.cli.humanslnet_server [-model M.bin.gz]
      [-config b2c16] [-size 19] [-device cpu|cuda]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from katago_torch.device import resolve_device
from katago_torch.game import history as H
from katago_torch.game import rules as R
from katago_torch.models import features as F
from katago_torch.models.model import postprocess_outputs
from katago_torch.models.sgfmetadata import SGFMetadata, fill_metadata_row


class _Session:
    def __init__(self, net, size: int, rules: R.Rules, device):
        self.size = size
        self.rules = rules
        self.net = net
        self.device = device
        self.states = [H.new_game(size, rules, 2 * size * size + 64,
                                  device=device)]
        self.redo_stack: list = []

    @property
    def gs(self):
        return self.states[-1]

    def _one(self, v) -> torch.Tensor:
        return torch.tensor([v], dtype=torch.int64, device=self.device)

    def play(self, pla: int, loc: int):
        gs = H.replace_pos(self.gs, to_move=self._one(pla))
        gs, _ = H.step(gs, self._one(loc), self.size)
        self.states.append(gs)
        self.redo_stack = []

    def undo(self):
        if len(self.states) > 1:
            self.redo_stack.append(self.states.pop())

    def redo(self):
        if self.redo_stack:
            self.states.append(self.redo_stack.pop())

    def model_outputs(self, sgfmeta: SGFMetadata) -> dict:
        gs, size = self.gs, self.size
        legal = H.legal_moves(gs, size)
        sp, gl = F.fill_features_v7(
            gs, size, F.FeatureParams.default(self.device), legal)
        meta_row = fill_metadata_row(
            sgfmeta, next_player_is_white=int(gs.pos.to_move[0]) == 2,
            board_area=size * size)
        with torch.no_grad():
            raw = self.net(sp.reshape(1, size, size, F.NUM_SPATIAL_V7), gl,
                           metadata=torch.from_numpy(meta_row)[None].to(
                               self.device))
        out = {k: v.cpu() for k, v in postprocess_outputs(raw).items()}
        pol = np.exp(out["policy_log_probs"][0].numpy())
        pol = np.where(legal[0].cpu().numpy(), pol, 0.0)
        vp = out["value_probs"][0].numpy()
        return {
            "moves_and_probs0": [[int(a), float(pol[a])]
                                 for a in np.argsort(pol)[::-1]
                                 if pol[a] > 1e-6],
            "value": [float(vp[0]), float(vp[1]),
                      float(vp[2]) if vp.shape[0] > 2 else 0.0],
            "lead": float(out["lead"][0]),
            "scorestdev": float(out["score_stdev"][0]),
        }


def make_net(args, size: int, device):
    """The net the sessions evaluate: the -model file's DescNet (float32)
    or a seeded random KataGoModel of -config."""
    if args.model:
        from katago_torch.models import desc as D
        return D.load_net(args.model, device)
    from katago_torch.models import config as MC
    from katago_torch.models import model as M
    from katago_torch.models import weights as W
    model = M.KataGoModel(MC.get_config(args.config), pos_len=size,
                          dtype=torch.float32)
    return W.init_weights(model, seed=0).to(device).eval()


def main(argv=None, infile=None, outfile=None):
    ap = argparse.ArgumentParser(description="katago_torch humanSL server")
    ap.add_argument("-model", default=None)
    ap.add_argument("-config", default="b2c16")
    ap.add_argument("-size", type=int, default=19)
    ap.add_argument("-device", default=None,
                    help="cpu or cuda (default: cuda; raises without it)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    infile = infile or sys.stdin
    outfile = outfile or sys.stdout

    session = None
    nets: dict[int, torch.nn.Module] = {}

    def write(obj):
        outfile.write(json.dumps(obj) + "\n")
        outfile.flush()

    for line in infile:
        line = line.strip()
        if not line:
            continue
        data = json.loads(line)
        cmd = data["command"]
        if cmd == "start":
            size = int(data.get("board_x_size", args.size))
            if int(data.get("board_y_size", size)) != size:
                write({"error": "rectangular boards not supported"})
                continue
            rv = data.get("rules")
            if isinstance(rv, dict):
                rules = R.Rules.parse(json.dumps(rv))
            elif isinstance(rv, str):
                rules = R.Rules.parse(rv)
            else:
                rules = R.Rules.tromp_taylorish()
            if size not in nets:
                nets[size] = make_net(args, size, device)
            session = _Session(nets[size], size, rules, device)
            write({"outputs": ""})
        elif cmd == "play":
            session.play(int(data["pla"]), int(data["loc"]))
            write({"outputs": ""})
        elif cmd == "undo":
            session.undo()
            write({"outputs": ""})
        elif cmd == "redo":
            session.redo()
            write({"outputs": ""})
        elif cmd == "get_model_outputs":
            meta = SGFMetadata.of_dict(data.get("sgfmeta") or {})
            write({"outputs": session.model_outputs(meta)})
        else:
            write({"error": f"unknown command {cmd}"})


if __name__ == "__main__":
    main()
