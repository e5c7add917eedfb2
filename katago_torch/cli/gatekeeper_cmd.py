"""gatekeeper command — candidate-vs-champion gating (reference
cpp/command/gatekeeper.cpp); port of katago_tpu/cli/gatekeeper_cmd.py.

Polls test-models/ for candidates, plays each against the current best in
models/, and accepts (moves into models/) if the candidate's win proportion
meets the threshold (default 0.5, gatekeeper.cpp:52-188), rejecting
otherwise (into rejected-models/). Model exports are the port's param
exports of the train command (train/checkpoint.py::export_params); matches
run through cli.match_cmd's batched engine.

Usage: python -m katago_torch.cli.gatekeeper_cmd -test-models-dir T
         -models-dir M -rejected-models-dir R [-size 9] [-config b2c16]
         [-games 8] [-visits 24] [-win-threshold 0.5] [-max-moves N]
         [-device cpu]

Runs on CUDA unless `-device cpu` is given; with no CUDA device and no
-device it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil

import torch

from katago_torch.cli.match_cmd import play_match
from katago_torch.device import resolve_device
from katago_torch.train import checkpoint as C


def _bot_from_export(path: str, size: int, config_name: str,
                     device=None) -> torch.nn.Module:
    """The float32 KataGoModel carrying the params of an export dir."""
    from katago_torch.models import config as MC
    from katago_torch.models import model as M
    dev = resolve_device(device)
    model = M.KataGoModel(MC.get_config(config_name), size,
                          torch.float32).to(dev)
    model.load_state_dict(C.load_params(path, model.state_dict()))
    return model.eval()


def run_gatekeeper(test_models_dir: str, models_dir: str,
                   rejected_dir: str, *, size: int, config_name: str,
                   games: int, visits: int, win_threshold: float = 0.5,
                   seed: int = 0, max_moves: int | None = None, device=None,
                   log=print) -> list[dict]:
    """Gate each candidate export of test_models_dir (in name order)
    against the newest export of models_dir. max_moves cuts each match
    (play_match's default: about 1.6 moves per point)."""
    os.makedirs(models_dir, exist_ok=True)
    os.makedirs(rejected_dir, exist_ok=True)
    results = []
    candidates = sorted(
        d for d in os.listdir(test_models_dir)
        if os.path.isdir(os.path.join(test_models_dir, d))
        and not d.startswith("."))
    for cand in candidates:
        cand_path = os.path.join(test_models_dir, cand)
        champ_path = C.find_latest_model(models_dir)
        model_cand = _bot_from_export(cand_path, size, config_name, device)
        if champ_path is None:
            # first model is accepted unconditionally (reference behavior)
            dest = os.path.join(models_dir, cand)
            shutil.move(cand_path, dest)
            log(f"gatekeeper: no champion, accepted {cand}")
            results.append({"candidate": cand, "accepted": True,
                            "reason": "first model"})
            continue
        model_champ = _bot_from_export(champ_path, size, config_name,
                                       device)
        record = play_match(model_cand, model_champ, size=size,
                            num_games=games, visits=visits, seed=seed,
                            max_moves=max_moves, device=device, log=log)
        win_prop = (record["a_wins"] + 0.5 * record["draws"]) / record["games"]
        accepted = win_prop >= win_threshold
        dest = os.path.join(models_dir if accepted else rejected_dir, cand)
        shutil.move(cand_path, dest)
        log(f"gatekeeper: {cand} vs {os.path.basename(champ_path)}: "
            f"win prop {win_prop:.2f} -> "
            f"{'ACCEPTED' if accepted else 'rejected'}")
        results.append({"candidate": cand, "accepted": accepted,
                        "win_prop": win_prop, **record})
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-test-models-dir", required=True)
    ap.add_argument("-models-dir", required=True)
    ap.add_argument("-rejected-models-dir", required=True)
    ap.add_argument("-size", type=int, default=9)
    ap.add_argument("-config", default="b2c16")
    ap.add_argument("-games", type=int, default=8)
    ap.add_argument("-visits", type=int, default=24)
    ap.add_argument("-win-threshold", type=float, default=0.5)
    ap.add_argument("-max-moves", type=int, default=None,
                    help="cut each match after this many moves")
    ap.add_argument("-device", default=None,
                    help="torch device (default: cuda; 'cpu' to run on "
                         "the CPU)")
    args = ap.parse_args(argv)
    out = run_gatekeeper(args.test_models_dir, args.models_dir,
                         args.rejected_models_dir, size=args.size,
                         config_name=args.config, games=args.games,
                         visits=args.visits,
                         win_threshold=args.win_threshold,
                         max_moves=args.max_moves, device=args.device)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
