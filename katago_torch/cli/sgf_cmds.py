"""SGF data-mining commands — port of katago_tpu/cli/sgf_cmds.py.

References: cpp/command/evalsgf.cpp (analyze one SGF position, print
values), cpp/command/writetrainingdata.cpp (external SGFs -> training
npz rows for human-SL training), cpp/command/startposes.cpp (samplesgfs,
dataminesgfs, viewstartposes, checksgfhintpolicy: position files that
selfplay's startPosesFiles / hintPosesFiles consume).

Usage:
  python -m katago_torch.cli.sgf_cmds evalsgf game.sgf [-move-num N]
      [-model M] [-config b6c96] [-visits 64] [-device cpu]
  python -m katago_torch.cli.sgf_cmds writetrainingdata -sgf-dir D
      -output out.npz [-size 19] [-max-rows 10000] [-no-ladders]
  python -m katago_torch.cli.sgf_cmds startposes -sgf-dir D
      -output poses.jsonl [-sample-prob 0.05]
  python -m katago_torch.cli.sgf_cmds samplesgfs --sgfdir D --outdir O
      --sample-prob P
  python -m katago_torch.cli.sgf_cmds dataminesgfs --sgfdir D --outdir O
      --game-mode|--tree-mode|--surprise-mode [--model M] [--visits 300]
  python -m katago_torch.cli.sgf_cmds viewstartposes
      --start-poses-file F [--check-legality]
  python -m katago_torch.cli.sgf_cmds checksgfhintpolicy
      --start-poses-file F [--model M]

Every subcommand that replays or searches takes -device (--device for
the double-dash ones) and runs on CUDA unless it names another device;
with no CUDA device and no -device it raises. Positions of one game (or
of one candidate list) are replayed one by one and then featurized,
evaluated and searched as one batch.
"""

from __future__ import annotations

import argparse
import glob
import hashlib
import json
import os
import random

import numpy as np
import torch

from katago_torch import _tensortree as T
from katago_torch.dataio import sgf as S
from katago_torch.device import resolve_device
from katago_torch.game import board as B
from katago_torch.game import history as H
from katago_torch.game import rules as R

# positions featurized together by writetrainingdata (and the policy
# screens): one batched featurization and ladder solve each
FEATURE_BATCH = 256


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


def _stack_states(states: list) -> H.GameState:
    """One batch of the given one-game states (same max_hist)."""
    return T.tree_map(lambda *xs: torch.cat(xs), *states)


def _first_game(path: str):
    """The first game of an SGF file (SgfError / OSError propagate)."""
    with open(path) as f:
        return S.parse_sgf(f.read())[0]


def _score_of_result(result: str) -> float | None:
    """White-minus-black final score of an RE value (±1 for a
    resignation or an unnumbered win); None when there is no winner."""
    if result.startswith("B+"):
        return -float(result[2:]) if result[2:].replace(
            ".", "").isdigit() else -1.0
    if result.startswith("W+"):
        return float(result[2:]) if result[2:].replace(
            ".", "").isdigit() else 1.0
    return None


def cmd_writetrainingdata(args):
    """External SGFs -> reference-schema npz: per position, the played
    move as the policy target and the game result as value targets
    (writetrainingdata.cpp's core; search-derived targets absent with
    weights 0). The positions of every game are replayed first and then
    featurized in batches of FEATURE_BATCH (V7, exact ladders unless
    -no-ladders): one ladder solve per batch, not per position."""
    from katago_torch.dataio import trainingwrite as TW
    from katago_torch.models import features as F

    dev = resolve_device(args.device)
    files = sorted(glob.glob(os.path.join(args.sgf_dir, "*.sgf")))
    size = args.size
    nn1 = size * size + 1
    states, meta = [], []    # per row: (player, loc, turn, white score)
    for path in files:
        if len(meta) >= args.max_rows:
            break
        try:
            game = _first_game(path)
        except S.SgfError:
            continue
        xs, ys = game.size
        if xs != size or ys != size:
            continue
        score_w = _score_of_result(game.result or "")
        if score_w is None:
            continue
        moves = game.moves()[:args.max_rows - len(meta)]
        _, _, replayed, moves = _replay_moves(game, moves, dev)
        for i, (player, loc) in enumerate(moves):
            states.append(H.replace_pos(replayed[i], to_move=torch.tensor(
                [player], dtype=torch.int64, device=dev)))
            meta.append((player, loc, i, score_w))
    n_rows = len(meta)
    if n_rows == 0:
        raise SystemExit("no usable rows found")
    fp = F.FeatureParams.default(dev)
    spatial, global_in = [], []
    for lo in range(0, n_rows, FEATURE_BATCH):
        sp_f, gl_f = F.fill_features_v7(
            _stack_states(states[lo:lo + FEATURE_BATCH]), size, fp,
            with_ladders=not args.no_ladders)
        spatial.append(sp_f.cpu().numpy().reshape(-1, size, size, 22))
        global_in.append(gl_f.cpu().numpy())
    rows = {"policy": [], "value": [], "score": []}
    for player, loc, _, score_w in meta:
        pol = np.zeros(nn1, np.float32)
        pol[min(loc, nn1 - 1)] = 1.0
        sign = 1.0 if player == B.WHITE else -1.0
        rows["policy"].append(pol)
        rows["score"].append(score_w * sign)
        rows["value"].append([1.0 if score_w * sign > 0 else 0.0,
                              1.0 if score_w * sign < 0 else 0.0, 0.0])
    n = n_rows
    td = np.zeros((n, 5, 4), np.float32)
    val = np.asarray(rows["value"], np.float32)
    sc = np.asarray(rows["score"], np.float32)
    td[:, :, 0] = val[:, None, 0]
    td[:, :, 1] = val[:, None, 1]
    td[:, :, 3] = sc[:, None]
    arrays = TW.pack_rows(
        spatial=np.concatenate(spatial).astype(np.float32),
        global_in=np.concatenate(global_in).astype(np.float32),
        policy_target=np.asarray(rows["policy"], np.float32),
        next_policy_target=np.zeros((n, nn1), np.float32),
        value_target=val, td_targets=td, score_target=sc,
        lead_target=np.zeros(n, np.float32),
        ownership_target=np.zeros((n, size * size), np.float32),
        self_komi=np.zeros(n, np.float32),
        turn_idx=np.asarray([m[2] for m in meta], np.float32),
        visits=np.zeros(n, np.float32), size=size)
    # no search ownership/score-distr for external SGFs: weight 0
    arrays["globalTargetsNC"][:, 27] = 0.0
    TW.write_npz(args.output, arrays)
    print(json.dumps({"rows": n, "output": args.output,
                      "files_scanned": len(files)}))


def _stones_np(gs: H.GameState) -> np.ndarray:
    return gs.pos.board.stones[0].cpu().numpy().astype(np.int8)


def cmd_startposes(args):
    """Sample positions from SGFs into Sgf::PositionSample JSON lines
    (startposes.cpp), the wire format selfplay's startPosesFiles
    consume. Each sample stores the board a few moves before the
    sampled turn plus the context moves up to it; the sampled turn's
    move becomes hintLoc."""
    from katago_torch.dataio.poses import PositionSample
    dev = resolve_device(args.device)
    rng = random.Random(args.seed)
    files = sorted(glob.glob(os.path.join(args.sgf_dir, "*.sgf")))
    count = 0
    num_context = 2
    with open(args.output, "w") as out:
        for path in files:
            try:
                game = _first_game(path)
            except S.SgfError:
                continue
            xs, ys = game.size
            if xs != ys:
                continue
            moves = game.moves()
            states = None
            for i in range(len(moves)):
                if rng.random() >= args.sample_prob:
                    continue
                if states is None:
                    _, _, states, _ = _replay(game, device=dev)
                base = max(0, i - num_context)
                sample = PositionSample(
                    x_size=xs, y_size=ys, stones=_stones_np(states[base]),
                    next_pla=moves[base][0] if base < len(moves)
                    else B.BLACK,
                    moves=list(moves[base:i]),
                    initial_turn_number=base,
                    hint_loc=moves[i][1],
                    weight=1.0,
                    metadata=os.path.basename(path))
                out.write(sample.to_json_line() + "\n")
                count += 1
    print(json.dumps({"positions": count, "output": args.output}))


def _position_hash(stones: np.ndarray, next_pla: int) -> int:
    """Host-side dedup hash of (board, mover) for unique-position
    iteration (sgf.cpp iterAllUniquePositions's uniqueHashes)."""
    h = hashlib.blake2b(stones.tobytes() + bytes([next_pla]),
                        digest_size=8)
    return int.from_bytes(h.digest(), "little")


def _sgf_file_hash(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()[:32]


def _iter_sgf_files(args) -> list:
    files = list(getattr(args, "sgf", None) or [])
    for d in getattr(args, "sgf_dir", None) or []:
        files += sorted(glob.glob(os.path.join(d, "**", "*.sgf"),
                                  recursive=True))
    return files


def _excluded_hashes(args) -> set:
    exclude = set()
    for p in args.exclude_hashes or []:
        with open(p) as f:
            exclude |= {ln.strip() for ln in f if ln.strip()}
    return exclude


def cmd_samplesgfs(args):
    """Sample weighted start positions from SGFs — samplesgfs
    (startposes.cpp:76-833). Weight = sampleWeight *
    exp(-turn * turnWeightLambda) (afterPassFactor when the previous
    move passed); %NOSAMPLE% comments skip, %SAMPLE% forces
    force-sample-weight; positions dedup on (board, mover) across all
    inputs; outputs rotate through outdir/startposes.*.txt plus a
    hashes file for later --exclude-hashes runs."""
    from katago_torch.dataio.poses import PositionSample, PosWriter
    dev = resolve_device(args.device)
    rng = random.Random(args.seed)
    files = _iter_sgf_files(args)
    exclude = _excluded_hashes(args)
    writer = PosWriter("txt", args.outdir, base="startposes")
    seen: set = set()
    kept = 0
    weight_kept = 0.0
    num_context = 2
    with open(os.path.join(args.outdir, "sgfhashes.txt"), "w") as hashes:
        for path in files:
            fh = _sgf_file_hash(path)
            if fh in exclude:
                continue
            hashes.write(fh + "\n")
            try:
                game = _first_game(path)
            except (S.SgfError, OSError):
                continue
            xs, ys = game.size
            if xs != ys or game.handicap > args.max_handicap \
                    or abs(game.komi) > args.max_komi:
                continue
            moves = game.moves()
            area = xs * ys
            lo = args.min_turn_board_area_prop * area
            hi = args.max_turn_board_area_prop * area
            nodes = game.main_line()
            states = None
            for i in range(len(moves)):
                if not (lo <= i <= hi):
                    continue
                comment = (nodes[min(i, len(nodes) - 1)].get("C") or "")
                if "%NOSAMPLE%" in comment:
                    continue
                if rng.random() >= args.sample_prob \
                        and "%SAMPLE%" not in comment:
                    continue
                if states is None:
                    _, _, states, _ = _replay(game, device=dev)
                base = max(0, i - num_context)
                key = _position_hash(_stones_np(states[i]), moves[i][0])
                if key in seen:
                    continue
                seen.add(key)
                w = args.sample_weight * np.exp(-i * args.turn_weight_lambda)
                if i > 0 and moves[i - 1][1] == area:
                    w *= args.after_pass_factor
                if "%SAMPLE%" in comment:
                    w = max(w, args.force_sample_weight)
                if w < args.min_weight:
                    continue
                writer.write_pos(PositionSample(
                    x_size=xs, y_size=ys, stones=_stones_np(states[base]),
                    next_pla=moves[base][0] if base < len(moves)
                    else B.BLACK,
                    moves=list(moves[base:i]),
                    initial_turn_number=base,
                    hint_loc=-1, weight=float(w),
                    metadata=os.path.basename(path)))
                kept += 1
                weight_kept += w
    writer.flush_and_stop()
    print(json.dumps({"kept": kept, "weightKept": round(weight_kept, 3),
                      "files": len(files), "outdir": args.outdir}))


def _policy_probs(net, states: list, size: int, dev, fv: int,
                  bs: int = FEATURE_BATCH) -> np.ndarray:
    """softmax of the net's main policy head on each state's features
    (exact ladders), in batches of bs: float32[len(states), A]."""
    from katago_torch.models import features as F
    fp = F.FeatureParams.default(dev)
    out = []
    for lo in range(0, len(states), bs):
        batch = _stack_states(states[lo:lo + bs])
        legal = H.legal_moves(batch, size)
        spf, glf = F.fill_features(batch, size, fp, legal, version=fv)
        with torch.no_grad():
            raw = net(spf.reshape(legal.shape[0], size, size, -1), glf)
        out.append(torch.softmax(raw["policy_logits"][:, 0, :].float(),
                                 dim=-1).cpu().numpy())
    return np.concatenate(out)


def _surprise_weight(policy_prob: float) -> float:
    """surpriseWeight (startposes.cpp:812-832) without the random
    rounding: how interesting a low-prior move is."""
    if policy_prob < 0:
        return 0.0
    return max(0.12 / (policy_prob + 0.02) - 0.5, 0.0)


def search_tiers(visits: int) -> dict:
    """dataminesgfs's three search budgets: full, /5 and /25."""
    return {"full": visits, "quick": max(visits // 5, 8),
            "vquick": max(visits // 25, 4)}


def cmd_dataminesgfs(args):
    """Mine SGFs for surprising good moves — dataminesgfs
    (startposes.cpp:835-2136), redesigned for the batched engine:

    game-mode: every position whose PLAYED move has low policy prior
    (< --max-policy, sampled by surpriseWeight) is a candidate; all
    candidates across all games run THREE batched searches (full /5
    /25 visit tiers, one batch per tier instead of the reference's
    per-position thread pool). A candidate becomes a hint pos when the
    full search picks the played move, with the reference's weight
    shaping (value-fluctuation terms, quick-search discounts, turn
    lambda).

    surprise-mode: positions where the full search's value swings from
    the quick search's (|du| > 0.2 toward the mover = surprising good
    -> hint; against = inevitable bad -> plain sample).

    tree-mode: candidates come from every branch of the SGF tree
    (variations included), not just the main line."""
    from katago_torch.cli.match_cmd import load_net, net_feature_version
    from katago_torch.dataio.poses import PositionSample, PosWriter
    from katago_torch.search import mcts
    from katago_torch.search.params import SearchParams

    if int(args.game_mode) + int(args.tree_mode) \
            + int(args.surprise_mode) != 1:
        raise SystemExit("specify exactly one of --game-mode / "
                         "--tree-mode / --surprise-mode")
    dev = resolve_device(args.device)
    rng = random.Random(args.seed)
    files = _iter_sgf_files(args)
    exclude = _excluded_hashes(args)

    # ---- stage 1: collect candidate positions over all games ----------
    cands = []   # dict(state, played, pla, moves, i, path, xs)
    num_context = 2
    for path in files:
        if _sgf_file_hash(path) in exclude:
            continue
        try:
            game = _first_game(path)
        except (S.SgfError, OSError):
            continue
        xs, ys = game.size
        if xs != ys or xs != args.size \
                or game.handicap > args.max_handicap \
                or abs(game.komi) > args.max_komi:
            continue
        lines = _branch_lines(game) if args.tree_mode else [game.moves()]
        for moves in lines:
            if len(moves) < args.min_turn + 1:
                continue
            _, _, states, _ = _replay_moves(game, moves, dev)
            for i in range(args.min_turn, len(moves)):
                stones = states[i].pos.board.stones[0]
                if int(((stones == B.BLACK) | (stones == B.WHITE)).sum()) < 6:
                    continue
                cands.append(dict(state=states[i], played=moves[i][1],
                                  pla=moves[i][0], moves=moves, i=i,
                                  path=path, xs=xs))
    if not cands:
        print(json.dumps({"hints": 0, "candidates": 0}))
        return

    size = args.size
    net, _ = load_net(args.model, args.config, size, dev)
    fv = net_feature_version(net)

    # ---- stage 2: one batched NN screen over every candidate ----------
    pol = _policy_probs(net, [c["state"] for c in cands], size, dev, fv)
    priors = pol[np.arange(len(cands)), [c["played"] for c in cands]]

    if args.surprise_mode:
        keep = [c for c in cands
                if rng.random() < args.surprise_sample_prob]
    else:
        # game-mode and tree-mode share the low-prior gate
        # (maxPolicy + surpriseWeight sampling, startposes.cpp:1720)
        keep = []
        for j, c in enumerate(cands):
            w = _surprise_weight(float(priors[j]))
            if priors[j] <= args.max_policy and \
                    rng.random() < min(w, 1.0) + 0.05:
                c["surprise"] = w
                keep.append(c)
    if not keep:
        print(json.dumps({"hints": 0, "candidates": len(cands)}))
        return

    # ---- stage 3: three batched search tiers --------------------------
    sp = SearchParams(root_noise_enabled=False).to_arr(dev)
    results = {}
    roots = _stack_states([c["state"] for c in keep])
    with torch.no_grad():
        for name, visits in search_tiers(args.visits).items():
            gen = torch.Generator(device=dev).manual_seed(args.seed)
            res = mcts.run_search(net, roots, sp, gen, size=size,
                                  num_sims=visits, max_nodes=visits + 3,
                                  feature_version=fv)
            results[name] = dict(
                best=torch.argmax(res.child_visits, dim=1).cpu().numpy(),
                util=res.root_utility.cpu().numpy())

    # ---- stage 4: weight + write hints --------------------------------
    writer = PosWriter("txt", args.outdir, base="hintposes")
    hints = 0
    for j, c in enumerate(keep):
        du_q = abs(float(results["full"]["util"][j]
                         - results["quick"]["util"][j]))
        du_vq = abs(float(results["full"]["util"][j]
                          - results["vquick"]["util"][j]))
        full_best = int(results["full"]["best"][j])
        pla_sign = 1.0 if c["pla"] == B.WHITE else -1.0
        if args.surprise_mode:
            swing = pla_sign * float(results["full"]["util"][j]
                                     - results["vquick"]["util"][j])
            if swing > args.utility_threshold:
                hint, w = c["played"], 1.0 + abs(swing)
            elif swing < -args.utility_threshold:
                hint, w = -1, 1.0 + abs(swing)
            else:
                continue
        else:
            if full_best != c["played"]:
                continue
            w = c["surprise"] + du_q + du_vq
            if int(results["quick"]["best"][j]) == full_best:
                w = w * 0.75 - 0.1
            if int(results["vquick"]["best"][j]) == full_best:
                w = w * 0.75 - 0.1
            w *= float(np.exp(-c["i"] * args.turn_weight_lambda))
            if w <= 0.1:
                continue
            hint = c["played"]
        i, moves = c["i"], c["moves"]
        base = max(0, i - num_context)
        _, _, states, _ = _replay_moves(_first_game(c["path"]), moves[:i],
                                        dev)
        writer.write_pos(PositionSample(
            x_size=c["xs"], y_size=c["xs"], stones=_stones_np(states[base]),
            next_pla=moves[base][0],
            moves=list(moves[base:i]),
            initial_turn_number=base, hint_loc=hint,
            weight=float(w), metadata=os.path.basename(c["path"])))
        hints += 1
    writer.flush_and_stop()
    print(json.dumps({"hints": hints, "candidates": len(cands),
                      "searched": len(keep), "outdir": args.outdir}))


def _branch_lines(game: S.SgfGame) -> list:
    """All root-to-leaf move lines of the SGF tree (tree-mode walks
    variations, startposes.cpp treePosHandler)."""
    xs, ys = game.size
    lines = []

    def walk(node, moves):
        here = list(moves)
        for key, player in (("B", 1), ("W", 2)):
            if key in node.props:
                here.append((player,
                             S.parse_sgf_loc(node.props[key][0], xs, ys)))
        if not node.children:
            lines.append(here)
            return
        for ch in node.children:
            walk(ch, here)

    walk(game.root, [])
    return lines


def _pose_state(pose, size: int, dev, check: bool = False):
    """Replay a pose (its stones, then its context moves) on a fresh
    Tromp-Taylor game; returns (state, None) or, with check, (state,
    the first illegality found or None)."""
    gs = H.new_game(size, R.Rules.tromp_taylorish(), 2 * size * size + 32,
                    device=dev)
    for loc in range(pose.x_size * pose.y_size):
        if pose.stones[loc]:
            gs = H.setup_stone(gs, loc, int(pose.stones[loc]), size)

    def one(v):
        return torch.tensor([v], dtype=torch.int64, device=dev)

    for player, loc in pose.moves:
        gs = H.replace_pos(gs, to_move=one(player))
        if check and loc < size * size and \
                not bool(H.legal_moves(gs, size)[0, loc]):
            return gs, f"illegal context move {loc}"
        gs, _ = H.step(gs, one(loc), size)
    if check and 0 <= pose.hint_loc < size * size and \
            not bool(H.legal_moves(gs, size)[0, pose.hint_loc]):
        return gs, f"illegal hint {pose.hint_loc}"
    return gs, None


def cmd_viewstartposes(args):
    """Print startposes from pose files — viewstartposes
    (startposes.cpp:2138-2330): board + context moves + hint, filtered
    by --min-weight / --idx; --check-legality flags poses whose
    context moves or hint are illegal in our engine."""
    from katago_torch.dataio.poses import load_poses
    poses = load_poses(args.start_poses_file)
    dev = resolve_device(args.device) if args.check_legality else None
    shown = 0
    illegal = 0
    for idx, pose in enumerate(poses):
        if args.idx >= 0 and idx != args.idx:
            continue
        if pose.weight < args.min_weight:
            continue
        size = max(pose.x_size, pose.y_size)
        bad = None
        if args.check_legality:
            _, bad = _pose_state(pose, size, dev, check=True)
            if bad is None:
                continue   # check mode prints only problems
            illegal += 1
        print(f"--- pose {idx} weight {pose.weight:.3f} "
              f"nextPla {'B' if pose.next_pla == B.BLACK else 'W'} "
              f"hint {pose.hint_loc} {pose.metadata} "
              f"{('[' + bad + ']') if bad else ''}")
        print(B.board_to_string(pose.stones.astype(np.int32),
                                pose.x_size))
        shown += 1
    print(json.dumps({"poses": len(poses), "shown": shown,
                      "illegal": illegal}))


def cmd_checksgfhintpolicy(args):
    """Batch-check the net's policy mass on hint moves —
    checksgfhintpolicy (startposes.cpp:2332-2628): replays each hint
    pose, one batched forward over all of them, reports the hint's
    policy prob and rank (low-prob hints are the valuable ones)."""
    from katago_torch.cli.match_cmd import load_net, net_feature_version
    from katago_torch.dataio.poses import load_poses
    poses = [p for p in load_poses(args.start_poses_file)
             if p.hint_loc >= 0]
    if not poses:
        print(json.dumps({"hints": 0}))
        return
    dev = resolve_device(args.device)
    size = max(poses[0].x_size, poses[0].y_size)
    net, _ = load_net(args.model, args.config, size, dev)
    states = [_pose_state(pose, size, dev)[0] for pose in poses]
    pol = _policy_probs(net, states, size, dev, net_feature_version(net))
    probs = []
    ranks = []
    for j, pose in enumerate(poses):
        p = float(pol[j, pose.hint_loc])
        probs.append(p)
        ranks.append(int((pol[j] > p).sum()))
    for idx, (pose, p, rk) in enumerate(zip(poses, probs, ranks)):
        print(f"pose {idx} hint {pose.hint_loc} policy {p:.5f} "
              f"rank {rk} weight {pose.weight:.3f}")
    print(json.dumps({
        "hints": len(poses),
        "meanPolicy": round(float(np.mean(probs)), 5),
        "fracBelow2pct": round(float(np.mean(np.asarray(probs) < 0.02)),
                               4)}))


def _device_arg(p, *names):
    p.add_argument(*(names or ("-device",)), dest="device", default=None,
                   help="torch device (default: cuda; 'cpu' to run on "
                        "the CPU)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="command", required=True)

    ev = sub.add_parser("evalsgf")
    ev.add_argument("sgf")
    ev.add_argument("-move-num", type=int, default=None)
    ev.add_argument("-model", default=None)
    ev.add_argument("-config", default="b6c96")
    ev.add_argument("-visits", type=int, default=64)
    _device_arg(ev)
    ev.set_defaults(fn=cmd_evalsgf)

    wt = sub.add_parser("writetrainingdata")
    wt.add_argument("-sgf-dir", required=True)
    wt.add_argument("-output", required=True)
    wt.add_argument("-size", type=int, default=19)
    wt.add_argument("-max-rows", type=int, default=100000)
    wt.add_argument("-no-ladders", action="store_true")
    _device_arg(wt)
    wt.set_defaults(fn=cmd_writetrainingdata)

    st = sub.add_parser("startposes")
    st.add_argument("-sgf-dir", required=True)
    st.add_argument("-output", required=True)
    st.add_argument("-sample-prob", type=float, default=0.05)
    st.add_argument("-seed", type=int, default=0)
    _device_arg(st)
    st.set_defaults(fn=cmd_startposes)

    ss = sub.add_parser("samplesgfs")
    ss.add_argument("--sgf", action="append")
    ss.add_argument("--sgfdir", dest="sgf_dir", action="append")
    ss.add_argument("--outdir", required=True)
    ss.add_argument("--sample-prob", type=float, required=True)
    ss.add_argument("--sample-weight", type=float, default=1.0)
    ss.add_argument("--force-sample-weight", type=float, default=5.0)
    ss.add_argument("--turn-weight-lambda", type=float, default=0.0)
    ss.add_argument("--after-pass-factor", type=float, default=1.0)
    ss.add_argument("--min-weight", type=float, default=0.0)
    ss.add_argument("--min-turn-number-board-area-prop", type=float,
                    dest="min_turn_board_area_prop", default=0.0)
    ss.add_argument("--max-turn-number-board-area-prop", type=float,
                    dest="max_turn_board_area_prop", default=1e9)
    ss.add_argument("--max-handicap", type=int, default=9)
    ss.add_argument("--max-komi", type=float, default=150.0)
    ss.add_argument("--exclude-hashes", action="append")
    ss.add_argument("--seed", type=int, default=0)
    _device_arg(ss, "-device", "--device")
    ss.set_defaults(fn=cmd_samplesgfs)

    dm = sub.add_parser("dataminesgfs")
    dm.add_argument("--sgf", action="append")
    dm.add_argument("--sgfdir", dest="sgf_dir", action="append")
    dm.add_argument("--outdir", required=True)
    dm.add_argument("--model", default=None)
    dm.add_argument("--config", default="b6c96")
    dm.add_argument("--size", type=int, default=19)
    dm.add_argument("--game-mode", action="store_true")
    dm.add_argument("--tree-mode", action="store_true")
    dm.add_argument("--surprise-mode", action="store_true")
    dm.add_argument("--visits", type=int, default=300)
    dm.add_argument("--max-policy", type=float, default=0.1)
    dm.add_argument("--utility-threshold", type=float, default=0.2)
    dm.add_argument("--turn-weight-lambda", type=float, default=0.0)
    dm.add_argument("--surprise-sample-prob", type=float, default=1.0)
    dm.add_argument("--min-turn", type=int, default=0)
    dm.add_argument("--max-handicap", type=int, default=9)
    dm.add_argument("--max-komi", type=float, default=150.0)
    dm.add_argument("--exclude-hashes", action="append")
    dm.add_argument("--seed", type=int, default=0)
    _device_arg(dm, "-device", "--device")
    dm.set_defaults(fn=cmd_dataminesgfs)

    vs = sub.add_parser("viewstartposes")
    vs.add_argument("--start-poses-file", action="append", required=True)
    vs.add_argument("--min-weight", type=float, default=0.0)
    vs.add_argument("--idx", type=int, default=-1)
    vs.add_argument("--check-legality", action="store_true")
    _device_arg(vs, "-device", "--device")
    vs.set_defaults(fn=cmd_viewstartposes)

    ch = sub.add_parser("checksgfhintpolicy")
    ch.add_argument("--start-poses-file", action="append", required=True)
    ch.add_argument("--model", default=None)
    ch.add_argument("--config", default="b6c96")
    _device_arg(ch, "-device", "--device")
    ch.set_defaults(fn=cmd_checksgfhintpolicy)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
