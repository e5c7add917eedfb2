"""Selfplay driver: batched MCTS games producing training data — port of
katago_tpu/selfplay/loop.py.

A whole batch of games advances one move per iteration in lockstep:
each move runs one batched array-MCTS (every NN eval inside the search is
a [G]-batch), then all games step their chosen moves. Recorded rows
mirror the reference's FinishedGameData (dataio/trainingwrite.h:183-290):
per position the V7 features (ladder planes from the exact solver), the
root visit-distribution policy target and the side to move; per game the
final result and ownership, broadcast back over the game's rows at the
end.

Everything runs on the caller's device (CUDA unless the caller passes
device="cpu"); random draws come from the caller's torch.Generator, and
the host-side draws (cheap/full mixing, opening lengths, komi) from a
numpy generator seeded from it. With a `mesh` (parallel/mesh.py) the
game axis is split over the ranks of a torch.distributed process group:
each rank sets up the whole batch, keeps its slice of the games, and the
ranks agree each move on the reused visits and on whether every game has
ended (as the JAX package's sharded arrays do); the recorded rows are
gathered at the end. Each rank draws its device randomness from its own
stream, so the games equal the unsharded run's where no such draw
matters.
"""

from __future__ import annotations

import copy
import dataclasses
import time

import numpy as np
import torch

from katago_torch import _tensortree as T
from katago_torch.dataio import trainingwrite as TW
from katago_torch.device import resolve_device
from katago_torch.game import benson
from katago_torch.game import board as B
from katago_torch.game import history as H
from katago_torch.game import rules as R
from katago_torch.game import zobrist
from katago_torch.models import features as F
from katago_torch.models import model as M
from katago_torch.search import mcts
from katago_torch.search.params import SearchParams
from katago_torch.selfplay import gameinit as GI
from katago_torch.selfplay import playsettings as PS


@dataclasses.dataclass
class GameBatchData:
    """Host-side recorded training rows for a finished batch of games."""
    spatial: np.ndarray        # [rows, N, N, 22] f32
    global_in: np.ndarray      # [rows, 19] f32
    policy_target: np.ndarray  # [rows, NN+1] f32 (normalized visit dist)
    to_move: np.ndarray        # [rows] i32
    value_target: np.ndarray   # [rows, 3] f32 (win/loss/noresult, mover persp)
    score_target: np.ndarray   # [rows] f32 (mover perspective final score)
    ownership_target: np.ndarray  # [rows, NN] f32 (+1 mover, -1 opp)
    game_idx: np.ndarray       # [rows] i32
    move_num: np.ndarray       # [rows] i32
    mcts_winloss_white: np.ndarray  # [rows] f32 root MCTS winloss (white persp)
    mcts_lead_white: np.ndarray     # [rows] f32 root MCTS lead (white persp)
    visits: np.ndarray              # [rows] i32 search visits for the row
    mcts_score_white: np.ndarray    # [rows] f32 root MCTS score (white persp)
    stones: np.ndarray              # [rows, NN] i8 board before the move
    q_winloss_white: np.ndarray     # [rows, NN+1] f32 child winloss (white)
    q_score_white: np.ndarray       # [rows, NN+1] f32 child score (white)
    q_visits: np.ndarray            # [rows, NN+1] i32 child visits
    seki_diff_mover: np.ndarray     # [rows, NN] f32 full-area-vs-ownership
    policy_prior: np.ndarray        # [rows, NN+1] f32 root prior

    def to_npz_arrays(self, size: int, final_score_white: np.ndarray,
                      komi_white: np.ndarray | None = None) -> dict:
        """Reference-schema arrays (dataio.trainingwrite.pack_rows): full
        td-value groups (win/loss/noresult/score blends of per-turn MCTS
        estimates ending at the game result), variance-time, future
        positions (+8/+32 turns), seki diff, per-point scoring, q-value
        targets, per-game row-group hashes."""
        n = self.spatial.shape[0]
        area = size * size
        is_white = (self.to_move == B.WHITE)
        sign = np.where(is_white, 1.0, -1.0).astype(np.float32)

        # next-turn policy: the following row of the same game
        next_pol = np.zeros_like(self.policy_target)
        same_game_next = np.zeros(n, bool)
        same_game_next[:-1] = (self.game_idx[:-1] == self.game_idx[1:]) & \
                              (self.move_num[:-1] + 1 == self.move_num[1:])
        next_pol[np.flatnonzero(same_game_next)] = \
            self.policy_target[np.flatnonzero(same_game_next) + 1]

        # per-game td groups + variance time + future boards (white persp,
        # flipped to mover at the end)
        td5 = np.zeros((n, 5, 4), np.float32)
        vartime = np.zeros((n,), np.float32)
        fpos = np.zeros((n, 2, area), np.float32)     # absolute colors first
        ghash = np.zeros((n,), np.uint64)
        for g in np.unique(self.game_idx):
            rows = np.flatnonzero(self.game_idx == g)
            t = len(rows)
            final_sc = float(final_score_white[g])
            final_wl = float(np.sign(final_sc))
            wt = np.zeros((t + 1, 4), np.float32)     # win,loss,nr,score
            wl = self.mcts_winloss_white[rows]
            wt[:t, 0] = 0.5 * (1.0 + wl)
            wt[:t, 1] = 0.5 * (1.0 - wl)
            wt[:t, 3] = self.mcts_score_white[rows]
            wt[t] = [0.5 * (1 + final_wl), 0.5 * (1 - final_wl), 0.0,
                     final_sc]
            td5[rows] = TW.td_groups(wt, area)
            vartime[rows] = TW.variance_time_target(
                np.concatenate([wl, [final_wl]]))
            # future boards at +8 / +32 turns (trainingwrite.cpp:790-792)
            st = self.stones[rows]                     # [t, area] colors
            i8 = np.minimum(np.arange(t) + 8, t - 1)
            i32_ = np.minimum(np.arange(t) + 32, t - 1)
            fpos[rows, 0] = st[i8]
            fpos[rows, 1] = st[i32_]
            ghash[rows] = np.uint64(
                ((0x9E3779B97F4A7C15 * (int(g) + 1)) ^
                 (abs(int(final_sc * 2)) + 1)) % (1 << 64))

        # flip white-persp channels to mover persp
        td_mover = td5.copy()
        td_mover[:, :, 0] = np.where(is_white[:, None], td5[:, :, 0],
                                     td5[:, :, 1])
        td_mover[:, :, 1] = np.where(is_white[:, None], td5[:, :, 1],
                                     td5[:, :, 0])
        td_mover[:, :, 3] = td5[:, :, 3] * sign[:, None]
        cap = float(area + TW.EXTRA_SCORE_DISTR_RADIUS)
        td_mover[:, :, 3] = np.clip(td_mover[:, :, 3], -cap, cap)

        # future positions: colors -> mover persp +-1
        mover = self.to_move[:, None, None]
        fpos_mover = np.where(fpos == mover, 1.0,
                              np.where(fpos == 0, 0.0, -1.0)).astype(
            np.float32)

        # per-point scoring (C4): final ownership is the per-point score
        # under area scoring (mover persp, in [-1,1])
        scoring = self.ownership_target.astype(np.float32)

        # policy-surprise row weighting (playsettings.h:56)
        row_weight = PS.policy_surprise_weights(
            self.policy_target, self.policy_prior,
            np.ones(n, np.float32), 0.5)

        lead_mover = self.mcts_lead_white * sign
        if komi_white is None:
            komi_mover = np.zeros(n, np.float32)
        else:
            komi_mover = komi_white[self.game_idx] * sign
        return TW.pack_rows(
            spatial=self.spatial, global_in=self.global_in,
            policy_target=self.policy_target, next_policy_target=next_pol,
            value_target=self.value_target, td_targets=td_mover,
            score_target=self.score_target, lead_target=lead_mover,
            ownership_target=self.ownership_target, self_komi=komi_mover,
            turn_idx=self.move_num.astype(np.float32),
            visits=self.visits.astype(np.float32), size=size,
            variance_time=vartime,
            futurepos=fpos_mover,
            seki_diff=self.seki_diff_mover,
            scoring=scoring,
            q_winloss=self.q_winloss_white * sign[:, None],
            q_score=self.q_score_white * sign[:, None],
            q_visits=self.q_visits,
            game_hash=ghash,
            row_weight=row_weight)


def _place_handicap(games: H.GameState, num_handicap: np.ndarray,
                    size: int) -> H.GameState:
    """Pre-place fixed-pattern black handicap stones, give white the move,
    and rebuild the position hashes (the reference places handicap with
    the net's policy, PlayUtils::playExtraBlack; the fixed star-point
    pattern is its GTP-flavored equivalent)."""
    dev = games.hist_len.device
    stones = games.pos.board.stones.clone()
    to_move = games.pos.to_move.clone()
    hashes = games.pos.board.pos_hash.clone()
    zst = zobrist.stone_table(size, dev)
    for g in range(num_handicap.shape[0]):
        k = int(num_handicap[g])
        if k < 2:
            continue
        for loc in GI.fixed_handicap_locs(size, k):
            stones[g, loc] = B.BLACK
            hashes[g] = hashes[g] ^ zst[B.BLACK - 1, loc]
        to_move[g] = B.WHITE
    board = dataclasses.replace(games.pos.board, stones=stones,
                                pos_hash=hashes)
    # prev-board snapshots clamp to the handicapped starting board
    # (getRecentBoard semantics)
    games = H.replace_pos(games, board=board,
                          prev_stones=stones.to(torch.int8),
                          prev_prev_stones=stones.to(torch.int8),
                          to_move=to_move)
    # re-record the starting ko-hash (new_game recorded the empty board)
    hist = games.ko_hash_hist.clone()
    hist[:, 0] = H._pos_ko_hash(games.pos, games.rules)
    return dataclasses.replace(games, ko_hash_hist=hist)


def _adjust_komi_to_even(games: H.GameState, flags: np.ndarray,
                         model: torch.nn.Module, feat_params,
                         size: int) -> H.GameState:
    """Set komi so the net predicts an even game where flagged
    (PlayUtils::adjustKomiToEven via the lead head): one batched eval,
    komi -= white lead, rounded to the half-integer grid."""
    sp_feat, gl_feat = F.fill_features(games, size, feat_params, None)
    g_n = sp_feat.shape[0]
    with torch.no_grad():
        raw = model(sp_feat.reshape(g_n, size, size, -1).float(), gl_feat)
    lead_mover = M.postprocess_outputs(raw)["lead"].float().cpu().numpy()
    to_move = games.pos.to_move.cpu().numpy()
    white_lead = np.where(to_move == B.WHITE, lead_mover, -lead_mover)
    komi = games.rules.komi.cpu().numpy().astype(np.float32)
    new_komi = np.round((komi - white_lead) * 2.0) / 2.0
    komi = np.where(flags, new_komi.astype(np.float32), komi)
    return dataclasses.replace(games, rules=dataclasses.replace(
        games.rules, komi=torch.from_numpy(komi).to(games.hist_len.device)))


def _place_start_positions(games: H.GameState, start_samples: list,
                           size: int) -> H.GameState:
    """Install sampled start positions (Sgf::PositionSample /
    startPosesProb, selfplay.cpp:182-207): set the sample's stones as the
    starting board, replay its context moves (restoring ko state), and
    adopt its turn number."""
    dev = games.hist_len.device
    max_hist = games.ko_hash_hist.shape[1]
    for g, sample in enumerate(start_samples):
        if sample is None or sample.x_size != size or sample.y_size != size:
            continue
        rules_g = T.tree_map(lambda a: a[g:g + 1], games.rules)
        gs = H.new_game(size, rules_g, max_hist, g=1)
        gs = H.setup_board(gs, torch.as_tensor(
            np.asarray(sample.stones, np.int32))[None], size)

        def one(v):
            return torch.tensor([v], dtype=torch.int64, device=dev)
        gs = H.replace_pos(gs, to_move=one(sample.next_pla))
        for pla, loc in sample.moves:
            gs = H.replace_pos(gs, to_move=one(pla))
            gs, _ = H.step(gs, one(loc), size)
        gs = H.replace_pos(gs, move_num=one(
            sample.initial_turn_number + len(sample.moves)))
        games = T.tree_map(lambda store, v: _set_row(store, g, v), games, gs)
    return games


def _gather_games(mesh, rows: list, per_game: tuple, playouts: int):
    """Every rank's move records and per-game arrays joined on the game
    axis in rank order (the unsharded batch), and the playouts summed.
    The ranks record in lockstep, so record i is the same move on
    every rank."""
    from katago_torch.parallel import mesh as PM
    parts = PM.gather_objects((rows, per_game, playouts), mesh)
    joined = []
    for i, rec in enumerate(parts[0][0]):
        joined.append({k: v if k == "row_visits" else np.concatenate(
            [p[0][i][k] for p in parts], axis=0) for k, v in rec.items()})
    arrays = tuple(np.concatenate([p[1][j] for p in parts], axis=0)
                   for j in range(len(per_game)))
    return joined, arrays, sum(p[2] for p in parts)


def _set_row(store: torch.Tensor, g: int, v: torch.Tensor) -> torch.Tensor:
    out = store.clone()
    out[g] = v[0]
    return out


def _categorical(logits, gen: torch.Generator):
    """One draw per row from softmax(logits) (-inf = never), by the
    Gumbel-max trick on the given generator."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=1e-20,
                                               max=1.0 - 1e-7)))
    return torch.argmax(logits + gumbel, dim=1)


def play_games(model: torch.nn.Module, *, size: int, num_games: int,
               visits: int, rules: R.Rules | None = None,
               search_params: SearchParams | None = None,
               max_moves: int | None = None,
               gen: torch.Generator | None = None,
               device=None,
               record: bool = True,
               tree_reuse: bool = True,
               play_settings: PS.PlaySettings | None = None,
               game_rules: H.RulesArr | None = None,
               num_handicap: np.ndarray | None = None,
               compensate_komi: np.ndarray | None = None,
               early_fork: np.ndarray | None = None,
               start_samples: list | None = None,
               resign_threshold: float = 0.0,
               resign_consec_turns: int = 3,
               ladder_mode: str = "chase",
               params_provider=None,
               mesh=None,
               timings: dict | None = None
               ) -> tuple[GameBatchData | None, dict]:
    """Play a batch of selfplay games to completion. Returns recorded data
    and summary stats (moves, scores, winners).

    model: the net, on `device` (CUDA unless the caller names another).
    gen: the torch.Generator on that device for every random draw
    (default: seed 0); the host-side numpy generator is seeded from it.

    play_settings: PlaySettings data-quality knobs (policy-init openings,
    cheap/full search mixing — cheap-search moves advance the game but are
    not recorded, matching cheapSearchTargetWeight=0).

    GameInitializer diversity (selfplay.gameinit): game_rules is a
    per-game RulesArr [G]; num_handicap[g] places that many fixed-pattern
    black stones and gives white the move; compensate_komi[g] adjusts
    komi to an even game via one net lead estimate
    (PlayUtils::adjustKomiToEven); early_fork[g] replaces the game's last
    policy-init move with a uniform-random legal move (forkGame
    divergence); start_samples[g] starts the game from a pose.

    resign_threshold: e.g. -0.95 — a game ends as a resignation loss when
    the mover's root winloss stays below it for resign_consec_turns full
    searches. 0 disables.

    ladder_mode: the in-search leaf ladder solver; recorded rows always
    use the exact solver.

    params_provider: optional callable () -> state_dict or None, polled
    every 16 moves; a state_dict takes over the rest of every live game
    (mid-game net switching, selfplay.cpp:336-343). It is loaded into a
    copy of `model`: the caller's module keeps its weights, as the JAX
    package's caller keeps its params.

    timings: optional dict that collects, synchronising the device at
    each boundary, the seconds spent in search, move choice, row
    featurization and board steps, the move counts, and the exact
    solver's stats (under "ladder").

    mesh: a parallel.mesh.Mesh — each rank plays num_games / ranks of
    the games (its slice; num_games must divide evenly) on mesh.device
    and every rank returns the data and stats of all the games. The host
    draws (komi, opening lengths, cheap or full searches) are made for
    the whole batch on every rank. The device draws (root noise, move
    sampling) are made per slice: rank 0 draws from gen, every other
    rank from a generator seeded from gen's first draw and its rank, so
    no two ranks' games share their draws. The games equal the
    unsharded run's where no device draw matters (no root noise,
    temperature 0, no policy-init openings)."""
    from katago_torch.parallel import mesh as PM
    if mesh is not None:
        PM.check_divisible(num_games, mesh, "num_games")
        device = mesh.device
    dev = resolve_device(device)
    gen = gen if gen is not None else \
        torch.Generator(device=dev).manual_seed(0)
    nn = size * size
    rules = rules or R.Rules.tromp_taylorish()
    sp = (search_params or SearchParams.for_selfplay()).to_arr(dev)
    ps = play_settings or PS.PlaySettings.for_testing(visits)
    max_moves = max_moves or int(nn * 1.6) + 20
    host_seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen,
                                  device=dev))
    host_rng = np.random.default_rng(host_seed)

    def clock(key, t0):
        """Add the seconds since t0 to timings[key]; returns now."""
        if timings is None:
            return 0.0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        timings[key] = timings.get(key, 0.0) + now - t0
        return now

    games = H.new_game(size, rules, max_moves + 8, g=num_games, device=dev)
    if game_rules is not None:
        games = dataclasses.replace(games, rules=game_rules)
        komi_white = game_rules.komi.cpu().numpy().astype(np.float32)
    else:
        # per-game komi randomization (GameInitializer)
        komi_white = PS.sample_komis(rules.komi, ps, num_games, host_rng)
        games = dataclasses.replace(games, rules=dataclasses.replace(
            games.rules, komi=torch.from_numpy(komi_white).to(dev)))
    if num_handicap is not None and (num_handicap > 0).any():
        games = _place_handicap(games, num_handicap, size)
    if start_samples is not None and any(st is not None
                                         for st in start_samples):
        games = _place_start_positions(games, start_samples, size)

    # cheap and full searches share one node-pool shape so tree reuse works
    # across budget switches; the pool is sized ~2x the visit budget so
    # reused subtrees keep their value (search.h:253-257 tree reuse)
    max_nodes = 2 * visits + 16
    cheap_visits = min(max(ps.cheap_search_visits, 2), visits)
    # a top-up of n playouts runs the next count of this grid, as the JAX
    # package's one compiled search per grid point does
    sims_grid = sorted({0, max(1, visits // 8), max(1, visits // 4),
                        visits // 2, (3 * visits) // 4, visits,
                        cheap_visits})

    def search(n_sims, prev, mv_cap):
        q = next(s for s in sims_grid if s >= min(n_sims, visits))
        pt, pa = prev if prev is not None else (None, None)
        return mcts.run_search(model, games, sp, gen, size=size,
                               num_sims=q, max_nodes=max_nodes,
                               ladder_mode=ladder_mode, prev_tree=pt,
                               prev_actions=pa, max_visits=mv_cap)

    feat_params = mcts._feature_params(sp)
    if compensate_komi is not None and compensate_komi.any():
        games = _adjust_komi_to_even(games, compensate_komi, model,
                                     feat_params, size)
        komi_white = games.rules.komi.cpu().numpy().astype(np.float32)

    # per-game policy-init opening lengths (PlaySettings policyInitAvgMoveNum)
    if ps.init_games_with_policy and ps.policy_init_avg_move_num > 0:
        init_len = host_rng.exponential(
            ps.policy_init_avg_move_num, size=num_games).astype(np.int32)
    else:
        init_len = np.zeros(num_games, np.int32)
    if early_fork is not None and early_fork.any():
        # fork games diverge with one uniform-random legal move at the end
        # of their (forced nonzero) opening
        init_len = np.where(early_fork, np.maximum(init_len, 2), init_len)
    if mesh is not None:
        # every host draw above was made for the whole batch; keep this
        # rank's games
        row0, num_games = PM.process_batch_slice(num_games, mesh)
        mine = slice(row0, row0 + num_games)
        games = T.tree_map(lambda x: x[mine], games)
        komi_white, init_len = komi_white[mine], init_len[mine]
        if early_fork is not None:
            early_fork = early_fork[mine]
        # this rank's own stream of device draws
        gen = PM.rank_generator(gen, host_seed, mesh)

    rows = []  # host-side per-move records
    total_playouts = 0
    prev = None   # (tree, actions) for Search::makeMove-style reuse
    reused_visits = 0  # min over games of the re-rooted subtree's visits
    resign_below = np.zeros(num_games, np.int32)
    resigned_by = np.zeros(num_games, np.int32)  # player who resigned, 0=none
    resign_score = np.zeros(num_games, np.float32)  # root score at resign
    ladder_stats = None if timings is None else timings.setdefault(
        "ladder", {})
    t = clock("setup_s", time.perf_counter())
    for move_i in range(max_moves):
        done = games.pos.game_over.cpu().numpy() | (resigned_by != 0)
        if PM.all_true(bool(done.all()), mesh):
            break
        if params_provider is not None and move_i % 16 == 0:
            # mid-game net switching (selfplay.cpp:336-343): a freshly
            # exported model takes over the rest of every live game
            new_params = params_provider()
            if new_params is not None:
                model = copy.deepcopy(model)
                model.load_state_dict(new_params)
        # cheap/full decision per move (cheapSearchProb)
        is_full = host_rng.random() >= ps.cheap_search_prob
        move_visits = visits if is_full else cheap_visits
        mv_cap = move_visits + 1   # root visit = playouts + 1
        if prev is None or not tree_reuse:
            n_new = move_visits
            res = search(n_new, None, mv_cap)
        else:
            # top-up: only the playouts the reused subtree is missing
            n_new = move_visits + 1 - reused_visits
            res = search(n_new, prev, mv_cap)
        t = clock("search_s", t)
        move_num = games.pos.move_num.cpu().numpy()
        moves = mcts.choose_moves(res, sp, games.pos.move_num, gen)
        # policy-init: in-opening games sample from the raw prior instead
        in_init = (move_num < init_len) & ~done
        if in_init.any():
            prior = res.root_policy_prior
            logits = torch.where(prior > 0, torch.log(torch.clamp(
                prior, min=1e-10)), -torch.inf)
            pol_moves = _categorical(logits, gen)
            moves = torch.where(torch.from_numpy(in_init).to(dev),
                                pol_moves, moves)
            # fork divergence: the LAST opening move of a fork game is
            # uniform over legal moves (forkGame, play.cpp)
            if early_fork is not None:
                fork_now = early_fork & (move_num == init_len - 1) & ~done
                if fork_now.any():
                    uni = torch.where(prior > 0, 0.0, -torch.inf)
                    moves = torch.where(torch.from_numpy(fork_now).to(dev),
                                        _categorical(uni, gen), moves)
        # resignation (gtp.cpp:276-324 semantics): the mover resigns when
        # their root winloss stays below the threshold for N full searches
        if resign_threshold < 0.0 and is_full:
            wl_white = res.root_winloss.float().cpu().numpy()
            tm = games.pos.to_move.cpu().numpy()
            wl_mover = np.where(tm == B.WHITE, wl_white, -wl_white)
            bad = (wl_mover < resign_threshold) & ~done
            resign_below = np.where(bad, resign_below + 1, 0)
            newly = (resign_below >= resign_consec_turns) & (resigned_by == 0)
            if newly.any():
                resigned_by = np.where(newly, tm, resigned_by)
                resign_score = np.where(
                    newly, res.root_score_mean.float().cpu().numpy(),
                    resign_score)
                # end those games on the device too (step becomes a no-op)
                games = H.replace_pos(
                    games, game_over=games.pos.game_over
                    | torch.from_numpy(newly).to(dev))
        if tree_reuse:
            prev = (res.ss.tree, moves)
            # the next move's top-up budget is what the re-rooted subtree
            # is still missing; conservatively the min over live games
            cv = res.child_visits.cpu().numpy()
            rv = cv[np.arange(num_games), moves.cpu().numpy()]
            live = ~done
            reused_visits = PM.min_int(
                int(rv[live].min()) if live.any() else None, mesh, 0)
        total_playouts += int((~done).sum()) * max(n_new, 0)
        t = clock("choose_s", t)

        # cheap-search and policy-init rows are not recorded
        # (cheapSearchTargetWeight = 0, playsettings.h:47)
        if record and is_full:
            sp_feat, gl_feat = F.fill_features(
                games, size, feat_params, None, ladder_stats=ladder_stats)
            cvis = res.child_visits.cpu().numpy().astype(np.float32)
            denom = np.maximum(cvis.sum(axis=1, keepdims=True), 1.0)

            def host(x, dt=np.float32):
                return x.cpu().numpy().astype(dt)

            rows.append({
                "spatial": host(sp_feat).reshape(
                    num_games, size, size, F.NUM_SPATIAL_V7),
                "global_in": host(gl_feat),
                "policy_target": cvis / denom,
                "to_move": host(games.pos.to_move, np.int32),
                "move_num": move_num.astype(np.int32),
                "mcts_winloss_white": host(res.root_winloss),
                "mcts_lead_white": host(res.root_lead),
                "mcts_score_white": host(res.root_score_mean),
                "stones": host(games.pos.board.stones, np.int8),
                "q_winloss_white": host(res.child_winloss),
                "q_score_white": host(res.child_score_mean),
                "q_visits": host(res.child_visits, np.int32),
                "policy_prior": host(res.root_policy_prior),
                "row_visits": move_visits,
                "live": ~done & ~in_init,
            })
            t = clock("features_s", t)
            if timings is not None:
                timings["recorded_moves"] = \
                    timings.get("recorded_moves", 0) + 1
        games, _ = H.step(games, moves, size)
        t = clock("step_s", t)
        if timings is not None:
            timings["moves"] = timings.get("moves", 0) + 1

    own, score_w = H.final_score_area(games, size)
    own = own.cpu().numpy().astype(np.float32)        # +1 black / -1 white
    score_w = score_w.cpu().numpy().astype(np.float32)  # white minus black
    if (resigned_by != 0).any():
        # resignation result: winner = opponent; score target from the
        # search's own estimate, sign-clamped to the resignation outcome
        score_w = np.where(
            resigned_by == B.BLACK, np.maximum(resign_score, 0.5),
            np.where(resigned_by == B.WHITE,
                     np.minimum(resign_score, -0.5), score_w))
    # full "naive" area for the seki-diff target (valueTargetsNCHW C1)
    full_area = benson.calculate_area(
        games.pos.board.stones, size, True, True, True,
        games.rules.multi_suicide).cpu().numpy().astype(np.int32)
    game_over = games.pos.game_over.cpu().numpy()
    move_nums = games.pos.move_num.cpu().numpy().astype(np.int32)
    if mesh is not None:
        rows, (komi_white, own, score_w, full_area, game_over, move_nums,
               resigned_by), total_playouts = _gather_games(
            mesh, rows, (komi_white, own, score_w, full_area, game_over,
                         move_nums, resigned_by), total_playouts)
    stats = {
        "komi_white": komi_white,
        "moves_per_game": move_nums,
        "white_minus_black": score_w,
        "white_wins": (score_w > 0).sum(),
        "black_wins": (score_w < 0).sum(),
        "all_finished": bool(game_over.all()),
        "total_playouts": total_playouts,
        "resignations": int((resigned_by != 0).sum()),
    }
    clock("finish_s", t)
    if not record:
        return None, stats

    # assemble rows with game-outcome targets from the mover's perspective
    out = {f.name: [] for f in dataclasses.fields(GameBatchData)}
    # seki diff (white-persp colors): full-area owner of points that ended
    # up unowned (trainingwrite.cpp:750-752)
    own_color = np.where(own > 0, B.BLACK, np.where(own < 0, B.WHITE, 0))
    seki_pts = (full_area != 0) & (own_color == 0)
    seki_black = seki_pts & (full_area == B.BLACK)
    seki_white = seki_pts & (full_area == B.WHITE)
    for rec in rows:
        idxs = np.flatnonzero(rec["live"])
        if len(idxs) == 0:
            continue
        tm = rec["to_move"][idxs]
        is_white = (tm == B.WHITE).astype(np.float32)
        sw = score_w[idxs]
        score_mover = np.where(is_white > 0, sw, -sw)
        win = (score_mover > 0).astype(np.float32)
        loss = (score_mover < 0).astype(np.float32)
        draw = 1.0 - win - loss
        value_t = np.stack([win + 0.5 * draw, loss + 0.5 * draw,
                            np.zeros_like(win)], axis=-1)
        own_mover = np.where(is_white[:, None] > 0, -own[idxs], own[idxs])
        seki_mover = np.where(
            seki_black[idxs], np.where(is_white[:, None] > 0, -1.0, 1.0),
            np.where(seki_white[idxs],
                     np.where(is_white[:, None] > 0, 1.0, -1.0), 0.0))
        out["spatial"].append(rec["spatial"][idxs])
        out["global_in"].append(rec["global_in"][idxs])
        out["policy_target"].append(rec["policy_target"][idxs])
        out["to_move"].append(tm)
        out["value_target"].append(value_t)
        out["score_target"].append(score_mover)
        out["ownership_target"].append(own_mover)
        out["game_idx"].append(idxs.astype(np.int32))
        out["move_num"].append(rec["move_num"][idxs])
        out["mcts_winloss_white"].append(rec["mcts_winloss_white"][idxs])
        out["mcts_lead_white"].append(rec["mcts_lead_white"][idxs])
        out["visits"].append(np.full(len(idxs), rec["row_visits"], np.int32))
        out["mcts_score_white"].append(rec["mcts_score_white"][idxs])
        out["stones"].append(rec["stones"][idxs])
        out["q_winloss_white"].append(rec["q_winloss_white"][idxs])
        out["q_score_white"].append(rec["q_score_white"][idxs])
        out["q_visits"].append(rec["q_visits"][idxs])
        out["seki_diff_mover"].append(seki_mover.astype(np.float32))
        out["policy_prior"].append(rec["policy_prior"][idxs])

    data = GameBatchData(**{k: np.concatenate(v, axis=0)
                            for k, v in out.items()})
    return data, stats
