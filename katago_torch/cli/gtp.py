"""GTP engine — port of katago_tpu/cli/gtp.py (reference
cpp/command/gtp.cpp).

Speaks standard GTP plus the reference's kata-* extensions: rules get/set,
kata-raw-nn, streaming kata-analyze / lz-analyze (interval info lines with
multi-move PVs and ownership, interrupted by the next command), the
genmove_analyze family, time-managed search through the chunked
SearchDriver, pondering (AsyncSearch between moves), anti-mirror,
avoidRepeatedPatternUtility (search/patternbonus.py) and resignation.
Serves any reference net the parser reads: V3-V6 nets get their own
input features, and a humanSL net (metadata encoder) is conditioned on
the humanSLProfile config's profile in its searches and in
kata-raw-human-nn. Searches one game at a time on `device` (CUDA unless
`-device cpu`; with no CUDA and no -device it raises). Every command
answers with the JAX engine's text.

Usage: python -m katago_torch.cli.gtp [-model <path.bin.gz>]
       [-config <cfg>] [-override-config k=v,...] [-visits N]
       [-boardsize N] [-device cpu|cuda] [-seed N]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import select
import sys
import time

import numpy as np
import torch

from katago_torch.device import resolve_device
from katago_torch.game import board as B
from katago_torch.game import history as H
from katago_torch.game import rules as R
from katago_torch.search import mcts
from katago_torch.search import timecontrols as TC
from katago_torch.search.driver import (AsyncSearch, SearchDriver,
                                        split_generator)
from katago_torch.search.params import SearchParams
from katago_torch.selfplay.gameinit import fixed_handicap_locs
from katago_torch.utils.config_parser import ConfigParser

GTP_COLS = "ABCDEFGHJKLMNOPQRSTUVWXYZ"  # no I

KNOWN_COMMANDS = [
    "protocol_version", "name", "version", "known_command", "list_commands",
    "quit", "boardsize", "rectangular_boardsize", "clear_board", "komi",
    "get_komi", "kata-get-komi", "play", "genmove", "undo", "showboard",
    "final_score",
    "final_status_list", "fixed_handicap", "place_free_handicap",
    "set_free_handicap", "time_settings", "time_left",
    "kgs-time_settings", "kgs-rules", "cputime", "gomill-cpu_time",
    "kata-get-rules", "kata-set-rules", "kata-set-rule", "kata-get-param",
    "kata-set-param", "kata-get-params", "kata-set-params",
    "kata-list-params", "kata-get-models",
    "kata-raw-nn", "kata-raw-human-nn", "kata-analyze", "lz-analyze",
    "genmove_analyze", "lz-genmove_analyze", "kata-genmove_analyze",
    "genmove_debug",
    "kata-search", "kata-search_cancellable", "kata-search_debug",
    "kata-search_analyze", "kata-search_analyze_cancellable",
    "clear_cache", "loadsgf", "printsgf", "showboard", "kata-benchmark",
    "kata-time_settings", "kata-list-time-settings",
    "kata-list_time_settings", "kata-set-position",
    "set_position", "stop", "debug_moves",
]

def loc_to_gtp(loc: int, size: int, x_size: int | None = None,
               y_size: int | None = None) -> str:
    """Rect boards embed at rows 0..y_size-1 / cols 0..x_size-1 of the
    square grid; vertex row numbers count from the rect's bottom."""
    ys = y_size or size
    if loc >= size * size:
        return "pass"
    x, y = loc % size, loc // size
    return f"{GTP_COLS[x]}{ys - y}"


def gtp_to_loc(s: str, size: int, x_size: int | None = None,
               y_size: int | None = None) -> int:
    xs = x_size or size
    ys = y_size or size
    s = s.strip().upper()
    if s in ("PASS", "RESIGN"):
        return size * size
    col = GTP_COLS.index(s[0])
    row = int(s[1:])
    y = ys - row
    if not (0 <= col < xs and 0 <= y < ys):
        raise ValueError(f"vertex {s} off board")
    return y * size + col


def default_net(size: int, device) -> torch.nn.Module:
    """The engine's net when no -model is given: a seeded random-init
    b2c16 in float32 (the JAX engine's is random-init too, from a JAX
    key, so the weights differ)."""
    from katago_torch.models import config as MC
    from katago_torch.models import model as M
    from katago_torch.models import weights as W
    net = M.KataGoModel(MC.get_config("b2c16"), pos_len=size,
                        dtype=torch.float32)
    return W.init_weights(net, seed=0).to(device).eval()


class GTPEngine:
    def __init__(self, model_path: str | None = None, size: int = 19,
                 rules: R.Rules | None = None, visits: int = 100,
                 search_params: SearchParams | None = None,
                 allow_resignation: bool = False,
                 resign_threshold: float = -0.90,
                 resign_consec_turns: int = 3,
                 ponder: bool = False,
                 anti_mirror: bool = True,
                 human_sl_profile: str | None = None,
                 ladder_mode: str = "chase",
                 device=None, seed: int | None = None):
        self.device = resolve_device(device)
        self.size = size
        self.x_size = size
        self.y_size = size
        self.rules = rules or R.Rules.tromp_taylorish()
        self.visits = visits
        base = search_params or SearchParams(
            root_noise_enabled=False, cpuct_exploration=1.0,
            cpuct_exploration_log=0.45,
            static_score_utility_factor=0.1,
            dynamic_score_utility_factor=0.3,
            use_lcb_for_selection=True,
            # setup.cpp defaults for GTP/analysis (setup.cpp:589,641)
            root_symmetry_pruning=True,
            root_ending_bonus_points=0.5,
            root_prune_useless_moves=True)
        self.search_params = base
        # in-search leaf ladder featurization: "chase" (the default) or
        # "exact"; kata-raw-nn and the placement policy always featurize
        # with the exact solver
        self.ladder_mode = ladder_mode
        self._drivers: dict[tuple, SearchDriver] = {}
        if seed is None:
            seed = int(time.time() * 1000) % (2 ** 31)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        # per-player clocks (None = visit-limited); GTP lag buffer seconds
        self.time_controls: dict[int, TC.TimeControls | None] = {
            B.BLACK: None, B.WHITE: None}
        self.lag_buffer = 1.0
        # resignation (gtp.cpp:276-324: recent winloss below the threshold
        # for resignConsecTurns consecutive own turns, and not too early)
        self.allow_resignation = allow_resignation
        self.resign_threshold = resign_threshold
        self.resign_consec_turns = resign_consec_turns
        self.resign_min_moves_per_board_area = 0.4
        self._recent_winloss: list[tuple[int, float]] = []  # (player, wl)
        # pondering (asyncbot.h ponder after each genmove)
        self.ponder_enabled = ponder
        self._ponder: AsyncSearch | None = None
        # anti-mirror countering (searchParams.antiMirror, on by default
        # like gtp_example.cfg; detection reruns before every search)
        self.anti_mirror = anti_mirror
        # humanSL profile conditioning (humanSLProfile config): evals of
        # a metadata-encoder net are conditioned on a named rank/pro
        # profile's 192-float row (models/sgfmetadata.py)
        self.sgf_meta = None
        if human_sl_profile:
            from katago_torch.models.sgfmetadata import get_profile
            self.sgf_meta = get_profile(human_sl_profile)
        self._nets: dict[int, torch.nn.Module] = {}
        if model_path:
            from katago_torch.models import desc as D
            self.desc = D.load_model(model_path)
            if self.sgf_meta is not None and \
                    self.desc.trunk.get("meta_encoder") is None:
                raise ValueError(
                    "humanSLProfile requires a metadata-encoder net")
            self._desc_net = D.DescNet(self.desc).to(self.device).eval()
            self.model_name = self.desc.name
            # V3-V6 nets are fed their own input features
            self.feature_version = self.desc.input_version
        else:
            self.desc = None
            self._desc_net = None
            self.model_name = "random-init-b2c16"
            self.feature_version = 7
        self.clear_board()

    def net(self) -> torch.nn.Module:
        """The net for the current board size (a desc net fits any size;
        the default b2c16 is built per size)."""
        if self._desc_net is not None:
            return self._desc_net
        if self.size not in self._nets:
            self._nets[self.size] = default_net(self.size, self.device)
        return self._nets[self.size]

    # -- game state -------------------------------------------------------

    def _one(self, v, dtype=torch.int64) -> torch.Tensor:
        return torch.tensor([v], dtype=dtype, device=self.device)

    def clear_board(self):
        self.stop_ponder()
        max_hist = 2 * self.size * self.size + 64
        shape = None
        if self.x_size != self.size or self.y_size != self.size:
            m = np.zeros((self.size, self.size), bool)
            m[:self.y_size, :self.x_size] = True
            shape = torch.from_numpy(m.reshape(-1))
        self.gs = H.new_game(self.size, self.rules, max_hist,
                             device=self.device, shape_mask=shape)
        self.history: list = [self.gs]
        self.moves: list[tuple[int, int]] = []
        self._reuse_tree = None   # Search::makeMove-style tree carry-over
        self._recent_winloss = []

    def set_size(self, size: int, y_size: int | None = None):
        """Square or rectangular (board.h:14-16): a rect board plays on
        the max(x,y)-square engine grid with WALL-filled off-board rows."""
        self.x_size = size
        self.y_size = y_size or size
        self.size = max(self.x_size, self.y_size)
        self.clear_board()

    def set_rules(self, rules: R.Rules):
        """Change rules/komi mid-game, preserving the position (the
        reference allows komi and rule changes without clearing)."""
        self.rules = rules
        rarr = H.RulesArr.from_rules(rules, 1, self.device)
        self.gs = dataclasses.replace(self.gs, rules=rarr)
        self.history = [dataclasses.replace(g, rules=rarr)
                        for g in self.history]

    def to_move(self) -> int:
        return int(self.gs.pos.to_move[0])

    def stones_np(self, gs=None) -> np.ndarray:
        return (gs or self.gs).pos.board.stones[0].cpu().numpy()

    def play(self, player: int, loc: int):
        self.stop_ponder()
        gs = H.replace_pos(self.gs, to_move=self._one(player))
        legal = H.legal_moves(gs, self.size)[0].cpu().numpy()
        if not legal[min(loc, self.size * self.size)]:
            raise ValueError("illegal move")
        self.gs, _ = H.step(gs, self._one(loc), self.size)
        self.history.append(self.gs)
        self.moves.append((player, loc))
        # incrementally re-root the carried search tree at the played move
        if self._reuse_tree is not None:
            self._reuse_tree = mcts.extract_subtree(self._reuse_tree,
                                                    self._one(loc))

    def undo(self):
        self.stop_ponder()
        if len(self.history) <= 1:
            raise ValueError("cannot undo")
        self.history.pop()
        self.moves.pop()
        self.gs = self.history[-1]
        self._reuse_tree = None   # re-rooting cannot go backwards

    # -- search ------------------------------------------------------------

    def _get_driver(self) -> SearchDriver:
        max_nodes = 2 * self.visits + 8   # roomy pool so reuse retains value
        key = (self.size, max_nodes)
        if key not in self._drivers:
            self._drivers[key] = SearchDriver(
                self.net(), self.search_params.to_arr(self.device),
                size=self.size, max_nodes=max_nodes,
                chunk_size=max(4, min(32, self.visits // 4)),
                ladder_mode=self.ladder_mode,
                root_num_symmetries=self.search_params.root_num_symmetries,
                feature_version=self.feature_version,
                sgf_meta=self.sgf_meta, device=self.device)
        return self._drivers[key]

    def _mirror_arrs(self, root_pla: int):
        """Host-side anti-mirror detection over this game's move history
        (Search::updateMirroring); None when off or not mirroring, so the
        search runs without the anti-mirror code."""
        if not self.anti_mirror or len(self.moves) < 14:
            return None
        from katago_torch.search import mirror as MIR
        moves = [loc for _, loc in self.moves]
        plas = [p for p, _ in self.moves]
        mirroring, adv, err = MIR.detect_game(
            moves, plas, root_pla=root_pla, stones=self.stones_np(),
            komi=self.rules.komi,
            scoring_area=self.rules.scoring_rule == R.SCORING_AREA,
            size=self.size)
        if not mirroring:
            return None
        return MIR.MirrorArrs(
            mirroring=self._one(True, torch.bool),
            mirror_pla=self._one(3 - root_pla),
            advantage=self._one(adv, torch.float32),
            center_err=self._one(err, torch.float32))

    def _pattern_bonus_arrs(self, root_pla: int):
        """avoidRepeatedPatternUtility table from this game's own moves
        (search.cpp:715-727); None when off, so the search runs none of
        the pattern code."""
        u = self.search_params.avoid_repeated_pattern_utility
        if u == 0.0 or not self.moves:
            return None
        from katago_torch.search import patternbonus as PB
        boards_before = [self.stones_np(g) for g in self.history[:-1]]
        moves = [loc for _, loc in self.moves]
        plas = [p for p, _ in self.moves]
        return PB.build_avoid_repeat_table(boards_before, moves, plas,
                                           self.size, root_pla, u,
                                           self.device)

    def search_root(self, player: int, visits: int | None = None,
                    max_time: float | None = None,
                    time_rec: float | None = None,
                    time_max: float | None = None,
                    callback=None, callback_interval: float = 1.0,
                    should_stop=None, root_allowed_mask=None):
        self.stop_ponder()
        visits = visits or self.visits
        roots = H.replace_pos(self.gs, to_move=self._one(player))
        sub = split_generator(self.gen)
        driver = self._get_driver()
        prev = self._reuse_tree
        if prev is not None and not (prev.visits.shape[1] <=
                                     driver.max_nodes and
                                     int(prev.num_nodes[0]) > 0):
            prev = None
        if root_allowed_mask is not None:
            root_allowed_mask = torch.as_tensor(
                root_allowed_mask, device=self.device).unsqueeze(0)
        res = driver.search(roots, sub, max_visits=visits,
                            root_allowed_mask=root_allowed_mask,
                            max_time=max_time, prev_tree=prev,
                            time_rec=time_rec, time_max=time_max,
                            turn_number=len(self.moves),
                            host_params=self.search_params,
                            callback=callback,
                            callback_interval=callback_interval,
                            should_stop=should_stop,
                            mirror=self._mirror_arrs(player),
                            pattern_bonus=self._pattern_bonus_arrs(player))
        self._reuse_tree = res.ss.tree
        self.last_search_result = res
        self.last_search_player = player
        return res

    def genmove(self, player: int, callback=None,
                callback_interval: float = 1.0) -> int | None:
        """Search and play. Returns the move, or None for resign
        (gtp.cpp:276-324 resignation conditions)."""
        tc = self.time_controls[player]
        max_time = None
        time_rec = time_max = None
        if tc is not None and not tc.is_effectively_unlimited():
            st = self.stones_np()
            stones = int(((st == B.BLACK) | (st == B.WHITE)).sum())
            _, rec, max_t = tc.get_time(self.x_size * self.y_size, stones,
                                        lag_buffer=self.lag_buffer)
            # dynamic time management (recomputeSearchTimeLimit): the
            # driver refines the planned limit between chunks
            time_rec, time_max = rec, max_t
        t0 = time.time()
        res = self.search_root(player, visits=self.visits,
                               time_rec=time_rec, time_max=time_max,
                               max_time=max_time, callback=callback,
                               callback_interval=callback_interval)
        dt = max(time.time() - t0, 1e-3)
        cv = res.child_visits[0].cpu().numpy()
        loc = int(cv.argmax())

        # resignation: expected winloss (mover persp) below threshold for
        # the last resign_consec_turns of this player's turns, not too
        # early in the game
        wl_white = float(res.root_winloss[0])
        wl_mover = wl_white if player == B.WHITE else -wl_white
        self._recent_winloss.append((player, wl_mover))
        if self._should_resign(player):
            return None
        self.play(player, loc)
        if self.time_controls[player] is not None:
            tc = self.time_controls[player]
            if not tc.in_overtime:
                tc.main_time_left -= dt
                tc.main_time_left += tc.increment
        self.maybe_start_ponder()
        return loc

    def _should_resign(self, player: int) -> bool:
        if not self.allow_resignation:
            return False
        min_turns = self.resign_min_moves_per_board_area * \
            self.size * self.size
        if len(self.moves) < min_turns:
            return False
        own = [wl for p, wl in self._recent_winloss if p == player]
        if len(own) < self.resign_consec_turns:
            return False
        return all(wl < self.resign_threshold
                   for wl in own[-self.resign_consec_turns:])

    # -- pondering ---------------------------------------------------------

    def maybe_start_ponder(self):
        """Background search on the current position (opponent to move) —
        AsyncBot::ponder (asyncbot.h:84), in a thread with its own
        generator split from the engine's."""
        if not self.ponder_enabled or self._ponder is not None:
            return
        sub = split_generator(self.gen)
        driver = self._get_driver()
        prev = self._reuse_tree
        if prev is not None and int(prev.num_nodes[0]) == 0:
            prev = None
        self._ponder = AsyncSearch(driver, self.gs, sub,
                                   max_visits=4 * self.visits,
                                   prev_tree=prev)

    def stop_ponder(self):
        if self._ponder is not None:
            ponder, self._ponder = self._ponder, None
            res = ponder.stop()
            if res is not None:
                self._reuse_tree = res.ss.tree

    last_search_result = None
    last_search_player: int | None = None

    # -- reporting -----------------------------------------------------------

    def _raw(self, gs, sym: int | None = None, human: bool = False):
        """Exact-ladder features of gs (the net's input version) -> the
        net's raw outputs (one game), optionally under one dihedral
        symmetry; human: conditioned on the humanSL profile's row."""
        from katago_torch.models import features as F
        from katago_torch.ops import symmetry as SYM
        legal = H.legal_moves(gs, self.size)
        spf, glf = F.fill_features(
            gs, self.size, F.FeatureParams.default(self.device), legal,
            version=self.feature_version)
        if sym is not None:
            spf = SYM.transform_spatial(spf, self._one(sym), self.size)
        meta = None
        if human:
            from katago_torch.models.sgfmetadata import fill_metadata_row
            meta = torch.from_numpy(fill_metadata_row(
                self.sgf_meta,
                next_player_is_white=int(gs.pos.to_move[0]) == B.WHITE,
                board_area=self.size * self.size))[None].to(self.device)
        with torch.no_grad():
            raw = self.net()(spf.reshape(1, self.size, self.size, -1), glf,
                             metadata=meta)
        return raw, legal

    def debug_moves_str(self, branch: list[int],
                        raw_stats: bool = False) -> str:
        """debug_moves (gtp.cpp:3612-3658): the board after a branch of
        moves from the current position, plus the last search tree's
        one-level child statistics at that branch node (printTree with
        maxDepth 1); `rawstats` appends symmetry-averaged raw NN values
        of the branch position (rawNNBrief)."""
        gs = self.gs
        pla = self.to_move()
        for loc in branch:
            gs = H.replace_pos(gs, to_move=self._one(pla))
            gs, _ = H.step(gs, self._one(loc), self.size)
            pla = B.BLACK if pla == B.WHITE else B.WHITE
        lines = [B.board_to_string(self.stones_np(gs), self.size)]

        tree = self._reuse_tree
        node = 0
        in_tree = tree is not None and int(tree.num_nodes[0]) > 0
        if in_tree:
            children = tree.children[0].long().cpu().numpy()
            for loc in branch:
                nxt = int(children[node, loc])
                if nxt < 0:
                    in_tree = False
                    break
                node = nxt
        if not in_tree:
            lines.append("(branch not in last search tree)")
            if not raw_stats:
                return "\n".join(lines)
        else:
            st = tree.stats[0].cpu().numpy()
            visits = tree.visits[0].cpu().numpy()
            weight = st[:, mcts.C_WEIGHT_SUM]
            wl = st[:, mcts.C_WINLOSS_SUM]
            sc = st[:, mcts.C_SCORE_MEAN_SUM]
            prior = tree.policy[0, node].float().cpu().numpy()
            w0 = max(float(weight[node]), 1e-9)
            lines.append(
                f"root visits {int(visits[node])} "
                f"winrate {0.5 * (1 + float(wl[node]) / w0):.4f} "
                f"scoreMean {float(sc[node]) / w0:.2f}")
            ch = children[node]
            cv = np.where(ch >= 0, visits[np.maximum(ch, 0)], 0)
            for a in np.argsort(cv)[::-1]:
                if cv[a] <= 0:
                    break
                c = int(ch[a])
                w = max(float(weight[c]), 1e-9)
                lines.append(
                    f"{loc_to_gtp(int(a), self.size, self.x_size, self.y_size)}"
                    f" : visits {int(cv[a])}"
                    f" winrate {0.5 * (1 + float(wl[c]) / w):.4f}"
                    f" scoreMean {float(sc[c]) / w:.2f}"
                    f" prior {max(float(prior[a]), 0.0):.4f}")
        if raw_stats:
            # symmetry-averaged raw values (rawNNBrief, SYMMETRY_ALL)
            wins, scores = [], []
            for sym in range(8):
                raw, _ = self._raw(gs, sym)
                v = torch.softmax(raw["value_logits"][0].float(), -1)
                wins.append(float(v[0] - v[1]))
                scores.append(float(raw["miscvalue"][0][0]) * 20.0)
            lines.append(f"raw winloss {np.mean(wins):+.4f} "
                         f"+/- {np.std(wins):.4f} "
                         f"raw score {np.mean(scores):+.2f} "
                         f"+/- {np.std(scores):.2f} (8 symmetries)")
        return "\n".join(lines)

    def analyze_info(self, res, top_k: int = 10, pv_len: int = 12,
                     include_ownership: bool = False,
                     player: int | None = None,
                     min_moves: int = 1,
                     include_pv_visits: bool = False,
                     include_root_info: bool = False,
                     include_ownership_stdev: bool = False) -> str:
        """kata-analyze info lines from a SearchResult (game 0), with
        greedy-descent PVs per candidate (searchresults.cpp appendPV) and
        optional tree-averaged ownership. The tree is read to the host
        once per call."""
        cv = res.child_visits[0].cpu().numpy()
        prior = res.root_policy_prior[0].cpu().numpy()
        tree = res.ss.tree
        children = tree.children[0].long().cpu().numpy()      # [N, A]
        visits = tree.visits[0].cpu().numpy()                 # [N]
        st = tree.stats[0].cpu().numpy()
        weight = st[:, mcts.C_WEIGHT_SUM]
        util_sum = st[:, mcts.C_UTILITY_SUM]
        wl_sum = st[:, mcts.C_WINLOSS_SUM]
        sc_sum = st[:, mcts.C_SCORE_MEAN_SUM]
        # rank by visits, prior-tiebroken (minmoves padding then walks
        # legal unvisited moves in prior order; illegal sink to the end)
        order = np.lexsort((prior, cv))[::-1]
        if player is None:
            player = self.to_move()
        infos = []

        def pv_from(node: int, first_move: int):
            moves = [first_move]
            vis = [int(visits[node])]
            for _ in range(pv_len - 1):
                ch = children[node]
                valid = ch >= 0
                w = np.where(valid, visits[np.maximum(ch, 0)], -1)
                a = int(w.argmax())
                if w[a] <= 0:
                    break
                moves.append(a)
                node = int(ch[a])
                vis.append(int(visits[node]))
            return moves, vis

        # minmoves: pad the report with 0-visit prior-ranked moves
        # (GTP_Extensions.md kata-analyze minmoves)
        top_k = max(top_k, min_moves)
        for rank, a in enumerate(order[:top_k]):
            if cv[a] <= 0 and rank >= min_moves:
                break
            if cv[a] <= 0 and prior[a] < 0:
                break
            child = int(children[0, a])
            if cv[a] > 0 and child >= 0:
                w = max(float(weight[child]), 1e-9)
                util = float(util_sum[child]) / w
                winloss = float(wl_sum[child]) / w
                score = float(sc_sum[child]) / w
                pv_moves, pv_vis = pv_from(child, int(a))
            else:
                # minmoves-padded unvisited move: root values + prior only
                w0 = max(float(weight[0]), 1e-9)
                util = float(util_sum[0]) / w0
                winloss = float(wl_sum[0]) / w0
                score = float(sc_sum[0]) / w0
                pv_moves, pv_vis = [int(a)], [0]
            if player == B.BLACK:
                util, winloss, score = -util, -winloss, -score
            winrate = 0.5 * (1.0 + winloss)
            pv = " ".join(loc_to_gtp(m, self.size, self.x_size, self.y_size)
                          for m in pv_moves)
            info = (
                f"info move {loc_to_gtp(int(a), self.size, self.x_size, self.y_size)} visits {int(cv[a])} "
                f"utility {util:.6f} winrate {winrate:.6f} "
                f"scoreMean {score:.2f} scoreLead {score:.2f} "
                f"prior {max(prior[a], 0):.6f} order {rank} "
                f"pv {pv}")
            if include_pv_visits:
                info += " pvVisits " + " ".join(str(v) for v in pv_vis)
            infos.append(info)
        out = " ".join(infos)
        if include_root_info:
            # root properties line (GTP_Extensions.md rootInfo)
            rw = max(float(weight[0]), 1e-9)
            rwl = float(res.root_winloss[0])
            rsc = float(res.root_score_mean[0])
            rut = float(res.root_utility[0])
            if player == B.BLACK:
                rwl, rsc, rut = -rwl, -rsc, -rut
            out += (f" rootInfo visits {int(visits[0])} "
                    f"winrate {0.5 * (1.0 + rwl):.6f} "
                    f"scoreMean {rsc:.2f} scoreLead {rsc:.2f} "
                    f"utility {rut:.6f} weight {rw:.2f}")
        if include_ownership:
            own = res.root_ownership[0].cpu().numpy()      # white persp
            if player == B.BLACK:
                own = -own
            out += " ownership " + " ".join(f"{v:.4f}" for v in own)
        if include_ownership_stdev:
            ostd = res.root_ownership_stdev[0].cpu().numpy()
            out += " ownershipStdev " + " ".join(f"{v:.4f}" for v in ostd)
        return out

    def param_table(self):
        """kata-get/set-param surface: name -> (getter, setter). A small
        live-tunable subset of the reference's kata-set-param params
        (gtp.cpp kata-set-param; full config keys load at startup via
        utils/setup.py)."""
        def fset(name, conv):
            def set_(v):
                setattr(self, name, conv(v))
            return set_

        def as_bool(v):
            return v if isinstance(v, bool) else str(v).lower() == "true"

        def spget(field):
            return lambda: getattr(self.search_params, field)

        def spset(field, conv):
            # the live drivers take the new params in place; a change of
            # root_num_symmetries rebuilds them
            def set_(v):
                self.search_params = dataclasses.replace(
                    self.search_params, **{field: conv(v)})
                if field == "root_num_symmetries":
                    self._drivers.clear()
                else:
                    arr = self.search_params.to_arr(self.device)
                    for d in self._drivers.values():
                        d.sp = arr
            return set_

        return {
            "maxVisits": (lambda: self.visits, fset("visits", int)),
            "ponderingEnabled": (lambda: self.ponder_enabled,
                                 fset("ponder_enabled", as_bool)),
            "allowResignation": (lambda: self.allow_resignation,
                                 fset("allow_resignation", as_bool)),
            "resignThreshold": (lambda: self.resign_threshold,
                                fset("resign_threshold", float)),
            "resignConsecTurns": (lambda: self.resign_consec_turns,
                                  fset("resign_consec_turns", int)),
            "lagBuffer": (lambda: self.lag_buffer,
                          fset("lag_buffer", float)),
            "antiMirror": (lambda: self.anti_mirror,
                           fset("anti_mirror", as_bool)),
            "playoutDoublingAdvantage":
                (spget("playout_doubling_advantage"),
                 spset("playout_doubling_advantage", float)),
            "analysisWideRootNoise": (spget("wide_root_noise"),
                                      spset("wide_root_noise", float)),
            "wideRootNoise": (spget("wide_root_noise"),
                              spset("wide_root_noise", float)),
            "rootNoiseEnabled": (spget("root_noise_enabled"),
                                 spset("root_noise_enabled", as_bool)),
            "policyOptimism": (spget("policy_optimism"),
                               spset("policy_optimism", float)),
            "rootPolicyOptimism": (spget("root_policy_optimism"),
                                   spset("root_policy_optimism", float)),
            "chosenMoveTemperature":
                (spget("chosen_move_temperature"),
                 spset("chosen_move_temperature", float)),
            "staticScoreUtilityFactor":
                (spget("static_score_utility_factor"),
                 spset("static_score_utility_factor", float)),
            "dynamicScoreUtilityFactor":
                (spget("dynamic_score_utility_factor"),
                 spset("dynamic_score_utility_factor", float)),
            "cpuctExploration": (spget("cpuct_exploration"),
                                 spset("cpuct_exploration", float)),
            "cpuctExplorationLog": (spget("cpuct_exploration_log"),
                                    spset("cpuct_exploration_log", float)),
            "rootSymmetryPruning": (spget("root_symmetry_pruning"),
                                    spset("root_symmetry_pruning",
                                          as_bool)),
            "rootEndingBonusPoints":
                (spget("root_ending_bonus_points"),
                 spset("root_ending_bonus_points", float)),
            "useLcbForSelection": (spget("use_lcb_for_selection"),
                                   spset("use_lcb_for_selection",
                                         as_bool)),
            "fpuReductionMax": (spget("fpu_reduction_max"),
                                spset("fpu_reduction_max", float)),
            "conservativePass": (spget("conservative_pass"),
                                 spset("conservative_pass", as_bool)),
        }

    def policy_top_move(self, player: int) -> int | None:
        """Raw-policy argmax over legal moves for `player` (the
        placeFreeHandicap placement policy, playutils.cpp)."""
        gs = H.replace_pos(self.gs, to_move=self._one(player))
        raw, legal = self._raw(gs)
        pol = torch.softmax(raw["policy_logits"][0, 0].float(), -1)
        pol = torch.where(legal[0], pol, -1.0).cpu().numpy()
        loc = int(pol[:self.size * self.size].argmax())
        if pol[loc] <= 0:
            return None
        return loc

    def raw_nn(self, use_human_profile: bool = False) -> str:
        if use_human_profile:
            # kata-raw-human-nn conditions on the configured humanSL
            # profile (gtp.cpp kata-raw-human-nn)
            if self.sgf_meta is None:
                raise ValueError("kata-raw-human-nn requires humanSLProfile")
        raw, _ = self._raw(self.gs, human=use_human_profile)
        pol = torch.softmax(raw["policy_logits"][0, 0].float(),
                            -1).cpu().numpy()
        val = torch.softmax(raw["value_logits"][0].float(), -1).cpu().numpy()
        black = self.to_move() == B.BLACK
        lines = [f"whiteWin {val[1] if black else val[0]:.6f}",
                 f"whiteLoss {val[0] if black else val[1]:.6f}",
                 f"noResult {val[2]:.6f}",
                 "policy"]
        for y in range(self.size):
            lines.append(" ".join(f"{pol[y*self.size+x]:.6f}"
                                  for x in range(self.size)))
        lines.append(f"policyPass {pol[self.size*self.size]:.6f}")
        return "\n".join(lines)


def _make_time_controls(kind: str, args: list[str]):
    """kata-time_settings / kgs-time_settings clocks: none | absolute MT |
    byoyomi MT PT NP | canadian MT PT NS | fischer MT INC |
    fischer-capped MT INC LIMIT MAXPERMOVE (negative = unlimited)."""
    if kind == "none":
        return None
    if kind == "absolute":
        return TC.TimeControls.absolute_time(float(args[1]))
    if kind == "fischer":
        return TC.TimeControls.fischer_time(float(args[1]), float(args[2]))
    if kind == "fischer-capped":
        return TC.TimeControls.fischer_capped_time(
            float(args[1]), float(args[2]), float(args[3]), float(args[4]))
    if kind == "byoyomi":
        return TC.TimeControls.canadian_or_byo_yomi_time(
            float(args[1]), float(args[2]), int(args[3]), 1)
    if kind == "canadian":
        return TC.TimeControls.canadian_or_byo_yomi_time(
            float(args[1]), float(args[2]), 1, int(args[3]))
    return None


def _placements_error(engine, args, player_of):
    """kata-set-position arguments -> (placements, error message)."""
    if len(args) % 2 != 0:
        return [], ("Expected a space-separated sequence of <COLOR> "
                    "<VERTEX> pairs")
    nn_b = engine.size * engine.size
    placements = []
    seen: set[int] = set()
    for i in range(0, len(args), 2):
        color = player_of.get(args[i].lower())
        if color is None:
            return [], ("Expected a space-separated sequence of <COLOR> "
                        "<VERTEX> pairs")
        try:
            loc = gtp_to_loc(args[i + 1], engine.size, engine.x_size,
                             engine.y_size)
        except ValueError as e:
            return [], str(e)
        if loc >= nn_b or loc in seen:
            return [], ("Illegal stone placements - overlapping stones or "
                        "stones with no liberties?")
        seen.add(loc)
        placements.append((color, loc))
    # zero-liberty groups are illegal setups
    grid = dict((loc, color) for color, loc in placements)
    size_ = engine.size

    def group_has_lib(start):
        color = grid[start]
        stack, visited = [start], {start}
        while stack:
            p = stack.pop()
            x, y = p % size_, p // size_
            for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                q, qx, qy = (y + dy) * size_ + x + dx, x + dx, y + dy
                if not (0 <= qx < engine.x_size and 0 <= qy < engine.y_size):
                    continue
                if q not in grid:
                    return True
                if grid[q] == color and q not in visited:
                    visited.add(q)
                    stack.append(q)
        return False

    if any(not group_has_lib(loc) for loc in grid):
        return [], ("Illegal stone placements - overlapping stones or "
                    "stones with no liberties?")
    return placements, None


def run_gtp(engine: GTPEngine, infile=sys.stdin, outfile=sys.stdout,
            logfile=None):
    def respond(msg: str, cmd_id: str, ok: bool = True):
        prefix = "=" if ok else "?"
        head = f"{prefix}{cmd_id}" if cmd_id else prefix
        outfile.write(f"{head} {msg}\n\n")
        outfile.flush()

    def log(s):
        if logfile:
            logfile.write(s + "\n")
            logfile.flush()

    player_of = {"b": B.BLACK, "black": B.BLACK, "w": B.WHITE,
                 "white": B.WHITE}

    def vertex(loc):
        return loc_to_gtp(loc, engine.size, engine.x_size, engine.y_size)

    def to_black_after_handicap():
        engine.gs = H.replace_pos(engine.gs, to_move=engine._one(B.WHITE))

    for line in infile:
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        log(f"<< {line}")
        parts = line.split()
        cmd_id = ""
        if parts[0].isdigit():
            cmd_id = parts[0]
            parts = parts[1:]
        if not parts:
            continue
        cmd, args = parts[0].lower(), parts[1:]
        try:
            if cmd == "protocol_version":
                respond("2", cmd_id)
            elif cmd == "name":
                respond("katago_tpu", cmd_id)
            elif cmd == "version":
                respond(f"0.1.0 ({engine.model_name})", cmd_id)
            elif cmd == "known_command":
                respond("true" if args and args[0] in KNOWN_COMMANDS
                        else "false", cmd_id)
            elif cmd == "list_commands":
                respond("\n".join(sorted(set(KNOWN_COMMANDS))), cmd_id)
            elif cmd == "quit":
                engine.stop_ponder()
                respond("", cmd_id)
                return
            elif cmd in ("boardsize", "rectangular_boardsize"):
                xs = int(args[0])
                ys = int(args[1]) if len(args) > 1 else xs
                if not (2 <= xs <= 19 and 2 <= ys <= 19):
                    respond(f"unacceptable size {xs} {ys}", cmd_id,
                            ok=False)
                    continue
                # re-setting the current size preserves the position
                if (xs, ys) != (engine.x_size, engine.y_size):
                    engine.set_size(xs, ys)
                respond("", cmd_id)
            elif cmd == "clear_board":
                engine.clear_board()
                respond("", cmd_id)
            elif cmd == "komi":
                engine.set_rules(R.Rules(**{**engine.rules.__dict__,
                                            "komi": float(args[0])}))
                respond("", cmd_id)
            elif cmd in ("kata-get-komi", "get_komi"):
                respond(str(engine.rules.komi), cmd_id)
            elif cmd in ("cputime", "gomill-cpu_time"):
                respond(f"{time.process_time():.3f}", cmd_id)
            elif cmd == "kgs-rules":
                # chinese | japanese | aga | new_zealand (gtp.cpp:2540);
                # KGS chinese uses positional superko ("chinese-kgs"), and
                # the current komi is preserved (parseRulesWithoutKomi)
                name = args[0].lower().replace("_", "-")
                if name == "chinese":
                    name = "chinese-kgs"
                parsed = R.Rules.parse(name)
                engine.set_rules(dataclasses.replace(
                    parsed, komi=engine.rules.komi))
                respond("", cmd_id)
            elif cmd == "kgs-time_settings":
                kind = args[0].lower()
                if kind not in ("none", "absolute", "byoyomi", "canadian"):
                    raise ValueError(f"unknown kgs time kind {kind}")
                # kgs byoyomi: main_time byo_yomi_time byo_yomi_periods
                engine.time_controls[B.BLACK] = _make_time_controls(kind,
                                                                    args)
                engine.time_controls[B.WHITE] = _make_time_controls(kind,
                                                                    args)
                respond("", cmd_id)
            elif cmd == "play":
                player = player_of[args[0].lower()]
                loc = gtp_to_loc(args[1], engine.size, engine.x_size,
                                 engine.y_size)
                engine.play(player, loc)
                respond("", cmd_id)
            elif cmd == "undo":
                engine.undo()
                respond("", cmd_id)
            elif cmd == "genmove":
                player = player_of[args[0].lower()]
                loc = engine.genmove(player)
                respond("resign" if loc is None else vertex(loc), cmd_id)
            elif cmd in ("genmove_analyze", "lz-genmove_analyze",
                         "kata-genmove_analyze", "kata-search_analyze",
                         "kata-search_analyze_cancellable"):
                # stream info lines during the search, then the move
                # (gtp.cpp:1748 genmove_analyze family)
                player = engine.to_move()
                interval = 1.0
                for a in args:
                    al = a.lower()
                    if al in player_of:
                        player = player_of[al]
                    elif al.replace(".", "").isdigit():
                        interval = float(al) / 100.0  # centiseconds
                outfile.write(f"={cmd_id}\n" if cmd_id else "=\n")
                outfile.flush()

                def emit(res, elapsed):
                    outfile.write(engine.analyze_info(res) + "\n")
                    outfile.flush()

                if cmd.startswith("kata-search"):
                    # search_analyze variants report without playing
                    res = engine.search_root(player, callback=emit,
                                             callback_interval=interval)
                    loc = int(res.child_visits[0].cpu().numpy().argmax())
                else:
                    loc = engine.genmove(player, callback=emit,
                                         callback_interval=interval)
                # final summary info line from the completed search's tree
                final_res = engine.last_search_result
                if final_res is not None:
                    outfile.write(engine.analyze_info(
                        final_res, player=engine.last_search_player) + "\n")
                move_s = "resign" if loc is None else vertex(loc)
                outfile.write(f"play {move_s}\n\n")
                outfile.flush()
            elif cmd == "showboard":
                respond("\n" + B.board_to_string(engine.stones_np(),
                                                 engine.size), cmd_id)
            elif cmd == "debug_moves":
                raw = "rawstats" in args
                verts = [a for a in args if a.lower() != "rawstats"]
                try:
                    branch = [gtp_to_loc(v, engine.size, engine.x_size,
                                         engine.y_size) for v in verts]
                except Exception:  # noqa: BLE001
                    respond("Invalid move sequence", cmd_id, ok=False)
                else:
                    respond("\n" + engine.debug_moves_str(branch, raw),
                            cmd_id)
            elif cmd == "final_score":
                _, score = H.final_score_area(engine.gs, engine.size)
                s = float(score[0])
                if s > 0:
                    respond(f"W+{s:g}", cmd_id)
                elif s < 0:
                    respond(f"B+{-s:g}", cmd_id)
                else:
                    respond("0", cmd_id)
            elif cmd == "final_status_list":
                # alive/dead/seki from final area ownership
                # (PlayUtils::computeAnticipatedStatuses): a stone is dead
                # iff the final area gives its point to the opponent; seki
                # iff its point ends up unowned
                kind = args[0].lower() if args else "alive"
                own, _ = H.final_score_area(engine.gs, engine.size)
                own = own[0].cpu().numpy()             # +1 black / -1 white
                stones = engine.stones_np()
                out_locs = []
                for loc in range(engine.size * engine.size):
                    s = stones[loc]
                    if s != B.BLACK and s != B.WHITE:
                        continue   # empty or off-board WALL
                    mine = 1 if s == B.BLACK else -1
                    status = ("alive" if own[loc] == mine else
                              "dead" if own[loc] == -mine else "seki")
                    if status == kind:
                        out_locs.append(vertex(loc))
                respond(" ".join(out_locs), cmd_id)
            elif cmd in ("kata-set-position", "set_position"):
                # alternating color/vertex pairs on an empty board
                # (gtp.cpp kata-set-position)
                placements, err = _placements_error(engine, args, player_of)
                if err is not None:
                    respond(err, cmd_id, ok=False)
                    continue
                engine.clear_board()
                for color, loc in placements:
                    engine.gs = H.setup_stone(engine.gs, loc, color,
                                              engine.size)
                engine.history = [engine.gs]
                respond("", cmd_id)
            elif cmd == "kata-benchmark":
                n_visits = int(args[0]) if args else engine.visits
                t0 = time.time()
                res = engine.search_root(engine.to_move(), visits=n_visits)
                v = int(res.root_visits[0])
                dt = max(time.time() - t0, 1e-6)
                respond(f"visits {v} time {dt:.3f}s visits/s {v/dt:.1f}",
                        cmd_id)
            elif cmd == "stop":
                engine.stop_ponder()
                respond("", cmd_id)
            elif cmd == "fixed_handicap":
                locs = fixed_handicap_locs(engine.size, int(args[0]))
                for loc in locs:
                    engine.play(B.BLACK, loc)
                to_black_after_handicap()
                respond(" ".join(vertex(loc) for loc in locs), cmd_id)
            elif cmd == "place_free_handicap":
                # policy-greedy placement (PlayUtils::placeFreeHandicap
                # plays the net's top move repeatedly with black to move)
                locs = []
                for _ in range(int(args[0])):
                    loc = engine.policy_top_move(B.BLACK)
                    if loc is None or loc >= engine.size * engine.size:
                        break
                    engine.play(B.BLACK, loc)
                    locs.append(loc)
                to_black_after_handicap()
                respond(" ".join(vertex(loc) for loc in locs), cmd_id)
            elif cmd == "set_free_handicap":
                for v in args:
                    engine.play(B.BLACK, gtp_to_loc(v, engine.size,
                                                    engine.x_size,
                                                    engine.y_size))
                to_black_after_handicap()
                respond("", cmd_id)
            elif cmd in ("kata-search", "kata-search_cancellable",
                         "kata-search_debug", "genmove_debug"):
                # kata-search reports the move without playing it;
                # genmove_debug plays through genmove; the _debug variants
                # write the analysis to stderr and answer the vertex
                player = player_of[args[0].lower()] if args \
                    else engine.to_move()
                if cmd == "genmove_debug":
                    loc = engine.genmove(player)
                    res = engine.last_search_result
                    if res is not None:
                        sys.stderr.write(
                            engine.analyze_info(res, player=player) + "\n")
                        sys.stderr.flush()
                    respond("resign" if loc is None else vertex(loc),
                            cmd_id)
                else:
                    res = engine.search_root(player)
                    loc = int(res.child_visits[0].cpu().numpy().argmax())
                    if cmd.endswith("_debug"):
                        sys.stderr.write(
                            engine.analyze_info(res, player=player) + "\n")
                        sys.stderr.flush()
                    respond(vertex(loc), cmd_id)
            elif cmd == "time_settings":
                # GTP: main_time byo_yomi_time byo_yomi_stones
                mt, byo_t, byo_s = float(args[0]), float(args[1]), \
                    int(args[2])
                if byo_s == 0 or byo_t <= 0:
                    def tc_new():
                        return TC.TimeControls.absolute_time(mt)
                else:
                    def tc_new():
                        return TC.TimeControls.canadian_or_byo_yomi_time(
                            mt, byo_t, 1, byo_s)
                engine.time_controls[B.BLACK] = tc_new()
                engine.time_controls[B.WHITE] = tc_new()
                respond("", cmd_id)
            elif cmd == "kata-time_settings":
                kind = args[0].lower()
                if kind not in ("none", "absolute", "fischer",
                                "fischer-capped", "byoyomi", "canadian"):
                    raise ValueError(f"unknown time settings kind {kind}")
                engine.time_controls[B.BLACK] = _make_time_controls(kind,
                                                                    args)
                engine.time_controls[B.WHITE] = _make_time_controls(kind,
                                                                    args)
                respond("", cmd_id)
            elif cmd == "time_left":
                player = player_of[args[0].lower()]
                tc = engine.time_controls[player]
                if tc is None:
                    tc = TC.TimeControls.absolute_time(float(args[1]))
                    engine.time_controls[player] = tc
                tc.update_from_gtp_time_left(float(args[1]), int(args[2]))
                respond("", cmd_id)
            elif cmd in ("kata-list-time-settings",
                         "kata-list_time_settings"):
                respond("none absolute byoyomi canadian fischer "
                        "fischer-capped", cmd_id)
            elif cmd == "kata-debug-print-tc":
                respond(str(engine.time_controls[engine.to_move()]), cmd_id)
            elif cmd == "kata-get-rules":
                respond(engine.rules.to_json_string(), cmd_id)
            elif cmd == "kata-set-rules":
                engine.set_rules(R.Rules.parse(" ".join(args)))
                respond("", cmd_id)
            elif cmd == "kata-set-rule":
                engine.set_rules(R.Rules.from_json({args[0]: args[1]},
                                                   default=engine.rules))
                respond("", cmd_id)
            elif cmd == "kata-get-param":
                getter = engine.param_table().get(args[0])
                if getter:
                    v = getter[0]()
                    # booleans print lowercase (Global::boolToString)
                    respond(str(v).lower() if isinstance(v, (bool, np.bool_))
                            else str(v), cmd_id)
                else:
                    respond(f"unknown param {args[0]}", cmd_id, ok=False)
            elif cmd == "kata-set-param":
                setter = engine.param_table().get(args[0])
                if setter:
                    setter[1](args[1])
                    respond("", cmd_id)
                else:
                    respond(f"unknown param {args[0]}", cmd_id, ok=False)
            elif cmd == "kata-list-params":
                respond(" ".join(sorted(engine.param_table())), cmd_id)
            elif cmd == "kata-get-params":
                respond(json.dumps({k: g() for k, (g, _)
                                    in engine.param_table().items()}),
                        cmd_id)
            elif cmd == "kata-set-params":
                d = json.loads(" ".join(args))
                table = engine.param_table()
                for k, v in d.items():
                    if k not in table:
                        raise ValueError(f"unknown param {k}")
                    table[k][1](v)
                respond("", cmd_id)
            elif cmd == "kata-get-models":
                respond(json.dumps([{"name": engine.model_name,
                                     "internalName": engine.model_name,
                                     "maxBatchSize": 1,
                                     "usesHumanSLProfile":
                                         engine.sgf_meta is not None}]),
                        cmd_id)
            elif cmd == "kata-raw-nn":
                respond(engine.raw_nn(), cmd_id)
            elif cmd == "kata-raw-human-nn":
                respond(engine.raw_nn(use_human_profile=True), cmd_id)
            elif cmd in ("kata-analyze", "lz-analyze"):
                _analyze(engine, args, infile, outfile, respond, cmd_id,
                         player_of)
            elif cmd == "clear_cache":
                respond("", cmd_id)
            elif cmd == "loadsgf":
                from katago_torch.dataio import sgf as S
                with open(args[0]) as f:
                    game = S.parse_sgf(f.read())[0]
                xs, ys = game.size
                engine.rules = R.Rules(**{**engine.rules.__dict__,
                                          "komi": game.komi})
                engine.set_size(xs, ys)
                for color, loc in game.setup_stones():
                    engine.gs = H.setup_stone(
                        engine.gs, S.remap_to_grid(loc, xs, ys, engine.size),
                        color, engine.size)
                upto = int(args[1]) if len(args) > 1 else None
                for i, (player, loc) in enumerate(game.moves()):
                    if upto is not None and i + 1 >= upto:
                        break
                    engine.play(player,
                                S.remap_to_grid(loc, xs, ys, engine.size))
                respond("", cmd_id)
            elif cmd == "printsgf":
                from katago_torch.dataio import sgf as S
                grid = engine.size
                xs, ys = engine.x_size, engine.y_size
                sgf_moves = [
                    (p, xs * ys if loc >= grid * grid
                     else (loc // grid) * xs + (loc % grid))
                    for p, loc in engine.moves]
                text = S.write_sgf(sgf_moves, xs, ys,
                                   komi=engine.rules.komi)
                if args:
                    with open(args[0], "w") as f:
                        f.write(text)
                    respond("", cmd_id)
                else:
                    respond(text, cmd_id)
            else:
                respond("unknown command", cmd_id, ok=False)
        except Exception as e:  # noqa: BLE001 — GTP must answer, not die
            respond(f"{type(e).__name__}: {e}", cmd_id, ok=False)


def _analyze(engine, args, infile, outfile, respond, cmd_id, player_of):
    """kata-analyze / lz-analyze: info lines every `interval` centiseconds
    until the next GTP command arrives (GTP_Extensions.md kata-analyze)."""
    player = engine.to_move()
    interval = 1.0
    include_own = False
    min_moves, max_moves = 1, 10
    include_pvv = include_root = include_ostd = False
    # per-player root restriction masks (bool[A], True = allowed);
    # directives for the same player AND together, directives for the
    # other player don't touch the mover's
    avoid_masks = {B.BLACK: None, B.WHITE: None}
    i = 0
    while i < len(args):
        al = args[i].lower()
        if al in player_of:
            player = player_of[al]
        elif al == "interval" and i + 1 < len(args):
            i += 1
            interval = float(args[i]) / 100.0
        elif al == "ownership" and i + 1 < len(args):
            i += 1
            include_own = args[i].lower() == "true"
        elif al == "pvvisits" and i + 1 < len(args):
            i += 1
            include_pvv = args[i].lower() == "true"
        elif al == "rootinfo" and i + 1 < len(args):
            i += 1
            include_root = args[i].lower() == "true"
        elif al == "ownershipstdev" and i + 1 < len(args):
            i += 1
            include_ostd = args[i].lower() == "true"
        elif al == "minmoves" and i + 1 < len(args):
            i += 1
            min_moves = int(args[i])
        elif al == "maxmoves" and i + 1 < len(args):
            i += 1
            max_moves = int(args[i])
        elif al in ("avoid", "allow") and i + 3 < len(args):
            # avoid|allow PLAYER VERTEX,... UNTILDEPTH; applied at the
            # root when PLAYER is the mover and UNTILDEPTH >= 1
            apl = player_of.get(args[i + 1].lower())
            if apl is None:
                respond("invalid avoid/allow player", cmd_id, ok=False)
                return
            locs = [gtp_to_loc(v, engine.size, engine.x_size, engine.y_size)
                    for v in args[i + 2].split(",")]
            nn_a = engine.size * engine.size + 1
            if int(args[i + 3]) >= 1:
                m = np.full((nn_a,), al == "avoid")
                for lc in locs:
                    m[lc] = al == "allow"
                if avoid_masks[apl] is None:
                    avoid_masks[apl] = m
                else:
                    avoid_masks[apl] &= m
            i += 3
        elif al.replace(".", "").isdigit():
            interval = float(al) / 100.0
        i += 1

    def stdin_ready():
        try:
            r, _, _ = select.select([infile], [], [], 0)
            return bool(r)
        except (ValueError, OSError, TypeError):
            return True   # non-selectable input: one chunk only

    outfile.write(f"={cmd_id}\n" if cmd_id else "=\n")
    outfile.flush()
    fmt = dict(top_k=max_moves, min_moves=min_moves,
               include_ownership=include_own, include_pv_visits=include_pvv,
               include_root_info=include_root,
               include_ownership_stdev=include_ostd)

    def emit(res, elapsed):
        outfile.write(engine.analyze_info(res, **fmt) + "\n")
        outfile.flush()

    res = engine.search_root(
        player, visits=1 << 24, callback=emit, callback_interval=interval,
        should_stop=stdin_ready, root_allowed_mask=avoid_masks[player])
    outfile.write(engine.analyze_info(res, **fmt) + "\n\n")
    outfile.flush()


def main(argv=None, infile=None, outfile=None):
    ap = argparse.ArgumentParser(description="katago_torch GTP engine")
    ap.add_argument("-model", default=None, help=".bin.gz model file")
    ap.add_argument("-config", default=None, help="gtp config file")
    ap.add_argument("-override-config", default=None, dest="override")
    ap.add_argument("-visits", type=int, default=None)
    ap.add_argument("-boardsize", type=int, default=19)
    ap.add_argument("-device", default=None,
                    help="cpu or cuda (default: cuda; raises without it)")
    ap.add_argument("-seed", type=int, default=None,
                    help="search generator seed (default: from the clock)")
    args = ap.parse_args(argv)

    visits = 100
    rules = R.Rules.tromp_taylorish()
    search_params = None
    lag_buffer = None
    allow_resignation = False
    resign_threshold = -0.90
    resign_consec_turns = 3
    ponder = False
    anti_mirror = True
    human_sl_profile = None
    ladder_mode = "chase"
    if args.config:
        from katago_torch.utils.setup import (load_search_params,
                                              search_limits, warn_unused)
        cfg = ConfigParser(args.config)
        if args.override:
            cfg.apply_overrides(args.override)
        visits = cfg.get_int("maxVisits", default=visits)
        if cfg.contains("rules"):
            rules = R.Rules.parse(cfg.get_string("rules"))
        if cfg.contains("komi"):
            rules = R.Rules(**{**rules.__dict__,
                               "komi": cfg.get_float("komi")})
        # Setup::loadSingleParams: the full reference search-knob surface
        search_params = load_search_params(cfg)
        lag_buffer = search_limits(cfg).get("lag_buffer")
        # resignation + pondering (gtp.cpp:276-324, gtp_example.cfg keys)
        if cfg.contains("allowResignation"):
            allow_resignation = cfg.get_bool("allowResignation")
        if cfg.contains("resignThreshold"):
            resign_threshold = cfg.get_float("resignThreshold")
        if cfg.contains("resignConsecTurns"):
            resign_consec_turns = cfg.get_int("resignConsecTurns")
        if cfg.contains("ponderingEnabled"):
            ponder = cfg.get_bool("ponderingEnabled")
        if cfg.contains("antiMirror"):
            anti_mirror = cfg.get_bool("antiMirror")
        if cfg.contains("humanSLProfile"):
            human_sl_profile = cfg.get_string("humanSLProfile")
        if cfg.contains("ladderMode"):
            ladder_mode = cfg.get_string("ladderMode",
                                         allowed=["chase", "exact"])
        warn_unused(cfg, log=lambda s: print(s, file=sys.stderr))
    if args.visits:
        visits = args.visits

    engine = GTPEngine(model_path=args.model, size=args.boardsize,
                       rules=rules, visits=visits,
                       search_params=search_params,
                       allow_resignation=allow_resignation,
                       resign_threshold=resign_threshold,
                       resign_consec_turns=resign_consec_turns,
                       ponder=ponder, anti_mirror=anti_mirror,
                       human_sl_profile=human_sl_profile,
                       ladder_mode=ladder_mode, device=args.device,
                       seed=args.seed)
    if lag_buffer is not None:
        engine.lag_buffer = lag_buffer
    run_gtp(engine, infile or sys.stdin, outfile or sys.stdout)
    return engine


if __name__ == "__main__":
    main()
