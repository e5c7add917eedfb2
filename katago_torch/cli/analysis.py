"""JSON-lines analysis engine — port of katago_tpu/cli/analysis.py
(reference cpp/command/analysis.cpp).

Protocol per the reference's Analysis_Engine.md: one JSON object per
input line with "id", "moves" ([[player,"gtpvertex"],...]), "rules",
"komi", "boardXSize"/"boardYSize", "analyzeTurns", "maxVisits", ...;
responses are JSON lines matched by id with moveInfos (move, visits,
winrate, scoreMean, scoreLead, lcb, utilityLcb, scoreStdev, prior,
order, pv, ...), rootInfo, and optional ownership / policy / per-move
ownership. Special actions: query_version, clear_cache, terminate,
terminate_all, query_models.

Scheduling: requests split into per-turn tasks ordered by (priority
desc, arrival asc); the main loop drains every already-available request
line before starting the next task, so later higher-priority queries and
terminate actions overtake queued work as the reference's queue does.
Each task is one search of one game on `device` (CUDA unless
`-device cpu`; with no CUDA and no -device it raises).

Per-query `overrideSettings` maps SearchParams keys through
utils/setup.apply_overrides; its `humanSLProfile` conditions a humanSL
net's evaluations on that profile's metadata row. V3-V6 nets are fed
their own input features. A cross-search tree cache keyed by the root's
position hash and the profile (LRU of 8) warm-starts exact repeats.
"""

from __future__ import annotations

import argparse
import json
import select
import sys

import numpy as np
import torch

from katago_torch.cli.gtp import gtp_to_loc, loc_to_gtp
from katago_torch.device import resolve_device
from katago_torch.game import board as B
from katago_torch.game import history as H
from katago_torch.game import rules as R
from katago_torch.search import mcts
from katago_torch.search.driver import SearchDriver, split_generator
from katago_torch.search.params import SearchParams
from katago_torch.utils import setup as SETUP

VERSION = "0.1.0"


def _default_params() -> SearchParams:
    return SearchParams(
        root_noise_enabled=False, cpuct_exploration_log=0.45,
        static_score_utility_factor=0.1,
        dynamic_score_utility_factor=0.3,
        root_symmetry_pruning=True,
        root_ending_bonus_points=0.5,
        root_prune_useless_moves=True)


class AnalysisEngine:
    def __init__(self, model_path: str | None, default_visits: int = 100,
                 ladder_mode: str = "chase",
                 report_winrates_as: str = "SIDETOMOVE", device=None,
                 seed: int = 0):
        self.device = resolve_device(device)
        self.default_visits = default_visits
        self.report_winrates_as = report_winrates_as.upper()
        # in-search ladder featurization: "chase" (the default) or
        # "exact" (the backtracking solver)
        self.ladder_mode = ladder_mode
        if model_path:
            from katago_torch.models import desc as D
            self.desc = D.load_model(model_path)
            self.net = D.DescNet(self.desc).to(self.device).eval()
            self.model_name = self.desc.name
        else:
            self.desc = None
            self.net = None
            self.model_name = "none"
        self.base_params = _default_params()
        self._drivers: dict = {}
        self._profile_cache: dict = {}
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self._seq = 0
        # cross-search cache: the search tree is the table of prior-search
        # values (search/evalcache in the reference), so the cache holds
        # recent searches' trees keyed by root position hash, and a repeat
        # query warm starts from the cached tree (its visits count toward
        # maxVisits, so an exact repeat returns without new playouts).
        # LRU-bounded; cleared by the clear_cache action.
        self.tree_cache_size = 8
        self._tree_cache: dict = {}   # (hash, size, profile) -> Tree
        self._tree_cache_hits = 0
        self._tree_cache_misses = 0

    @property
    def feature_version(self) -> int:
        """The net's input-feature version (V3-V6 nets get their own)."""
        return self.desc.input_version if self.desc is not None else 7

    def _sgf_meta(self, profile: str | None):
        """SGFMetadata of an overrideSettings humanSLProfile (analysis.cpp
        humanSLProfile; models/sgfmetadata.py profiles)."""
        if not profile:
            return None
        if profile not in self._profile_cache:
            from katago_torch.models.sgfmetadata import get_profile
            if self.desc is not None and \
                    self.desc.trunk.get("meta_encoder") is None:
                raise ValueError(
                    "humanSLProfile requires a metadata-encoder net")
            self._profile_cache[profile] = get_profile(profile)
        return self._profile_cache[profile]

    def _driver(self, size: int, visits: int, profile: str | None = None
                ) -> SearchDriver:
        key = (size, profile)
        d = self._drivers.get(key)
        if d is None or d.max_nodes < visits + 3:   # bigger budget: rebuild
            d = SearchDriver(
                self.net, self.base_params.to_arr(self.device), size=size,
                max_nodes=visits + 3, chunk_size=max(visits // 8, 4),
                ladder_mode=self.ladder_mode,
                feature_version=self.feature_version,
                sgf_meta=self._sgf_meta(profile), device=self.device)
            self._drivers[key] = d
        return d

    # -- protocol ----------------------------------------------------------

    def handle(self, req: dict, emit=None) -> list[dict]:
        """Process one request completely, returning its responses in
        turn order (the single-query path; the priority and terminate
        scheduling lives in run_protocol).

        emit: optional callable(resp_dict) for streaming partial reports
        (reportDuringSearchEvery) — partial responses carry
        isDuringSearch=true, the returned final ones false."""
        act = self.handle_action(req)
        if act is not None:
            return act
        warnings, tasks, err = self.prepare_tasks(req)
        if err is not None:
            return warnings + [err]
        out = []
        for t in sorted(tasks, key=lambda t: t["turn"]):
            out.append(self.run_task(t, emit))
        return warnings + out

    def handle_action(self, req: dict) -> list[dict] | None:
        """Non-analysis actions; None when req is an analyze query.
        terminate bookkeeping against a queue happens in run_protocol —
        here terminate/terminate_all simply acknowledge."""
        action = req.get("action")
        if action == "query_version":
            return [{"id": req.get("id"), "action": "query_version",
                     "version": VERSION, "git_hash": ""}]
        if action == "clear_cache":
            self._tree_cache.clear()
            return [{"id": req.get("id"), "action": "clear_cache"}]
        if action in ("terminate", "terminate_all"):
            return [{"id": req.get("id"), "action": action}]
        if action == "query_models":
            return [{"id": req.get("id"), "action": "query_models",
                     "models": [{"name": self.model_name,
                                 "internalName": self.model_name,
                                 "maxBatchSize": -1,
                                 "usesHumanSLProfile": False}]}]
        return None

    KNOWN_FIELDS = {
        "id", "action", "boardXSize", "boardYSize", "moves",
        "initialStones", "initialPlayer", "rules", "komi", "analyzeTurns",
        "maxVisits", "includeOwnership", "includeOwnershipStdev",
        "includeMovesOwnership", "includeMovesOwnershipStdev",
        "includePolicy", "includePVVisits", "avoidMoves", "allowMoves",
        "reportDuringSearchEvery", "firstReportDuringSearchAfter",
        "overrideSettings", "priority", "priorities",
        "whiteHandicapBonus", "terminateId", "turnNumbers",
    }

    def _field_warnings(self, req: dict) -> list[dict]:
        """Typo protection per the reference: unknown top-level fields and
        unknown overrideSettings keys come back as warning responses
        ahead of the result."""
        rid = req.get("id")
        out = []
        override = dict(req.get("overrideSettings") or {})
        override.pop("humanSLProfile", None)
        _, unknown_over = SETUP.apply_overrides(self.base_params, override)
        if unknown_over:
            out.append({"id": rid, "field": "overrideSettings",
                        "warning": "Unknown config params: "
                        + ",".join(sorted(unknown_over))})
        for k in sorted(req):
            if k not in self.KNOWN_FIELDS:
                out.append({"id": rid, "field": k,
                            "warning": "Unexpected or unused field, do "
                            "you have a typo? (set warnUnusedFields="
                            "false in the config to disable this "
                            "warning)"})
        return out

    # -- query preparation -------------------------------------------------

    def prepare_tasks(self, req: dict):
        """Parse and replay an analyze query into per-turn tasks.

        Returns (warnings, tasks, error_resp). Each task dict carries
        everything run_task needs plus "priority" and "seq" for the
        scheduler."""
        rid = req.get("id")
        if rid is None:
            return [], [], {"error": "request has no id"}
        warnings = self._field_warnings(req)
        if self.net is None:
            return warnings, [], {"id": rid, "error":
                                  "no model loaded (start with -model "
                                  "<file>)"}
        try:
            tasks = self._build_tasks(req)
        except Exception as e:  # noqa: BLE001 — protocol answers, not dies
            return warnings, [], {"id": rid,
                                  "error": f"{type(e).__name__}: {e}"}
        return warnings, tasks, None

    def _build_tasks(self, req: dict) -> list[dict]:
        rid = req["id"]
        xs = int(req.get("boardXSize", 19))
        ys = int(req.get("boardYSize", xs))
        size = max(xs, ys)
        nn = size * size
        rules = R.Rules.parse(req["rules"]) \
            if isinstance(req.get("rules"), str) \
            else (R.Rules.from_json(req["rules"]) if req.get("rules")
                  else R.Rules.tromp_taylorish())
        if "komi" in req:
            rules = R.Rules(**{**rules.__dict__, "komi": float(req["komi"])})
        visits = int(req.get("maxVisits", self.default_visits))
        # overrideSettings: arbitrary per-query SearchParams, plus the
        # maxVisits limit and humanSLProfile specials
        override = dict(req.get("overrideSettings") or {})
        if "maxVisits" in override:
            visits = int(override.pop("maxVisits"))
        profile = override.pop("humanSLProfile", None) or None
        if profile is not None:
            self._sgf_meta(profile)   # raise early on profiles
        params, _ = SETUP.apply_overrides(self.base_params, override)

        moves = req.get("moves", [])
        initial = req.get("initialStones", [])

        player_of = {"B": B.BLACK, "W": B.WHITE,
                     "b": B.BLACK, "w": B.WHITE}
        max_hist = 2 * nn + 64 + len(moves)
        shape = None
        if xs != ys:
            m = np.zeros((size, size), bool)
            m[:ys, :xs] = True
            shape = torch.from_numpy(m.reshape(-1))
        gs = H.new_game(size, rules, max_hist, device=self.device,
                        shape_mask=shape)
        for color, vert in initial:
            loc = gtp_to_loc(vert, size, xs, ys)
            gs = H.setup_stone(gs, loc, player_of[color], size)

        def one(v):
            return torch.tensor([v], dtype=torch.int64, device=self.device)

        # initialPlayer: who moves first from the initial position
        ip = str(req.get("initialPlayer", "")).upper()[:1]
        if ip in ("B", "W"):
            gs = H.replace_pos(gs, to_move=one(player_of[ip]))

        analyze_turns = req.get("analyzeTurns", [len(moves)])
        priorities = req.get("priorities")
        if priorities is not None and len(priorities) != len(analyze_turns):
            raise ValueError("priorities must be parallel to analyzeTurns")
        prio_of = {}
        for i, t in enumerate(analyze_turns):
            prio_of[t] = (int(priorities[i]) if priorities is not None
                          else int(req.get("priority", 0)))
        states: dict[int, H.GameState] = {}
        if 0 in analyze_turns:
            states[0] = gs
        for i, (color, vert) in enumerate(moves):
            gs = H.replace_pos(gs, to_move=one(player_of[color]))
            gs, _ = H.step(gs, one(gtp_to_loc(vert, size, xs, ys)), size)
            if (i + 1) in analyze_turns:
                states[i + 1] = gs
        missing = [t for t in analyze_turns if t not in states]
        if missing:
            raise ValueError(f"analyzeTurns beyond the game: {missing}")

        ctx = {
            "rid": rid, "size": size, "xs": xs, "ys": ys,
            "visits": visits, "params": params, "profile": profile,
            "want_ownership": bool(req.get("includeOwnership", False)),
            "want_own_stdev": bool(req.get("includeOwnershipStdev", False)),
            "want_moves_own": bool(req.get("includeMovesOwnership", False)),
            "want_moves_own_stdev":
                bool(req.get("includeMovesOwnershipStdev", False)),
            "want_policy": bool(req.get("includePolicy", False)),
            "want_pv_visits": bool(req.get("includePVVisits", False)),
            "report_every": req.get("reportDuringSearchEvery"),
            "first_report_after": req.get("firstReportDuringSearchAfter"),
            "avoid": req.get("avoidMoves"), "allow": req.get("allowMoves"),
        }
        tasks = []
        for turn, state in states.items():
            self._seq += 1
            tasks.append(dict(ctx, turn=turn, state=state,
                              priority=prio_of[turn], seq=self._seq))
        return tasks

    # -- per-turn execution ------------------------------------------------

    def run_task(self, task: dict, emit=None) -> dict:
        try:
            return self._run_task(task, emit)
        except Exception as e:  # noqa: BLE001
            return {"id": task["rid"], "turnNumber": task["turn"],
                    "error": f"{type(e).__name__}: {e}"}

    def _root_mask(self, task: dict, pla_char: str):
        """avoidMoves / allowMoves of the mover at depth >= 1 ->
        bool[1, A] (True = allowed), or None."""
        size, xs, ys = task["size"], task["xs"], task["ys"]

        def vertex_set(entries):
            locs = set()
            for e in entries or []:
                pl = str(e.get("player", "")).upper()[:1]
                if pl not in ("", pla_char):
                    continue
                if int(e.get("untilDepth", 1)) < 1:
                    continue
                for v in e.get("moves", []):
                    locs.add(gtp_to_loc(v, size, xs, ys))
            return locs

        avoid = vertex_set(task["avoid"])
        allow = vertex_set(task["allow"])
        if not (avoid or allow):
            return None
        mask = np.ones((1, size * size + 1), bool)
        if allow:
            mask[:] = False
            for loc in allow:
                mask[0, loc] = True
        for loc in avoid:
            mask[0, loc] = False
        return torch.from_numpy(mask).to(self.device)

    def _run_task(self, task: dict, emit=None) -> dict:
        rid, turn, state = task["rid"], task["turn"], task["state"]
        size = task["size"]
        visits = task["visits"]
        meta = self._sgf_meta(task["profile"])
        sp_arr = task["params"].to_arr(self.device)
        mo = task["want_moves_own"] or task["want_moves_own_stdev"]
        sub = split_generator(self.gen)
        pla_char = "B" if int(state.pos.to_move[0]) == B.BLACK else "W"
        mask = self._root_mask(task, pla_char)
        # cross-search tree cache: exact-position repeats warm start from
        # the cached tree. Moves ownership accumulates during playouts,
        # so a warm start that needs no new playouts could not report it:
        # those queries skip the cache
        cache_key = None
        cached_tree = None
        if mask is None and not mo and self.tree_cache_size > 0:
            # a tree searched under one humanSL profile is not another's
            cache_key = (self._position_hashes(state, size)[0], size,
                         task["profile"])
            cached_tree = self._tree_cache.get(cache_key)
            if cached_tree is not None and \
                    cached_tree.visits.shape[1] > visits + 3:
                cached_tree = None   # pool bigger than this query's driver
            if cached_tree is not None:
                self._tree_cache_hits += 1
                print(f"evalcache hit {cache_key[0][:8]} "
                      f"(cached visits {int(cached_tree.visits[0, 0])}, "
                      f"hits {self._tree_cache_hits} misses "
                      f"{self._tree_cache_misses})", file=sys.stderr)
            else:
                self._tree_cache_misses += 1

        report_every = task["report_every"]
        first_after = float(task["first_report_after"] or 0.0)

        def cb(partial, elapsed):
            if cached_tree is None and elapsed < first_after:
                return
            resp = self._response(rid, turn, state, partial, task)
            resp["isDuringSearch"] = True
            emit(resp)

        streaming = report_every is not None and emit is not None
        if cached_tree is not None or streaming:
            res = self._driver(size, visits, task["profile"]).search(
                state, sub, max_visits=visits, prev_tree=cached_tree,
                root_allowed_mask=mask,
                callback=cb if streaming else None,
                callback_interval=float(report_every or 1.0),
                sp=sp_arr, track_moves_ownership=mo)
        else:
            # maxVisits counts the root's own eval (searchparams.h:131):
            # `visits` playouts under a root-visit cap of `visits`
            res = mcts.run_search(
                self.net, state, sp_arr, sub, size=size, num_sims=visits,
                max_nodes=visits + 3, max_visits=visits,
                ladder_mode=self.ladder_mode, root_allowed_mask=mask,
                feature_version=self.feature_version, sgf_meta=meta,
                track_moves_ownership=mo)
        if cache_key is not None:
            self._tree_cache.pop(cache_key, None)
            self._tree_cache[cache_key] = res.ss.tree
            while len(self._tree_cache) > self.tree_cache_size:
                self._tree_cache.pop(next(iter(self._tree_cache)))
        resp = self._response(rid, turn, state, res, task)
        if report_every is not None:
            resp["isDuringSearch"] = False
        return resp

    # -- response assembly -------------------------------------------------

    def _response(self, rid, turn, state, res, task: dict) -> dict:
        size, xs, ys = task["size"], task["xs"], task["ys"]
        sp_arr = task["params"].to_arr(self.device)
        cv = res.child_visits[0].cpu().numpy()
        prior = res.root_policy_prior[0].cpu().numpy()
        tree = res.ss.tree
        player = int(state.pos.to_move[0])
        # winrate/score perspective (reportAnalysisWinratesAs):
        # SIDETOMOVE (default), BLACK, or WHITE
        if self.report_winrates_as == "BLACK":
            sign = -1.0
        elif self.report_winrates_as == "WHITE":
            sign = 1.0
        else:
            sign = 1.0 if player == B.WHITE else -1.0

        move_infos = []
        order = np.argsort(cv)[::-1]
        # continuation PVs for the top candidates in one batched descent
        top = [a for rank, a in enumerate(order) if cv[a] > 0 and rank < 15]
        if top:
            starts = tree.children[0, 0, torch.as_tensor(
                top, device=tree.children.device)].long()
            pv_moves, pv_lens = mcts.extract_pv(
                tree, max_len=14, start=starts,
                games=torch.zeros_like(starts))
            pv_moves = pv_moves.cpu().numpy()
            pv_lens = pv_lens.cpu().numpy()
        # per-child LCB / stdev extras (searchresults.cpp getJson)
        extras = {k: v[0].cpu().numpy() for k, v in
                  mcts.child_analysis_extras(res, sp_arr).items()}
        # the tree to the host once: per-scalar reads cost a sync each
        children_all_h = tree.children[0].long().cpu().numpy()
        children_h = children_all_h[0]
        visits_h = tree.visits[0].cpu().numpy()
        st = tree.stats[0].cpu().numpy()
        weight_h = st[:, mcts.C_WEIGHT_SUM]
        winloss_h = st[:, mcts.C_WINLOSS_SUM]
        score_h = st[:, mcts.C_SCORE_MEAN_SUM]
        lead_h = st[:, mcts.C_LEAD_SUM]
        util_h = st[:, mcts.C_UTILITY_SUM]
        if task["want_moves_own"] or task["want_moves_own_stdev"]:
            moves_own_h = res.moves_ownership[0].cpu().numpy()
            moves_own_sd_h = res.moves_ownership_stdev[0].cpu().numpy()
            moves_own_w_h = res.moves_own_weight[0].cpu().numpy()

        def pv_visits_of(start, moves):
            """Visit counts along a PV's nodes (includePVVisits): one
            count per PV move, including the final node's."""
            node = int(start)
            out = [int(visits_h[node])]
            for mv in moves:
                nxt = int(children_all_h[node, mv]) if mv >= 0 else -1
                if nxt < 0:
                    break
                node = nxt
                out.append(int(visits_h[node]))
            return out

        def vertex(loc):
            return loc_to_gtp(int(loc), size, xs, ys)

        for rank, a in enumerate(order):
            if cv[a] <= 0 or rank >= 15:
                break
            child = int(children_h[a])
            w = max(float(weight_h[child]), 1e-9)
            winloss = sign * float(winloss_h[child]) / w
            score = sign * float(score_h[child]) / w
            lead = sign * float(lead_h[child]) / w
            util = sign * float(util_h[child]) / w
            # white-persp lcb fields -> requested perspective
            # (searchresults.cpp getJson flip)
            lcb = float(extras["lcb"][a])
            ulcb = float(extras["utility_lcb"][a])
            if sign < 0:
                lcb = 1.0 - lcb
                ulcb = -ulcb
            pv_rest = list(pv_moves[rank][:pv_lens[rank]])
            info = {
                "move": vertex(a),
                "visits": int(cv[a]),
                "edgeVisits": int(cv[a]),
                "weight": float(extras["weight"][a]),
                "edgeWeight": float(extras["weight"][a]),
                "winrate": 0.5 * (1.0 + winloss),
                "scoreMean": lead,
                "scoreLead": lead,
                "scoreSelfplay": score,
                "scoreStdev": float(extras["score_stdev"][a]),
                "utility": util,
                "lcb": lcb,
                "utilityLcb": ulcb,
                "prior": float(max(prior[a], 0.0)),
                "order": rank,
                "pv": [vertex(a)] + [vertex(m) for m in pv_rest],
            }
            if task["want_pv_visits"]:
                info["pvVisits"] = pv_visits_of(child, pv_rest)
            if task["want_moves_own"] and moves_own_w_h[a] > 0:
                info["ownership"] = [round(sign * float(v), 4)
                                     for v in moves_own_h[a]]
            if task["want_moves_own_stdev"] and moves_own_w_h[a] > 0:
                info["ownershipStdev"] = [round(float(v), 4)
                                          for v in moves_own_sd_h[a]]
            move_infos.append(info)

        this_hash, sym_hash = self._position_hashes(state, size)
        resp = {
            "id": rid,
            "turnNumber": turn,
            "moveInfos": move_infos,
            "rootInfo": {
                "currentPlayer": "B" if player == B.BLACK else "W",
                "visits": int(res.root_visits[0]),
                "weight": float(weight_h[0]),
                "winrate": 0.5 * (1.0 + sign * float(res.root_winloss[0])),
                "scoreLead": sign * float(res.root_lead[0]),
                "scoreSelfplay": sign * float(res.root_score_mean[0]),
                "utility": sign * float(res.root_utility[0]),
                "thisHash": this_hash,
                "symHash": sym_hash,
            },
        }
        if task["want_ownership"]:
            # tree-averaged ownership (getAverageTreeOwnership)
            own = res.root_ownership[0].cpu().numpy()
            resp["ownership"] = [round(sign * float(v), 4) for v in own]
        if task["want_own_stdev"]:
            ostd = res.root_ownership_stdev[0].cpu().numpy()
            resp["ownershipStdev"] = [round(float(v), 4) for v in ostd]
        if task["want_policy"]:
            resp["policy"] = [round(float(max(p, -1.0)), 6) for p in prior]
        return resp

    def _position_hashes(self, state, size: int) -> tuple[str, str]:
        """rootInfo thisHash / symHash (searchresults.cpp:2162-2163):
        thisHash = the position's zobrist with the mover; symHash = its
        minimum over the 8 dihedral symmetries (64-bit, not the
        reference's Hash128 — the same role)."""
        from katago_torch.game import zobrist as Z
        from katago_torch.ops import symmetry as SYM
        nn = size * size
        stones = state.pos.board.stones[0].cpu().numpy().reshape(-1)
        tm = int(state.pos.to_move[0])
        tab = Z.stone_table_np(size)[:, :nn]  # [2, NN, 2] uint32 lane pairs
        ptab = Z.player_table_np()
        perm = SYM.loc_perm_np(size)[:, :nn]  # [8, NN] (drop the pass slot)

        def hash_of(st):
            hi = np.uint64(0)
            for v, row in ((B.BLACK, 0), (B.WHITE, 1)):
                sel = st == v
                if sel.any():
                    h = tab[row][sel].astype(np.uint64)
                    hi ^= np.bitwise_xor.reduce(
                        (h[:, 0] << np.uint64(32)) | h[:, 1])
            if tm == B.BLACK:
                hi ^= np.uint64((int(ptab[0, 0]) << 32) | int(ptab[0, 1]))
            return int(hi)

        this_h = hash_of(stones)
        sym_h = min(hash_of(stones[perm[s]]) for s in range(8))
        return f"{this_h:016X}", f"{sym_h:016X}"


def main(argv=None, infile=None, outfile=None):
    ap = argparse.ArgumentParser(description="katago_torch analysis engine")
    ap.add_argument("-model", default=None)
    ap.add_argument("-analysis-threads", type=int, default=1)
    ap.add_argument("-ladder-mode", default="chase",
                    choices=["chase", "exact"])
    ap.add_argument("-report-winrates-as", default="SIDETOMOVE",
                    choices=["SIDETOMOVE", "BLACK", "WHITE"],
                    help="perspective of winrate/score outputs "
                         "(reportAnalysisWinratesAs)")
    ap.add_argument("-device", default=None,
                    help="cpu or cuda (default: cuda; raises without it)")
    ap.add_argument("-seed", type=int, default=0)
    args = ap.parse_args(argv)

    engine = AnalysisEngine(args.model, ladder_mode=args.ladder_mode,
                            report_winrates_as=args.report_winrates_as,
                            device=args.device, seed=args.seed)
    run_protocol(engine, infile or sys.stdin, outfile or sys.stdout)
    return engine


def run_protocol(engine: AnalysisEngine, infile, outfile):
    """The input/output protocol loop with the reference's scheduling
    (analysis.cpp): per-turn tasks execute by (priority desc, arrival
    asc); terminate / terminate_all drop queued tasks by id (and
    optionally turnNumbers), answering noResults for tasks that never
    ran. All already-available input is drained before each task so
    control actions and higher-priority queries overtake the queue."""

    def emit(obj):
        outfile.write(json.dumps(obj) + "\n")
        outfile.flush()

    pending: list[dict] = []   # task dicts, scheduled below
    done = False
    try:
        infile.fileno()
        selectable = True
    except Exception:  # noqa: BLE001 — StringIO/file-like test drivers
        selectable = False

    def drain(block: bool):
        nonlocal done
        while True:
            if done:
                return
            if not block and selectable:
                try:
                    r, _, _ = select.select([infile], [], [], 0)
                except (ValueError, OSError, TypeError):
                    return
                if not r:
                    return
            line = infile.readline()
            block = False
            if line == "":
                done = True
                return
            line = line.strip()
            if not line:
                continue
            try:
                req = json.loads(line)
            except json.JSONDecodeError as e:
                emit({"error": f"bad json: {e}"})
                continue
            action = req.get("action")
            if action in ("terminate", "terminate_all"):
                tid = req.get("terminateId")
                if action == "terminate" and tid is None:
                    emit({"id": req.get("id"),
                          "error": "terminate requires terminateId"})
                    continue
                turns = req.get("turnNumbers")
                keep, dropped = [], []
                for t in pending:
                    match = (action == "terminate_all" or t["rid"] == tid)
                    if match and (turns is None or t["turn"] in turns):
                        dropped.append(t)
                    else:
                        keep.append(t)
                pending[:] = keep
                for t in dropped:
                    emit({"id": t["rid"], "turnNumber": t["turn"],
                          "isDuringSearch": False, "noResults": True})
                emit({"id": req.get("id"), "action": action})
                continue
            resp = engine.handle_action(req)
            if resp is not None:
                for r_ in resp:
                    emit(r_)
                continue
            warnings, tasks, err = engine.prepare_tasks(req)
            for w in warnings:
                emit(w)
            if err is not None:
                emit(err)
                continue
            pending.extend(tasks)

    while True:
        drain(block=False)
        if not pending:
            if done:
                return
            drain(block=True)
            continue
        # highest priority first; FIFO within a priority level
        pending.sort(key=lambda t: (-t["priority"], t["seq"]))
        task = pending.pop(0)
        emit(engine.run_task(task, emit))


if __name__ == "__main__":
    main()
