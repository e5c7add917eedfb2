"""Opening book generation — the reference's cpp/book layer (L11); port
of katago_tpu/book/book.py.

The reference Book (book.h:353, ~3.4k LoC) is a persistent graph of
BookNodes keyed by a symmetry-canonical position hash, expanded by a
cost model over search values/errors, serialized and exported as HTML
(katagobooks.org). The node graph, minimax value recursion and the
expansion cost model live on the host (tiny, pointer-chasing work, the
JAX package's numpy code kept line for line), while every node
evaluation is one *batched* `run_search` call on the device — the
expansion frontier of a round is searched as a single [G]-batch instead
of the reference's thread-per-position search pool.

Implemented pieces:
  - BookParams: the expansion cost-model knobs (book.h:281-344), with
    defaults taken from the reference's production config
    cpp/configs/book/genbook7jp.cfg:23-40.
  - BookValues / RecursiveValues per node (book.h:67-112): search
    values + shortterm-error UCB/LCBs, minimaxed over the graph
    (Book::recomputeNodeValues, book.cpp:1726-1831).
  - Expansion cost (Book::recomputeNodeCost, book.cpp:1955-2530):
    per-move costFromRoot and thisNodeExpansionCost with UCB winloss
    losses (pow 1/3/7), score loss, soft policy boosts, pass-favored
    cost, moves-expanded penalties with the utility-gain cap, the
    winloss-PV bonus, biggestWLCost bonus, error/discrepancy bonuses,
    excess-unexpanded-policy bonus, unexpanded-best-winloss bonus, and
    the 0.8*smallestCostFromUCB replenishment + 70% better-than-move
    cost reductions. (bonusBehindInVisitsScale and the re-expansion
    visit-boost, both 0/off in the reference production configs, are
    not implemented.)
  - `thisValuesNotInBook` semantics: each expansion searches the node
    with the root restricted to moves NOT yet in the book
    (run_search root_allowed_mask), the reference's "comprehensive
    coverage" search (book.h:125-135).
  - JSON save/load (the JAX package's format); HTML export with
    clickable child links (writebook).

The expansion loop mirrors genbook.cpp:1509-1530: each round picks the
`getNextNToExpand` cheapest nodes by minCostFromRoot +
thisNodeExpansionCost (book.cpp:1265-1280), searches them as one
batch, adds each node's best not-in-book move as a child, searches the
new children as a second batch for their leaf values, then recomputes
values and costs. The searches run without ladder planes
(with_ladders=False), as the JAX package's do.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
from typing import Callable

import numpy as np
import torch

from katago_torch import _tensortree as T
from katago_torch.game import board as B
from katago_torch.game import history as H
from katago_torch.game import rules as R

PASS = -1  # book-space pass loc (engine pass action = size*size)


def canonical_hash(stones: np.ndarray, to_move: int, size: int) -> str:
    """Minimum position hash over the 8 dihedral symmetries (the
    reference's BookHash symmetry canonicalization, book.h:14-66)."""
    best = None
    a = np.asarray(stones, np.int8).reshape(size, size)
    for k in range(4):
        r = np.rot90(a, k)
        for f in (r, r.T):
            key = f.tobytes()
            if best is None or key < best:
                best = key
    h = hashlib.blake2b(best + bytes([to_move]), digest_size=16)
    return h.hexdigest()


@dataclasses.dataclass
class BookParams:
    """Cost-model parameters (book.h:281-344). Defaults follow the
    reference's production 7x7 book config (genbook7jp.cfg:23-40)."""
    error_factor: float = 1.5
    cost_per_move: float = 0.45
    cost_per_ucb_winloss_loss: float = 4.50
    cost_per_ucb_winloss_loss_pow3: float = 0.75
    cost_per_ucb_winloss_loss_pow7: float = 0.75
    cost_per_ucb_score_loss: float = 0.75
    cost_per_log_policy: float = 0.75
    cost_per_moves_expanded: float = 0.25
    cost_per_squared_moves_expanded: float = 0.05
    cost_when_pass_favored: float = 0.0
    bonus_per_winloss_error: float = 1.0
    bonus_per_score_error: float = 0.03
    bonus_per_sharp_score_discrepancy: float = 0.15
    bonus_per_excess_unexpanded_policy: float = 2.0
    bonus_per_unexpanded_best_winloss: float = 1.5
    bonus_for_wl_pv1: float = 0.03
    bonus_for_wl_pv2: float = 0.15
    bonus_for_wl_pv_final_prop: float = 0.5
    bonus_for_biggest_wl_cost: float = 0.20
    score_loss_cap: float = 10000.0
    early_book_cost_reduction_factor: float = 0.0
    early_book_cost_reduction_lambda: float = 0.0
    utility_per_score: float = 0.0
    policy_boost_soft_utility_scale: float = 0.04
    utility_per_policy_for_sorting: float = 0.02
    visits_scale: float = 1000.0
    sharp_score_outlier_cap: float = 10000.0

    _CFG_KEYS = {
        "errorFactor": "error_factor",
        "costPerMove": "cost_per_move",
        "costPerUCBWinLossLoss": "cost_per_ucb_winloss_loss",
        "costPerUCBWinLossLossPow3": "cost_per_ucb_winloss_loss_pow3",
        "costPerUCBWinLossLossPow7": "cost_per_ucb_winloss_loss_pow7",
        "costPerUCBScoreLoss": "cost_per_ucb_score_loss",
        "costPerLogPolicy": "cost_per_log_policy",
        "costPerMovesExpanded": "cost_per_moves_expanded",
        "costPerSquaredMovesExpanded": "cost_per_squared_moves_expanded",
        "costWhenPassFavored": "cost_when_pass_favored",
        "bonusPerWinLossError": "bonus_per_winloss_error",
        "bonusPerScoreError": "bonus_per_score_error",
        "bonusPerSharpScoreDiscrepancy": "bonus_per_sharp_score_discrepancy",
        "bonusPerExcessUnexpandedPolicy": "bonus_per_excess_unexpanded_policy",
        "bonusPerUnexpandedBestWinLoss": "bonus_per_unexpanded_best_winloss",
        "bonusForWLPV1": "bonus_for_wl_pv1",
        "bonusForWLPV2": "bonus_for_wl_pv2",
        "bonusForWLPVFinalProp": "bonus_for_wl_pv_final_prop",
        "bonusForBiggestWLCost": "bonus_for_biggest_wl_cost",
        "scoreLossCap": "score_loss_cap",
        "earlyBookCostReductionFactor": "early_book_cost_reduction_factor",
        "earlyBookCostReductionLambda": "early_book_cost_reduction_lambda",
        "utilityPerScore": "utility_per_score",
        "policyBoostSoftUtilityScale": "policy_boost_soft_utility_scale",
        "utilityPerPolicyForSorting": "utility_per_policy_for_sorting",
        "visitsScale": "visits_scale",
        "sharpScoreOutlierCap": "sharp_score_outlier_cap",
    }

    @classmethod
    def from_config(cls, cfg: dict) -> "BookParams":
        """Build from a reference-keyed config mapping (genbook.cfg)."""
        p = cls()
        for ref_key, field in cls._CFG_KEYS.items():
            if ref_key in cfg:
                setattr(p, field, float(cfg[ref_key]))
        return p


@dataclasses.dataclass
class BookValues:
    """Values from searching this node excluding in-book moves
    (book.h:67-90 thisValuesNotInBook). White perspective."""
    winloss: float = 0.0
    score_mean: float = 0.0
    winloss_error: float = 0.0    # shortterm wl error head at the root
    score_error: float = 0.0      # shortterm score error head
    score_stdev: float = 0.0      # full-game score stdev head
    max_policy: float = 0.0       # max prior over not-in-book moves
    weight: float = 0.0
    visits: float = 0.0

    def adjusted_winloss_error(self) -> float:
        # book.cpp:220-226
        return max(self.winloss_error, 0.0)

    def adjusted_score_error(self, integer_result: bool) -> float:
        # book.cpp:228-246: draw-allowed integer-result games blur score
        # on half-integer gridpoints, inflating variance by 0.25.
        if self.score_error < 0:
            return 0.0
        if integer_result:
            var = self.score_stdev * self.score_stdev
            adj = max(var - 0.25, var * 0.05)
            return min(math.sqrt(adj), self.score_error)
        return min(self.score_stdev, self.score_error)


@dataclasses.dataclass
class RecursiveValues:
    """Minimaxed values over the book graph (book.h:91-112)."""
    winloss: float = 0.0
    score_mean: float = 0.0
    winloss_lcb: float = 0.0
    winloss_ucb: float = 0.0
    score_lcb: float = 0.0
    score_ucb: float = 0.0
    score_final_lcb: float = 0.0
    score_final_ucb: float = 0.0
    weight: float = 0.0
    visits: float = 0.0


@dataclasses.dataclass
class BookMove:
    loc: int
    child_hash: str
    raw_policy: float
    cost_from_root: float = 0.0
    biggest_wl_cost: float = 0.0
    is_wlpv: bool = False


@dataclasses.dataclass
class BookNode:
    hash: str
    moves_from_root: list      # one representative line from the root
    to_move: int
    this_values: BookValues = dataclasses.field(default_factory=BookValues)
    recursive: RecursiveValues = dataclasses.field(
        default_factory=RecursiveValues)
    moves: dict = dataclasses.field(default_factory=dict)  # loc -> BookMove
    parents: list = dataclasses.field(default_factory=list)  # (hash, loc)
    can_expand: bool = True
    searched: bool = False     # this_values populated at least once
    # cost-model state (recomputed, not saved)
    min_depth: int = 0
    min_cost_from_root: float = 0.0
    min_cost_wlpv: float = 0.0
    expansion_is_wlpv: bool = False
    biggest_wl_cost_from_root: float = 0.0
    expansion_cost: float = 0.0

    @property
    def winloss(self) -> float:       # back-compat accessors
        return self.recursive.winloss

    @property
    def score_mean(self) -> float:
        return self.recursive.score_mean

    @property
    def visits(self) -> int:
        return int(self.this_values.visits)

    @property
    def policy(self):
        """Top prior moves [(loc, prob)] among expanded children."""
        out = [(m.loc, m.raw_policy) for m in self.moves.values()]
        out.sort(key=lambda t: -t[1])
        return out or None


def _pow3(x):
    return x * x * x


def _pow7(x):
    return x ** 7 if x >= 0 else -((-x) ** 7)


class Book:
    def __init__(self, size: int = 19, rules: R.Rules | None = None,
                 params: BookParams | None = None, device=None):
        """device: where nodes are replayed and searched (CUDA unless
        the caller names another)."""
        from katago_torch.device import resolve_device
        self.size = size
        self.device = resolve_device(device)
        self.rules = rules or R.Rules.tromp_taylorish()
        self.params = params or BookParams()
        self.nodes: dict[str, BookNode] = {}
        root_stones = np.zeros(size * size, np.int8)
        rh = canonical_hash(root_stones, B.BLACK, size)
        self.root_hash = rh
        self.nodes[rh] = BookNode(hash=rh, moves_from_root=[],
                                  to_move=B.BLACK)

    # ---- persistence ----
    def save(self, path: str):
        data = {
            "size": self.size,
            "rules": self.rules.to_json_string(),
            "params": dataclasses.asdict(self.params),
            "root": self.root_hash,
            "nodes": {
                h: {
                    "line": n.moves_from_root, "to_move": n.to_move,
                    "values": dataclasses.asdict(n.this_values),
                    "recursive": dataclasses.asdict(n.recursive),
                    "moves": [[m.loc, m.child_hash, m.raw_policy]
                              for m in n.moves.values()],
                    "parents": n.parents,
                    "can_expand": n.can_expand,
                    "searched": n.searched,
                } for h, n in self.nodes.items()
            },
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f)
        os.replace(tmp, path)

    @staticmethod
    def load(path: str, device=None) -> "Book":
        """The book saved at path, replaying on device (CUDA unless the
        caller names another)."""
        with open(path) as f:
            data = json.load(f)
        params = BookParams(**data["params"]) if "params" in data \
            else BookParams()
        book = Book(size=data["size"], rules=R.Rules.parse(data["rules"]),
                    params=params, device=device)
        book.nodes = {}
        book.root_hash = data["root"]
        for h, nd in data["nodes"].items():
            node = BookNode(hash=h, moves_from_root=nd["line"],
                            to_move=nd["to_move"],
                            can_expand=nd["can_expand"])
            if "values" in nd:
                node.this_values = BookValues(**nd["values"])
                node.recursive = RecursiveValues(**nd["recursive"])
                node.parents = [tuple(p) for p in nd.get("parents", [])]
                node.searched = nd.get("searched", False)
            else:  # round-1 format
                node.this_values = BookValues(
                    winloss=nd.get("winloss", 0.0),
                    score_mean=nd.get("score_mean", 0.0),
                    visits=nd.get("visits", 0))
                node.searched = nd.get("visits", 0) > 0
            node.moves = {m[0]: BookMove(m[0], m[1], m[2])
                          for m in nd["moves"]}
            book.nodes[h] = node
        book._rebuild_parents()
        return book

    def _rebuild_parents(self):
        for n in self.nodes.values():
            n.parents = []
        for n in self.nodes.values():
            for loc, m in n.moves.items():
                child = self.nodes.get(m.child_hash)
                if child is not None and (n.hash, loc) not in child.parents:
                    child.parents.append((n.hash, loc))

    # ---- game-state reconstruction ----
    def _replay(self, line: list, max_hist: int) -> H.GameState:
        gs = H.new_game(self.size, self.rules, max_hist, device=self.device)
        for mv in line:
            gs, _ = H.step(gs, torch.tensor([mv], device=self.device),
                           self.size)
        return gs

    def _game_state_for(self, node: BookNode) -> H.GameState:
        # fixed max_hist so book nodes stack into one search batch
        return self._replay(node.moves_from_root, 2 * self.size * self.size)

    def _replay_stones(self, line: list) -> np.ndarray:
        gs = self._replay(line, len(line) + 8)
        return gs.board.stones[0].cpu().numpy().astype(np.int8)

    def _batch(self, nodes: list) -> H.GameState:
        states = [self._game_state_for(n) for n in nodes]
        return T.tree_map(lambda *xs: torch.cat(xs), *states)

    def _integer_result(self) -> bool:
        """gameResultWillBeInteger: integer komi => integer score."""
        return float(self.rules.komi) == int(self.rules.komi)

    # ---- recursive minimax values (book.cpp:1726-1831) ----
    def _node_own_bounds(self, node: BookNode):
        v = node.this_values
        ef = self.params.error_factor
        wl_err = v.adjusted_winloss_error()
        sc_err = v.adjusted_score_error(self._integer_result())
        wl_lcb = v.winloss - ef * wl_err
        wl_ucb = v.winloss + ef * wl_err
        sc_lcb = v.score_mean - ef * sc_err
        sc_ucb = v.score_mean + ef * sc_err
        sf_lcb = v.score_mean - ef * v.score_stdev
        sf_ucb = v.score_mean + ef * v.score_stdev
        return (v.winloss, v.score_mean, wl_lcb, wl_ucb, sc_lcb, sc_ucb,
                sf_lcb, sf_ucb)

    def recompute_values(self):
        """Sweep minimax from the leaves up; iterate to a fixpoint to
        settle transposition diamonds (the reference walks a dirty set,
        book.cpp:960-994)."""
        order = sorted(self.nodes.values(),
                       key=lambda n: -len(n.moves_from_root))
        for _ in range(60):
            changed = False
            for node in order:
                (wl, sc, wl_lcb, wl_ucb, sc_lcb, sc_ucb, sf_lcb, sf_ucb) = \
                    self._node_own_bounds(node)
                weight = node.this_values.weight
                visits = node.this_values.visits
                white = node.to_move == B.WHITE
                agg = max if white else min
                for m in node.moves.values():
                    c = self.nodes.get(m.child_hash)
                    if c is None:
                        continue
                    r = c.recursive
                    wl = agg(wl, r.winloss)
                    sc = agg(sc, r.score_mean)
                    wl_lcb = agg(wl_lcb, r.winloss_lcb)
                    wl_ucb = agg(wl_ucb, r.winloss_ucb)
                    sc_lcb = agg(sc_lcb, r.score_lcb)
                    sc_ucb = agg(sc_ucb, r.score_ucb)
                    sf_lcb = agg(sf_lcb, r.score_final_lcb)
                    sf_ucb = agg(sf_ucb, r.score_final_ucb)
                    weight += r.weight
                    visits += r.visits
                new = RecursiveValues(
                    winloss=wl, score_mean=sc, winloss_lcb=wl_lcb,
                    winloss_ucb=wl_ucb, score_lcb=sc_lcb, score_ucb=sc_ucb,
                    score_final_lcb=sf_lcb, score_final_ucb=sf_ucb,
                    weight=weight, visits=visits)
                if new != node.recursive:
                    node.recursive = new
                    changed = True
            if not changed:
                break

    # ---- expansion costs (book.cpp:1955-2530) ----
    def _utility(self, r: RecursiveValues) -> float:
        return r.winloss + r.score_mean * self.params.utility_per_score

    def recompute_costs(self):
        # min_depth by BFS over moves from root
        for n in self.nodes.values():
            n.min_depth = 1 << 30
        root = self.nodes[self.root_hash]
        root.min_depth = 0
        frontier = [root]
        while frontier:
            nxt = []
            for n in frontier:
                for m in n.moves.values():
                    c = self.nodes.get(m.child_hash)
                    if c is not None and c.min_depth > n.min_depth + 1:
                        c.min_depth = n.min_depth + 1
                        nxt.append(c)
            frontier = nxt
        order = sorted(self.nodes.values(), key=lambda n: n.min_depth)
        # two sweeps settle cost flow through transpositions
        for _ in range(2):
            for node in order:
                self._recompute_node_cost(node)

    def _recompute_node_cost(self, node: BookNode):
        p = self.params
        # min cost from root via parents (book.cpp:1957-1995)
        if node.hash == self.root_hash:
            node.min_cost_from_root = 0.0
            node.min_cost_wlpv = 0.0
            node.biggest_wl_cost_from_root = 0.0
        else:
            min_cost = 1e100
            min_cost_wlpv = 1e100
            best_biggest = 1e100
            for ph, ploc in node.parents:
                parent = self.nodes.get(ph)
                if parent is None or ploc not in parent.moves:
                    continue
                pm = parent.moves[ploc]
                if pm.cost_from_root < min_cost:
                    min_cost = pm.cost_from_root
                    best_biggest = pm.biggest_wl_cost
                if pm.is_wlpv and parent.min_cost_wlpv < min_cost_wlpv:
                    min_cost_wlpv = parent.min_cost_wlpv
            node.min_cost_from_root = min_cost if min_cost < 1e99 else 0.0
            node.min_cost_wlpv = min_cost_wlpv
            node.biggest_wl_cost_from_root = \
                best_biggest if best_biggest < 1e99 else 0.0
        if node.min_cost_from_root < node.min_cost_wlpv:
            node.min_cost_wlpv = node.min_cost_from_root

        white = node.to_move == B.WHITE

        # winloss PV marking (book.cpp:2020-2053)
        best_wl_persp = -1e100
        best_wl_loc = None
        for loc, m in node.moves.items():
            m.is_wlpv = False
            c = self.nodes.get(m.child_hash)
            if c is None:
                continue
            wlp = c.recursive.winloss if white else -c.recursive.winloss
            if wlp > best_wl_persp:
                best_wl_persp = wlp
                best_wl_loc = loc
        node.expansion_is_wlpv = False
        this_wl_persp = (node.this_values.winloss if white
                         else -node.this_values.winloss)
        if node.searched and this_wl_persp > best_wl_persp:
            best_wl_persp = this_wl_persp
            best_wl_loc = None
        if best_wl_loc is None:
            node.expansion_is_wlpv = True
        else:
            node.moves[best_wl_loc].is_wlpv = True

        # soft policy boost vs higher-policy expanded moves
        # (book.cpp:2056-2082)
        def boost_log_policy(log_pol, utility, raw_pol):
            boosted = log_pol
            for om in node.moves.values():
                if om.raw_policy <= raw_pol:
                    continue
                oc = self.nodes.get(om.child_hash)
                if oc is None:
                    continue
                gain = (utility - self._utility(oc.recursive)) \
                    if white else (self._utility(oc.recursive) - utility)
                if gain <= 0:
                    continue
                f = 2.0 / (1.0 + math.exp(
                    -gain / p.policy_boost_soft_utility_scale)) - 1.0
                f = 0.1 + 0.9 * f
                olog = math.log(om.raw_policy + 1e-100)
                boosted = max(boosted, log_pol + f * (olog - log_pol))
            return boosted

        # pass-favored detection (book.cpp:2084-2094)
        pass_loc = self.size * self.size
        pass_policy = 0.0
        pass_utility = -1e100 if white else 1e100
        if pass_loc in node.moves:
            pass_policy = node.moves[pass_loc].raw_policy
            pc = self.nodes.get(node.moves[pass_loc].child_hash)
            if pc is not None:
                pass_utility = self._utility(pc.recursive)

        rv = node.recursive
        ef = p.error_factor

        def wl_loss_cost(child_ucb, child_lcb):
            """UCB winloss loss terms pow 1/3/7 (book.cpp:2097-2113)."""
            if white:
                l1 = rv.winloss_ucb - child_ucb
                l3 = _pow3(rv.winloss_ucb) - _pow3(child_ucb)
                l7 = _pow7(rv.winloss_ucb) - _pow7(child_ucb)
            else:
                l1 = child_lcb - rv.winloss_lcb
                l3 = _pow3(child_lcb) - _pow3(rv.winloss_lcb)
                l7 = _pow7(child_lcb) - _pow7(rv.winloss_lcb)
            return (l1 * p.cost_per_ucb_winloss_loss
                    + l3 * p.cost_per_ucb_winloss_loss_pow3
                    + l7 * p.cost_per_ucb_winloss_loss_pow7)

        def score_loss(child_ucb, child_lcb):
            l = (rv.score_ucb - child_ucb) if white \
                else (child_lcb - rv.score_lcb)
            return min(l, p.score_loss_cap)

        # per-move cost from root (book.cpp:2096-2155)
        smallest_cost_from_ucb = 1e100
        for loc, m in node.moves.items():
            c = self.nodes.get(m.child_hash)
            if c is None:
                continue
            cost_wl = wl_loss_cost(c.recursive.winloss_ucb,
                                   c.recursive.winloss_lcb)
            if cost_wl > node.biggest_wl_cost_from_root:
                cost_wl -= p.bonus_for_biggest_wl_cost * \
                    (cost_wl - node.biggest_wl_cost_from_root)
            cost_ucb = cost_wl + score_loss(
                c.recursive.score_ucb, c.recursive.score_lcb) \
                * p.cost_per_ucb_score_loss
            log_pol = math.log(m.raw_policy + 1e-100)
            child_util = self._utility(c.recursive)
            boosted = boost_log_policy(log_pol, child_util, m.raw_policy)
            pass_favored = (
                pass_policy > 0.15 and pass_policy > m.raw_policy * 0.8
                and ((white and pass_utility > child_util - 0.02)
                     or (not white and pass_utility < child_util + 0.02)))
            m.cost_from_root = (
                node.min_cost_from_root + p.cost_per_move + cost_ucb
                + (-boosted * p.cost_per_log_policy)
                + (p.cost_when_pass_favored if pass_favored else 0.0))
            m.biggest_wl_cost = max(node.biggest_wl_cost_from_root, cost_wl)
            smallest_cost_from_ucb = min(smallest_cost_from_ucb, cost_ucb)

        # this-node expansion cost (book.cpp:2157-2290)
        if not node.can_expand:
            node.expansion_cost = 1e100
        else:
            v = node.this_values
            wl_err = v.adjusted_winloss_error()
            sc_err = v.adjusted_score_error(self._integer_result())
            own_ucb = v.winloss + ef * wl_err
            own_lcb = v.winloss - ef * wl_err
            cost_wl = wl_loss_cost(own_ucb, own_lcb)
            if cost_wl > node.biggest_wl_cost_from_root:
                cost_wl -= p.bonus_for_biggest_wl_cost * \
                    (cost_wl - node.biggest_wl_cost_from_root)
            cost_ucb = cost_wl + score_loss(
                v.score_mean + ef * sc_err, v.score_mean - ef * sc_err) \
                * p.cost_per_ucb_score_loss
            raw_pol = v.max_policy
            log_pol = math.log(raw_pol + 1e-100)
            nib_util = v.winloss + v.score_mean * p.utility_per_score
            boosted = boost_log_policy(log_pol, nib_util, raw_pol)
            pass_favored = (
                pass_policy > 0.15 and pass_policy > raw_pol * 0.8
                and ((white and pass_utility > nib_util - 0.02)
                     or (not white and pass_utility < nib_util + 0.02)))
            # moves-expanded penalty with utility-gain cap
            # (book.cpp:2198-2235)
            moves_expanded = float(len(node.moves))
            cap = 0.5
            for om in node.moves.values():
                if cap >= moves_expanded:
                    break
                oc = self.nodes.get(om.child_hash)
                if oc is None:
                    continue
                gain = (nib_util - self._utility(oc.recursive)) if white \
                    else (self._utility(oc.recursive) - nib_util)
                if gain <= 0:
                    not_count = 0.0
                else:
                    not_count = 2.0 / (1.0 + math.exp(
                        -gain / p.policy_boost_soft_utility_scale)) - 1.0
                cap += 1.5 * (1.0 - not_count)
            moves_expanded = min(moves_expanded, cap,
                                 1.0 / (raw_pol + 1e-30))
            node.expansion_cost = (
                p.cost_per_move + cost_ucb
                + (-boosted * p.cost_per_log_policy)
                + moves_expanded * p.cost_per_moves_expanded
                + moves_expanded ** 2 * p.cost_per_squared_moves_expanded
                + (p.cost_when_pass_favored if pass_favored else 0.0))
            smallest_cost_from_ucb = min(smallest_cost_from_ucb, cost_ucb)

        # replenish: every option at this node shares the smallest UCB
        # cost, so refund most of it (book.cpp:2292-2308)
        if smallest_cost_from_ucb > 1e-100 and smallest_cost_from_ucb < 1e99:
            for m in node.moves.values():
                m.cost_from_root -= 0.8 * smallest_cost_from_ucb
            node.expansion_cost -= 0.8 * smallest_cost_from_ucb

        # a move much better in plain winloss than a cheaper move can't
        # cost too much more (book.cpp:2310-2343)
        def best_beaten_cost(wl_persp, own_cost):
            best = own_cost
            for om in node.moves.values():
                if om.cost_from_root < best:
                    oc = self.nodes.get(om.child_hash)
                    if oc is None:
                        continue
                    owl = oc.recursive.winloss if white \
                        else -oc.recursive.winloss
                    if wl_persp > owl + 0.03:
                        best = om.cost_from_root
            return best

        for m in node.moves.values():
            c = self.nodes.get(m.child_hash)
            if c is None:
                continue
            wlp = c.recursive.winloss if white else -c.recursive.winloss
            better = best_beaten_cost(wlp, m.cost_from_root)
            if better < m.cost_from_root:
                m.cost_from_root += 0.70 * (better - m.cost_from_root)
        if node.can_expand and node.searched:
            total = node.expansion_cost + node.min_cost_from_root
            better = best_beaten_cost(this_wl_persp, total)
            if better - node.min_cost_from_root < node.expansion_cost:
                node.expansion_cost += 0.70 * (
                    better - node.min_cost_from_root - node.expansion_cost)

        # error/discrepancy bonuses on moves, capped at 0.75 of the cost
        # above the node (book.cpp:2346-2378); WLPV bonus after
        for m in node.moves.values():
            c = self.nodes.get(m.child_hash)
            if c is None:
                continue
            r = c.recursive
            wl_err = abs(r.winloss_ucb - r.winloss_lcb) / ef / 2.0
            sc_err = abs(r.score_ucb - r.score_lcb) / ef / 2.0
            bonus = (p.bonus_per_winloss_error * wl_err
                     + p.bonus_per_score_error * sc_err)
            bonus = min(bonus,
                        (m.cost_from_root - node.min_cost_from_root) * 0.75)
            m.cost_from_root -= bonus
            if m.is_wlpv:
                scale = (m.cost_from_root - node.min_cost_from_root) * \
                    (1.0 - p.bonus_for_wl_pv_final_prop)
                if scale > 0.0:
                    f1 = max(0.0, 1.0 - r.winloss ** 2)
                    f2 = 4.0 * max(0.0, 0.25 -
                                   (0.5 - abs(r.winloss)) ** 2)
                    m.cost_from_root -= scale * math.tanh(
                        f1 * p.bonus_for_wl_pv1 + f2 * p.bonus_for_wl_pv2)

        # expansion bonuses (book.cpp:2380-2448)
        if node.can_expand and node.expansion_cost < 1e99:
            v = node.this_values
            wl_err = v.adjusted_winloss_error()
            sc_err = v.adjusted_score_error(self._integer_result())
            moves_expanded = float(len(node.moves))
            excess_pol = 0.0
            if moves_expanded > 0 and v.max_policy > 1.0 / moves_expanded:
                excess_pol = v.max_policy - 1.0 / moves_expanded
            bonus = (p.bonus_per_winloss_error * wl_err
                     + p.bonus_per_score_error * sc_err
                     + p.bonus_per_excess_unexpanded_policy * excess_pol)
            bonus = min(bonus, node.expansion_cost * 0.75)
            node.expansion_cost -= bonus
            if node.expansion_is_wlpv:
                scale = node.expansion_cost * \
                    (1.0 - p.bonus_for_wl_pv_final_prop)
                if scale > 0.0:
                    f1 = max(0.0, 1.0 - v.winloss ** 2)
                    f2 = 4.0 * max(0.0, 0.25 - (0.5 - abs(v.winloss)) ** 2)
                    node.expansion_cost -= scale * math.tanh(
                        f1 * p.bonus_for_wl_pv1 + f2 * p.bonus_for_wl_pv2)
            # unexpanded-best-winloss bonus (uncapped, book.cpp:2412-2440)
            if node.searched and node.moves:
                best_other = None
                best_other_visits = 0.0
                total_other_visits = 0.0
                for om in node.moves.values():
                    oc = self.nodes.get(om.child_hash)
                    if oc is None:
                        continue
                    owl = oc.recursive.winloss if white \
                        else -oc.recursive.winloss
                    if best_other is None or owl > best_other:
                        best_other = owl
                        best_other_visits = oc.recursive.visits
                    total_other_visits += oc.recursive.visits
                if best_other is not None and this_wl_persp > best_other:
                    vf = 0.5 * (
                        min(1.0, math.sqrt(best_other_visits /
                                           max(1.0, p.visits_scale)))
                        + min(1.0, math.sqrt(total_other_visits /
                                             max(1.0, p.visits_scale))))
                    node.expansion_cost -= \
                        p.bonus_per_unexpanded_best_winloss * \
                        (this_wl_persp - best_other + 0.02) * vf

        # early-book cost reduction (book.h:321-324)
        if p.early_book_cost_reduction_factor > 0.0:
            red = p.early_book_cost_reduction_factor * \
                (p.early_book_cost_reduction_lambda ** node.min_depth)
            node.expansion_cost -= red

    # ---- selection (book.cpp:1265-1280) ----
    def get_next_n_to_expand(self, n: int) -> list[BookNode]:
        cands = [nd for nd in self.nodes.values() if nd.can_expand]
        cands.sort(key=lambda nd: (nd.min_cost_from_root +
                                   nd.expansion_cost, nd.hash))
        return cands[:n]

    # ---- expansion ----
    def _not_in_book_mask(self, node: BookNode) -> np.ndarray:
        """Legal-root-move mask excluding moves already in the book
        (thisValuesNotInBook coverage search, book.h:125-135)."""
        a = self.size * self.size + 1
        mask = np.ones((a,), bool)
        for loc in node.moves:
            mask[loc] = False
        return mask

    def expand_nodes(self, search_fn: Callable, err_fn: Callable | None,
                     nodes: list[BookNode]) -> list[BookNode]:
        """Search `nodes` restricted to not-in-book moves (one batch),
        update their thisValuesNotInBook, and add each node's best new
        move as a child. Returns the newly created children (which the
        caller should value with `value_nodes`)."""
        if not nodes:
            return []
        batch = self._batch(nodes)
        masks = np.stack([self._not_in_book_mask(n) for n in nodes])
        res = search_fn(batch, torch.from_numpy(masks).to(self.device))
        self._update_this_values(nodes, res, err_fn, batch, masks)

        cv = res.child_visits.cpu().numpy().astype(np.float32)
        prior = res.root_policy_prior.float().cpu().numpy()
        new_children: list[BookNode] = []
        for i, node in enumerate(nodes):
            allowed = masks[i]
            vis = np.where(allowed, cv[i], -1.0)
            a = int(np.argmax(vis))
            if vis[a] <= 0:
                node.can_expand = False   # nothing left to expand
                continue
            line = node.moves_from_root + [a]
            stones = self._replay_stones(line)
            nm = B.BLACK if len(line) % 2 == 0 else B.WHITE
            ch = canonical_hash(stones, nm, self.size)
            node.moves[a] = BookMove(a, ch, float(max(prior[i, a], 0.0)))
            child = self.nodes.get(ch)
            if child is None:
                child = BookNode(hash=ch, moves_from_root=line, to_move=nm)
                self.nodes[ch] = child
                new_children.append(child)
            if (node.hash, a) not in child.parents:
                child.parents.append((node.hash, a))
        return new_children

    def value_nodes(self, search_fn: Callable, err_fn: Callable | None,
                    nodes: list[BookNode]):
        """Unrestricted search of leaf nodes to populate their values."""
        if not nodes:
            return
        batch = self._batch(nodes)
        a = self.size * self.size + 1
        masks = np.ones((len(nodes), a), bool)
        res = search_fn(batch, torch.from_numpy(masks).to(self.device))
        self._update_this_values(nodes, res, err_fn, batch, masks)

    def _update_this_values(self, nodes, res, err_fn, batch, masks):
        from katago_torch.search.mcts import C_NN_SCORE_STDEV
        wl = res.root_winloss.cpu().numpy()
        sm = res.root_score_mean.cpu().numpy()
        rv = res.root_visits.cpu().numpy()
        prior = res.root_policy_prior.float().cpu().numpy()
        stdev = res.ss.tree.stats[:, 0, C_NN_SCORE_STDEV].cpu().numpy()
        if err_fn is not None:
            wl_err, sc_err = (x.cpu().numpy() for x in err_fn(batch))
        else:
            wl_err = np.zeros(len(nodes))
            sc_err = np.zeros(len(nodes))
        for i, node in enumerate(nodes):
            allowed = masks[i]
            pr = np.where(allowed, prior[i], -1.0)
            node.this_values = BookValues(
                winloss=float(wl[i]), score_mean=float(sm[i]),
                winloss_error=float(wl_err[i]),
                score_error=float(sc_err[i]),
                score_stdev=float(stdev[i]),
                max_policy=float(max(pr.max(), 0.0)),
                weight=float(rv[i]), visits=float(rv[i]))
            node.searched = True

    # ---- HTML export (writebook) ----
    def write_html(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        for h, n in self.nodes.items():
            rows = []
            order = sorted(
                n.moves.items(),
                key=lambda kv: -self._move_sort_key(n, kv[1]))
            for loc, m in order:
                child = self.nodes.get(m.child_hash)
                wl = f"{child.recursive.winloss:+.3f}" if child else "?"
                rows.append(
                    f'<tr><td><a href="{m.child_hash}.html">'
                    f"{_loc_str(loc, self.size)}</a></td>"
                    f"<td>{m.raw_policy:.3f}</td><td>{wl}</td></tr>")
            r = n.recursive
            line = " ".join(_loc_str(m, self.size)
                            for m in n.moves_from_root) or "(root)"
            body = (
                f"<html><head><title>Book node {h[:12]}</title></head><body>"
                f"<h2>Node {h[:12]}</h2>"
                f"<p>line: {line}</p>"
                f"<p>winloss (white persp): {r.winloss:+.3f} "
                f"[{r.winloss_lcb:+.3f}, {r.winloss_ucb:+.3f}], "
                f"score: {r.score_mean:+.1f}, visits: {int(r.visits)}</p>"
                f"<table><tr><th>move</th><th>prior</th><th>child wl</th></tr>"
                + "".join(rows) + "</table></body></html>")
            with open(os.path.join(out_dir, f"{h}.html"), "w") as f:
                f.write(body)
        # index page
        with open(os.path.join(out_dir, "index.html"), "w") as f:
            f.write(f'<html><body><a href="{self.root_hash}.html">root'
                    f"</a> ({len(self.nodes)} nodes)</body></html>")

    def _move_sort_key(self, node: BookNode, m: BookMove) -> float:
        """HTML move ordering: utility + policy bonus
        (params.utilityPerPolicyForSorting, book.h:326-327)."""
        c = self.nodes.get(m.child_hash)
        if c is None:
            return -1e100
        u = self._utility(c.recursive)
        if node.to_move != B.WHITE:
            u = -u
        return u + m.raw_policy * self.params.utility_per_policy_for_sorting


def _loc_str(loc: int, size: int) -> str:
    cols = "ABCDEFGHJKLMNOPQRSTUVWXYZ"
    if loc >= size * size:
        return "pass"
    x, y = loc % size, loc // size
    return f"{cols[x]}{size - y}"


def gen_book(model, *, size: int, visits: int, rounds: int,
             nodes_per_round: int = 8, moves_per_node: int = 1,
             search_params=None, rules: R.Rules | None = None,
             book: Book | None = None, book_params: BookParams | None = None,
             device=None, log=print) -> Book:
    """genbook command core (genbook.cpp:1509-1530): iterative batched
    expansion under the BookParams cost model. model: the net (a
    KataGoModel or DescNet on `device`). moves_per_node is retained for
    API compatibility; the cost model expands one new move per node
    pick, matching the reference (re-picking a node later extends it
    again at a moves-expanded penalty). Each batch's search starts from
    a generator seeded 7, as the JAX package's jitted search starts
    from PRNGKey(7)."""
    del moves_per_node
    from katago_torch.cli.match_cmd import net_feature_version
    from katago_torch.device import resolve_device
    from katago_torch.models import features as F
    from katago_torch.search import mcts
    from katago_torch.search.params import SearchParams

    dev = resolve_device(device)
    book = book or Book(size=size, rules=rules, params=book_params,
                        device=dev)
    book.device = dev
    sp = (search_params or SearchParams()).to_arr(dev)
    fv = net_feature_version(model)

    def search_fn(roots, masks):
        gen = torch.Generator(device=dev).manual_seed(7)
        with torch.no_grad():
            return mcts.run_search(model, roots, sp, gen, size=size,
                                   num_sims=visits, max_nodes=visits + 3,
                                   with_ladders=False,
                                   root_allowed_mask=masks,
                                   feature_version=fv)

    evaluator = mcts.make_nn_evaluator(model, size, with_ladders=False,
                                       feature_version=fv)
    fp = F.FeatureParams.default(dev)

    def err_fn(batch):
        """Root shortterm error heads (BookValues winLossError /
        scoreError, book.h:73-76)."""
        raw, _, _ = evaluator(batch, fp)
        mmv = raw.get("moremiscvalue")
        if mmv is None:
            z = torch.zeros((batch.hist_len.shape[0],), device=dev)
            return z, z
        mmv = mmv.float()
        return (torch.nn.functional.softplus(mmv[:, 0]) * 0.25,
                torch.nn.functional.softplus(mmv[:, 1]) * 30.0)

    root = book.nodes[book.root_hash]
    if not root.searched:
        book.value_nodes(search_fn, err_fn, [root])
    for rnd in range(rounds):
        book.recompute_values()
        book.recompute_costs()
        nodes = book.get_next_n_to_expand(nodes_per_round)
        if not nodes:
            break
        new_children = book.expand_nodes(search_fn, err_fn, nodes)
        book.value_nodes(search_fn, err_fn, new_children)
        log(f"  book round {rnd}: expanded {len(nodes)} nodes, "
            f"+{len(new_children)} new, total {len(book.nodes)}")
    book.recompute_values()
    book.recompute_costs()
    return book
