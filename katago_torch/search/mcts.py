"""Array-MCTS over a per-game node pool — port of the fresh-root path of
katago_tpu/search/mcts.py, batched over games.

G games run one playout each in lockstep, so every NN evaluation is a
[G]-batch. One playout = select (PUCT descent following each node's
cached best action) -> expand (board step, legality, chase ladders,
featurize, net) -> insert the leaf and recompute statistics bottom-up
along the path. Formulas follow the reference's
searchexplorehelpers.cpp / searchupdatehelpers.cpp exactly as the JAX
package does; utilities are white-perspective.

Pool storage keeps the JAX package's narrow types: child indices int16
(int32 for pools of 2^15 nodes or more), priors float16 — the search
matches the JAX package only with the same rounding of stored priors.

Tensors are updated in place where the JAX package rebuilt its arrays.
The Python loops that replace lax.while_loop synchronise with the device
once per turn: the descent (every second level), the superko retry loop,
the terminal-leaf check, the visit-cap check and the Benson fixpoints in
the featurizer.

Tree reuse (Search::makeMove): `extract_subtree` re-roots each game's
pool at the child of its played move, and `init_search` /
`run_search` take the previous trees and actions.

Root extras for the GTP and analysis engines: `root_allowed_mask`
(avoid/allow moves), `root_num_symmetries` (the root eval averaged over
sampled dihedral symmetries), `track_moves_ownership` (per-root-move
ownership), `extract_pv`, `child_analysis_extras`, and the anti-mirror
hooks of search/mirror.py (`mirror=`; with None the search runs none of
their code).

Nets: any input-feature version 3..7 (`feature_version`, the net's
ModelDesc.input_version), and humanSL nets conditioned on an SGF
metadata profile (`sgf_meta`: each game's row follows its mover). The
pattern bonus (avoidRepeatedPatternUtility, search/patternbonus.py):
`run_playouts(pattern_bonus=)` looks each fresh node's move up in a
host-built table and folds the bonus into the node's utility; with None
the search runs none of its code.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from katago_torch import _tensortree as T
from katago_torch.game import benson
from katago_torch.game import board as B
from katago_torch.game import graphhash as GH
from katago_torch.game import history as H
from katago_torch.game import ladder as LAD
from katago_torch.game import rules as R
from katago_torch.models import features as F
from katago_torch.ops import symmetry as SYM
from katago_torch.search import localpattern as LPAT

TOTALCHILDWEIGHT_PUCT_OFFSET = 0.01
ILLEGAL = -1e30
POL_DT = torch.float16

C_WEIGHT_SUM = 0
C_UTILITY_SUM = 1
C_UTILITY_SQ_SUM = 2
C_WINLOSS_SUM = 3
C_SCORE_MEAN_SUM = 4
C_SCORE_MEANSQ_SUM = 5
C_LEAD_SUM = 6
C_WEIGHT_SQ_SUM = 7
C_NN_UTILITY = 8
C_NN_WINLOSS = 9
C_NN_SCORE_MEAN = 10
C_NN_SCORE_MEANSQ = 11
C_NN_SCORE_STDEV = 12
C_NN_LEAD = 13
C_NN_WEIGHT = 14
C_LAST_BIAS_DELTA = 15
C_LAST_BIAS_WEIGHT = 16
C_PATTERN_BONUS = 17
NUM_STATS = 18

BIAS_TABLE_SIZE = 2048


def child_dt(max_nodes: int):
    return torch.int16 if max_nodes < 2 ** 15 else torch.int32


@dataclasses.dataclass
class Tree:
    """Per-game node pools; every field is [G, N, ...]."""
    pos: H.PosState
    ko_hash: torch.Tensor        # int64[G, N, 2]
    graph_hash: torch.Tensor     # int64[G, N, 2]
    parent: torch.Tensor         # int64[G, N]
    parent_action: torch.Tensor  # int64[G, N]
    depth: torch.Tensor          # int64[G, N]
    children: torch.Tensor       # int16/int32[G, N, A], -1 = none
    policy: torch.Tensor         # float16[G, N, A], -1 = illegal
    visits: torch.Tensor         # int64[G, N]
    stats: torch.Tensor          # float32[G, N, NUM_STATS]
    bias_key: torch.Tensor       # int64[G, N]
    laddered: torch.Tensor       # bool[G, N, NN]
    term_own: torch.Tensor       # int8[G, N, NN]
    best_action: torch.Tensor    # int64[G, N]
    num_nodes: torch.Tensor      # int64[G]


@dataclasses.dataclass
class SearchState:
    tree: Tree
    rules: H.RulesArr
    root_hist: torch.Tensor          # int64[G, MAX_HIST, 2]
    root_hist_len: torch.Tensor      # int64[G]
    dyn_score_center: torch.Tensor   # float32[G]
    sqrt_board_area: torch.Tensor    # float32[G]
    bias_sum: torch.Tensor           # float32[G, BIAS_TABLE_SIZE]
    bias_weight: torch.Tensor
    own_sum: torch.Tensor            # float32[G, NN]
    own_sq_sum: torch.Tensor
    own_weight: torch.Tensor         # float32[G]
    ending_bonus: torch.Tensor       # float32[G, A]
    root_prev_laddered: torch.Tensor  # bool[G, NN]
    # per-root-move ownership sums (includeMovesOwnership): [G, A, NN],
    # [G, A, NN], [G, A] with track_moves_ownership, else [G, 1, 1] dummies
    mo_sum: torch.Tensor
    mo_sq_sum: torch.Tensor
    mo_weight: torch.Tensor


@dataclasses.dataclass
class LeafEval:
    utility: torch.Tensor
    winloss: torch.Tensor
    score_mean: torch.Tensor
    score_meansq: torch.Tensor
    score_stdev: torch.Tensor
    lead: torch.Tensor
    policy: torch.Tensor     # float32[G, A] (-1 illegal)
    weight: torch.Tensor
    ownership: torch.Tensor  # float32[G, NN] white perspective


@dataclasses.dataclass
class PathSel:
    path_nodes: torch.Tensor     # int64[G, D] (-1 pad)
    path_len: torch.Tensor       # int64[G]
    leaf_parent: torch.Tensor
    leaf_action: torch.Tensor    # -1 if terminal
    is_terminal: torch.Tensor    # bool[G]
    terminal_node: torch.Tensor
    root_action: torch.Tensor


@dataclasses.dataclass
class SearchResult:
    ss: SearchState
    root_visits: torch.Tensor
    child_visits: torch.Tensor
    root_policy_prior: torch.Tensor
    root_winloss: torch.Tensor
    root_score_mean: torch.Tensor
    root_lead: torch.Tensor
    root_utility: torch.Tensor
    child_winloss: torch.Tensor
    child_score_mean: torch.Tensor
    root_ownership: torch.Tensor
    root_ownership_stdev: torch.Tensor
    moves_ownership: torch.Tensor         # [G, A, NN] ([G, 1, 1] unless
    moves_ownership_stdev: torch.Tensor   # track_moves_ownership)
    moves_own_weight: torch.Tensor        # [G, A]
    root_score_stdev: torch.Tensor


def _rows(x, idx):
    """x [G, N, ...] at node idx [G] -> [G, ...]."""
    return x[torch.arange(x.shape[0], device=x.device), idx]


def _set_rows(x, idx, val, cond):
    """In place: x[g, idx[g]] = val[g] where cond[g]."""
    gi = torch.arange(x.shape[0], device=x.device)
    old = x[gi, idx]
    c = cond.reshape(cond.shape + (1,) * (old.dim() - 1))
    x[gi, idx] = torch.where(c, val.to(x.dtype), old)


def empty_tree(size: int, max_nodes: int, g: int, device) -> Tree:
    nn = size * size
    a = nn + 1
    n = max_nodes
    pos = T.tree_map(lambda t: t.reshape((g, n) + t.shape[1:]),
                     H.new_pos(size, g * n, device))

    def full(shape, v, dt):
        return torch.full(shape, v, dtype=dt, device=device)

    i64 = torch.int64
    return Tree(
        pos=pos,
        ko_hash=full((g, n, 2), 0, i64),
        graph_hash=full((g, n, 2), 0, i64),
        parent=full((g, n), -1, i64),
        parent_action=full((g, n), -1, i64),
        depth=full((g, n), 0, i64),
        children=full((g, n, a), -1, child_dt(n)),
        policy=full((g, n, a), -1.0, POL_DT),
        visits=full((g, n), 0, i64),
        stats=full((g, n, NUM_STATS), 0.0, torch.float32),
        bias_key=full((g, n), -1, i64),
        laddered=full((g, n, nn), False, torch.bool),
        term_own=full((g, n, nn), 0, torch.int8),
        best_action=full((g, n), 0, i64),
        num_nodes=full((g,), 0, i64))


def score_value(score_white, center, scale, sqrt_area):
    """ScoreValue::whiteScoreValueOfScoreSmoothNoDrawAdjust."""
    return torch.atan((score_white - center) / (scale * sqrt_area)) * \
        (2.0 / math.pi)


_GH_X, _GH_W = np.polynomial.hermite.hermgauss(5)
_GH_W = _GH_W / np.sqrt(np.pi)


def expected_score_value(mean, meansq, center, scale, sqrt_area):
    """E[SV(s)] for s ~ Normal(mean, meansq - mean^2), 5-point
    Gauss-Hermite quadrature."""
    var = torch.clamp(meansq - mean * mean, min=0.0)
    sigma = torch.sqrt(var)
    total = 0.0
    for x, w in zip(_GH_X, _GH_W):
        s = mean + float(np.float32(np.sqrt(2.0) * float(x))) * sigma
        total = total + float(w) * score_value(s, center, scale, sqrt_area)
    return total


def utility_of(winloss_white, score_mean_white, score_meansq_white, sp,
               dyn_center, sqrt_area):
    zero = torch.zeros((), device=winloss_white.device)
    static_sv = expected_score_value(score_mean_white, score_meansq_white,
                                     zero, zero + 1.0, sqrt_area)
    dyn_sv = expected_score_value(score_mean_white, score_meansq_white,
                                  dyn_center, sp.dynamic_score_center_scale,
                                  sqrt_area)
    return (sp.win_loss_utility_factor * winloss_white
            + sp.static_score_utility_factor * static_sv
            + sp.dynamic_score_utility_factor * dyn_sv)


def score_utility_derivative(score_mean, sp, dyn_center, sqrt_area):
    def dsv(center, scale):
        k = scale * sqrt_area
        d = score_mean - center
        return (2.0 / math.pi) * k / (k * k + d * d)

    one = torch.ones((), device=score_mean.device)
    return (sp.static_score_utility_factor * dsv(0.0, one)
            + sp.dynamic_score_utility_factor
            * dsv(dyn_center, sp.dynamic_score_center_scale))


def uncertainty_weight(st_wl_err, st_score_err, score_mean, sp, dyn_center,
                       sqrt_area):
    uncertainty = (sp.win_loss_utility_factor * st_wl_err
                   + score_utility_derivative(score_mean, sp, dyn_center,
                                              sqrt_area) * st_score_err)
    powered = torch.pow(torch.clamp(uncertainty, min=1e-10),
                        sp.uncertainty_exponent)
    baseline = sp.uncertainty_coeff / sp.uncertainty_max_weight
    w = sp.uncertainty_coeff / (powered + baseline)
    return torch.where(sp.use_uncertainty, w, torch.ones_like(w))


def _white_persp(x_mover, to_move):
    return torch.where(to_move == B.WHITE, x_mover, -x_mover)


def _puct_terms(nstats, pol, has_child, cw, cu, pla, is_root, ending_bonus,
                dyn_center, sqrt_area, sp):
    """PUCT selection terms per game: nstats [G, S]; pol (float16), cw, cu
    [G, A]. Returns (explore [G, A], value [G, A])."""
    total_cw = cw.sum(-1)
    visited_mass = torch.where(has_child & (pol >= 0), pol,
                               torch.zeros((), dtype=pol.dtype,
                                           device=pol.device)).sum(-1)
    w = torch.clamp(nstats[:, C_WEIGHT_SUM], min=1e-10)
    parent_utility = nstats[:, C_UTILITY_SUM] / w
    utility_sq_avg = nstats[:, C_UTILITY_SQ_SUM] / w
    var_prior = sp.cpuct_utility_stdev_prior ** 2
    var_prior_w = sp.cpuct_utility_stdev_prior_weight
    u_sq = parent_utility * parent_utility
    usq = torch.maximum(utility_sq_avg, u_sq)
    stdev = torch.sqrt(torch.clamp(
        ((u_sq + var_prior) * var_prior_w + usq * w)
        / (var_prior_w + torch.clamp(w - 1.0, min=1e-10)) - u_sq, min=0.0))
    stdev = torch.where(w <= 1.0, sp.cpuct_utility_stdev_prior, stdev)
    stdev_factor = 1.0 + sp.cpuct_utility_stdev_scale * (
        stdev / sp.cpuct_utility_stdev_prior - 1.0)

    fpu_red = torch.where(is_root, sp.root_fpu_reduction_max,
                          sp.fpu_reduction_max)
    fpu_loss = torch.where(is_root, sp.root_fpu_loss_prop, sp.fpu_loss_prop)
    parent_u_fpu = (sp.fpu_parent_weight * nstats[:, C_NN_UTILITY]
                    + (1.0 - sp.fpu_parent_weight) * parent_utility)
    utility_radius = (sp.win_loss_utility_factor
                      + sp.static_score_utility_factor
                      + sp.dynamic_score_utility_factor)
    is_white = pla == B.WHITE
    reduction = fpu_red * torch.sqrt(visited_mass).float()  # sqrt in f16
    fpu = torch.where(is_white, parent_u_fpu - reduction,
                      parent_u_fpu + reduction)
    loss_value = torch.where(is_white, -utility_radius, utility_radius)
    fpu = fpu + (loss_value - fpu) * fpu_loss

    cpuct = sp.cpuct_exploration + sp.cpuct_exploration_log * torch.log(
        (total_cw + sp.cpuct_exploration_base) / sp.cpuct_exploration_base)
    explore_scaling = cpuct * torch.sqrt(
        total_cw + TOTALCHILDWEIGHT_PUCT_OFFSET) * stdev_factor

    child_util = torch.where(has_child, cu, fpu.unsqueeze(-1))
    parent_score = nstats[:, C_SCORE_MEAN_SUM] / w
    deriv = score_utility_derivative(parent_score, sp, dyn_center, sqrt_area)
    child_util = child_util + torch.where(
        is_root.unsqueeze(-1), ending_bonus * deriv.unsqueeze(-1), 0.0)
    value_comp = torch.where(is_white.unsqueeze(-1), child_util, -child_util)
    explore_comp = explore_scaling.unsqueeze(-1) * pol / (1.0 + cw)
    return explore_comp, value_comp


def _argmax_score(explore, value, pol):
    score = torch.where(pol >= 0, explore + value, ILLEGAL)
    return torch.argmax(score, dim=-1)


def _child_stats(tree: Tree, children):
    """Child rows [G, A, S] of the pool (index 0 where no child)."""
    g = children.shape[0]
    gi = torch.arange(g, device=children.device).unsqueeze(-1)
    return tree.stats[gi, children.long().clamp(min=0)]


def node_best_action(tree: Tree, node, sp, ending_bonus, dyn_center,
                     sqrt_area, mirror=None, size: int | None = None):
    """PUCT-argmax action of node[G] from its current stats. mirror: an
    anti-mirror verdict whose forced exploration is added to the value
    terms (the JAX select_path's descent-time PUCT)."""
    children = _rows(tree.children, node)
    pol = _rows(tree.policy, node)
    has_child = children >= 0
    cstats = _child_stats(tree, children)
    nstats = _rows(tree.stats, node)
    cw = torch.where(has_child, cstats[..., C_WEIGHT_SUM], 0.0)
    cu = torch.where(has_child, cstats[..., C_UTILITY_SUM]
                     / torch.clamp(cw, min=1e-10), 0.0)
    pla = _rows(tree.pos.to_move, node)
    explore, value = _puct_terms(
        nstats, pol, has_child, cw, cu, pla, node == 0, ending_bonus,
        dyn_center, sqrt_area, sp)
    if mirror is not None:
        from katago_torch.search import mirror as MIR
        pu = nstats[:, C_UTILITY_SUM] / torch.clamp(nstats[:, C_WEIGHT_SUM],
                                                    min=1e-10)
        value = MIR.puct_adjust(
            value, pol, _rows(tree.pos.recent_moves, node)[:, 0], pla, cw,
            cw.sum(-1), torch.where(pla == B.WHITE, pu, -pu),
            _rows(tree.pos.board.stones, node), node == 0, mirror.mirroring,
            mirror.mirror_pla, mirror.advantage, mirror.center_err,
            tree.pos.to_move[:, 0], size)
    return _argmax_score(explore, value, pol)


def leaf_best_action(leaf_row, pol, pla, sp, dyn_center, sqrt_area):
    """best_action of a fresh childless leaf (every action at FPU)."""
    zeros = torch.zeros(pol.shape, dtype=torch.float32, device=pol.device)
    explore, value = _puct_terms(
        leaf_row, pol, torch.zeros_like(zeros, dtype=torch.bool), zeros,
        zeros, pla, torch.zeros_like(pla, dtype=torch.bool), zeros,
        dyn_center, sqrt_area, sp)
    return _argmax_score(explore, value, pol)


def select_path(ss: SearchState, max_depth: int, sp=None, mirror=None,
                size: int | None = None):
    """PUCT descent from every root along cached best actions. Returns
    (PathSel, levels) where levels is the number of descent levels run
    (a host int, the bound of the backup loop). Syncs once per two
    levels to stop when every game's descent has ended.

    mirror: an anti-mirror verdict (search/mirror.py MirrorArrs); its
    forced exploration depends on the descent's context, so the full
    PUCT is evaluated at every level instead of the cached best action
    (sp and size are then required)."""
    tree = ss.tree
    dev = tree.visits.device
    g = tree.visits.shape[0]
    gi = torch.arange(g, device=dev)
    assert max_depth % 2 == 0, "max_depth must be even (2 levels per check)"
    cur = torch.zeros((g,), dtype=torch.int64, device=dev)
    done = torch.zeros((g,), dtype=torch.bool, device=dev)
    path_nodes = torch.full((g, max_depth), -1, dtype=torch.int64, device=dev)
    path_len = torch.zeros_like(cur)
    leaf_parent = torch.zeros_like(cur)
    leaf_action = torch.full_like(cur, -1)
    is_terminal = torch.zeros_like(done)
    terminal_node = torch.zeros_like(cur)
    root_action = torch.full_like(cur, -1)
    levels = 0
    for i in range(max_depth):
        hit_terminal = ~done & tree.pos.game_over[gi, cur]
        if mirror is None:
            a = tree.best_action[gi, cur]
        else:
            a = node_best_action(tree, cur, sp, ss.ending_bonus,
                                 ss.dyn_score_center, ss.sqrt_board_area,
                                 mirror, size)
        child = tree.children[gi, cur, a].long()
        expanding = ~done & ~hit_terminal & (child < 0)
        descending = ~done & ~hit_terminal & (child >= 0)
        path_nodes[:, i] = torch.where(done, -1, cur)
        path_len = torch.where(done, path_len, i + 1)
        leaf_parent = torch.where(expanding, cur, leaf_parent)
        leaf_action = torch.where(expanding, a, leaf_action)
        is_terminal = is_terminal | hit_terminal
        terminal_node = torch.where(hit_terminal, cur, terminal_node)
        if i == 0:
            root_action = torch.where(expanding | descending, a, root_action)
        done = done | hit_terminal | expanding
        cur = torch.where(descending, child.clamp(min=0), cur)
        levels = i + 1
        if i % 2 == 1 and bool(done.all()):
            break
    is_terminal = is_terminal | ~done
    terminal_node = torch.where(~done, cur, terminal_node)
    return PathSel(path_nodes, path_len, leaf_parent, leaf_action,
                   is_terminal, terminal_node, root_action), levels


def make_leaf_gamestate(ss: SearchState, sel: PathSel, size: int):
    """Step the expansion move and assemble each leaf's GameState whose
    history = root history + search-path hashes + leaf hash."""
    tree = ss.tree
    nn = size * size
    dev = tree.visits.device
    g = tree.visits.shape[0]
    gi = torch.arange(g, device=dev)
    parent_pos = T.tree_map(lambda a: a[gi, sel.leaf_parent], tree.pos)
    action = torch.where(sel.is_terminal, nn, sel.leaf_action.clamp(min=0))
    leaf_pos, _, leaf_ko_hash = H.step_pos(parent_pos, ss.rules, action, size)

    max_hist = ss.root_hist.shape[1]
    path_valid = sel.path_nodes > 0                       # root excluded
    path_hashes = tree.ko_hash[gi.unsqueeze(-1),
                               sel.path_nodes.clamp(min=0)]  # [G, D, 2]
    order = torch.cumsum(path_valid.long(), dim=1) - 1
    write_at = torch.where(
        path_valid, (ss.root_hist_len.unsqueeze(-1) + order).clamp(
            max=max_hist - 1), max_hist)                  # invalid -> pad
    hist = torch.cat([ss.root_hist, torch.zeros(
        (g, 1, 2), dtype=torch.int64, device=dev)], dim=1)
    hist[gi.unsqueeze(-1), write_at] = path_hashes
    hist = hist[:, :max_hist]
    hist_len = (ss.root_hist_len + path_valid.sum(-1)).clamp(max=max_hist)
    hist[gi, hist_len.clamp(max=max_hist - 1)] = leaf_ko_hash
    hist_len = (hist_len + 1).clamp(max=max_hist)

    p = H.MAX_PASS_HASHES
    zeros = torch.zeros((g,), dtype=torch.int64, device=dev)
    leaf_gs = H.GameState(
        pos=leaf_pos, rules=ss.rules, ko_hash_hist=hist, hist_len=hist_len,
        pass_hash_black=torch.zeros((g, p, 2), dtype=torch.int64, device=dev),
        pass_hash_black_n=zeros,
        pass_hash_white=torch.zeros((g, p, 2), dtype=torch.int64, device=dev),
        pass_hash_white_n=zeros)
    return leaf_pos, leaf_ko_hash, leaf_gs


@functools.lru_cache(maxsize=None)
def _bias_tables(size: int, device: str):
    rng = np.random.Generator(np.random.PCG64(0x62696173 + size))
    mt = rng.integers(0, 2**32, size=(2, size * size + 2, 2), dtype=np.uint32)
    rng = np.random.Generator(np.random.PCG64(0x6B6F62 + size))
    kt = rng.integers(0, 2**32, size=(size * size + 1, 2), dtype=np.uint32)
    kt[0] = 0
    conv = lambda a: torch.from_numpy(a.astype(np.int64)).to(device)  # noqa
    return conv(mt), conv(kt)


def _bias_key(parent_stones, prev_move, move_loc, pla, ko_loc, size: int):
    """Subtree-value-bias table slot per game (SubtreeValueBiasTable::get:
    5x5 local pattern XOR move-loc keys XOR the parent's ko-ban key,
    folded onto BIAS_TABLE_SIZE slots); -1 for pass / no move."""
    nn = size * size
    mt, kt = _bias_tables(size, str(parent_stones.device))
    h = LPAT.local_pattern_hash(parent_stones, move_loc, pla, size, 5)
    h = h ^ mt[0, prev_move.clamp(-1, nn) + 1]
    h = h ^ mt[1, move_loc.clamp(-1, nn) + 1]
    h = h ^ kt[ko_loc.clamp(-1, nn - 1) + 1]
    valid = (move_loc >= 0) & (move_loc < nn)
    slot = (h[:, 0] ^ h[:, 1]) % BIAS_TABLE_SIZE
    return torch.where(valid, slot, -1)


def _leaf_eval_filled(g, a, nn, device, weight=1.0):
    z = torch.zeros((g,), dtype=torch.float32, device=device)
    return LeafEval(utility=z, winloss=z, score_mean=z, score_meansq=z,
                    score_stdev=z, lead=z,
                    policy=torch.full((g, a), -1.0, device=device),
                    weight=torch.full((g,), weight, device=device),
                    ownership=torch.zeros((g, nn), device=device))


def terminal_eval_of_pos(pos: H.PosState, rules: H.RulesArr, sp, size: int,
                         dyn_center, sqrt_area, num_actions: int) -> LeafEval:
    """Exact final-score values of finished positions."""
    own, wmb = H.final_score_pos(pos, rules, size)
    winloss = torch.sign(wmb)
    meansq = wmb * wmb
    util = utility_of(winloss, wmb, meansq, sp, dyn_center, sqrt_area)
    g = wmb.shape[0]
    return LeafEval(utility=util, winloss=winloss, score_mean=wmb,
                    score_meansq=meansq, score_stdev=torch.zeros_like(wmb),
                    lead=wmb,
                    policy=torch.full((g, num_actions), -1.0,
                                      device=wmb.device),
                    weight=torch.ones_like(wmb),
                    ownership=-own.float())


def terminal_eval(ss: SearchState, node, sp, size: int) -> LeafEval:
    """Values backed up when a playout ends at an existing node: a finished
    game's cached exact values, or a depth-capped live node's averages."""
    tree = ss.tree
    nstats = _rows(tree.stats, node)
    w = torch.clamp(nstats[:, C_WEIGHT_SUM], min=1e-10)
    is_over = _rows(tree.pos.game_over, node)
    winloss = torch.where(is_over, nstats[:, C_NN_WINLOSS],
                          nstats[:, C_WINLOSS_SUM] / w)
    score = torch.where(is_over, nstats[:, C_NN_SCORE_MEAN],
                        nstats[:, C_SCORE_MEAN_SUM] / w)
    meansq = torch.where(is_over, nstats[:, C_NN_SCORE_MEANSQ],
                         nstats[:, C_SCORE_MEANSQ_SUM] / w)
    lead = torch.where(is_over, nstats[:, C_NN_LEAD], nstats[:, C_LEAD_SUM] / w)
    term_util = utility_of(winloss, score, meansq, sp, ss.dyn_score_center,
                           ss.sqrt_board_area)
    util = torch.where(is_over, term_util, nstats[:, C_UTILITY_SUM] / w)
    own_avg = ss.own_sum / torch.clamp(ss.own_weight, min=1e-10).unsqueeze(-1)
    ownership = torch.where(is_over.unsqueeze(-1),
                            _rows(tree.term_own, node).float(), own_avg)
    g, a = tree.policy.shape[0], tree.policy.shape[2]
    return LeafEval(utility=util, winloss=winloss, score_mean=score,
                    score_meansq=meansq, score_stdev=torch.zeros_like(util),
                    lead=lead,
                    policy=torch.full((g, a), -1.0, device=util.device),
                    weight=torch.ones_like(util), ownership=ownership)


def leaf_stats_row(ev: LeafEval, pattern_bonus) -> torch.Tensor:
    """float32[G, NUM_STATS] stats row of freshly evaluated leaves."""
    w0 = ev.weight
    z = torch.zeros_like(w0)
    return torch.stack([
        w0, w0 * ev.utility, w0 * ev.utility * ev.utility, w0 * ev.winloss,
        w0 * ev.score_mean, w0 * ev.score_meansq, w0 * ev.lead, w0 * w0,
        ev.utility, ev.winloss, ev.score_mean, ev.score_meansq,
        ev.score_stdev, ev.lead, w0, z, z, z + pattern_bonus], dim=-1)


def _norm_cdf(z):
    return 0.5 * (1.0 + torch.erf(z / math.sqrt(2.0)))


def _recompute_core(children, cstats, nstats, pol, pla, bias_key, is_root,
                    sp, active, bias_sum, bias_weight, ending_bonus,
                    dyn_center, sqrt_area):
    """Search::recomputeNodeStats per game from child rows: returns the
    node's new stats row, its refreshed best action and the (in-place
    updated) bias tables."""
    gi = torch.arange(children.shape[0], device=children.device)
    exists = children >= 0
    w = torch.where(exists, cstats[..., C_WEIGHT_SUM], 0.0)
    good = exists & (w > 0)
    winv = 1.0 / torch.clamp(w, min=1e-10)
    u_avg = cstats[..., C_UTILITY_SUM] * winv
    self_u = torch.where((pla == B.WHITE).unsqueeze(-1), u_avg, -u_avg)
    total_w = torch.where(good, w, 0.0).sum(-1)
    stdevs = torch.sqrt(1e-8 + 1.0 / (1.5 * torch.sqrt(
        torch.clamp(w, min=1e-10))))
    simple_value = torch.where(good, self_u * w, 0.0).sum(-1) / \
        torch.clamp(total_w, min=1e-10)
    z = (self_u - simple_value.unsqueeze(-1)) / stdevs
    pfac = _norm_cdf(z) + 1e-4
    w_adj = torch.where(good, w * torch.pow(pfac, sp.value_weight_exponent),
                        0.0)
    renorm = total_w / torch.clamp(w_adj.sum(-1), min=1e-10)
    w_adj = torch.where(sp.value_weight_exponent > 0,
                        w_adj * renorm.unsqueeze(-1),
                        torch.where(good, w, 0.0))

    def wsum(col):
        avg = cstats[..., col] * winv
        return torch.where(good, w_adj * avg, 0.0).sum(-1)

    scaling = torch.where(good, w_adj * winv, 0.0)
    child_wsq = (scaling * scaling * cstats[..., C_WEIGHT_SQ_SUM]).sum(-1)

    sw = nstats[:, C_NN_WEIGHT]
    nn_util = nstats[:, C_NN_UTILITY]
    new_last_delta = nstats[:, C_LAST_BIAS_DELTA]
    new_last_weight = nstats[:, C_LAST_BIAS_WEIGHT]
    use_bias = (sp.subtree_value_bias_factor != 0.0) & (bias_key >= 0) & \
        active
    key = bias_key.clamp(min=0)
    children_util = wsum(C_UTILITY_SUM) / torch.clamp(total_w, min=1e-10)
    bias_w_new = torch.pow(torch.clamp(total_w, min=0.0),
                           sp.subtree_value_bias_weight_exponent)
    has_children = total_w > 1e-10
    delta_new = torch.where(has_children,
                            (children_util - nn_util) * bias_w_new, 0.0)
    bias_w_new = torch.where(has_children, bias_w_new, 0.0)
    d_delta = torch.where(use_bias,
                          delta_new - nstats[:, C_LAST_BIAS_DELTA], 0.0)
    d_w = torch.where(use_bias, bias_w_new - nstats[:, C_LAST_BIAS_WEIGHT],
                      0.0)
    bias_sum[gi, key] = bias_sum[gi, key] + d_delta
    bias_weight[gi, key] = bias_weight[gi, key] + d_w
    new_last_delta = torch.where(use_bias, delta_new, new_last_delta)
    new_last_weight = torch.where(use_bias, bias_w_new, new_last_weight)
    entry_w = bias_weight[gi, key]
    entry_avg = torch.where(entry_w > 0.001,
                            bias_sum[gi, key] / torch.clamp(entry_w,
                                                            min=1e-10), 0.0)
    nn_util = torch.where(use_bias, nn_util + sp.subtree_value_bias_factor
                          * entry_avg, nn_util)
    pat = nstats[:, C_PATTERN_BONUS]
    new_row = torch.stack([
        total_w + sw,
        wsum(C_UTILITY_SUM) + sw * nn_util + pat * (total_w + sw),
        wsum(C_UTILITY_SQ_SUM) + sw * nn_util * nn_util,
        wsum(C_WINLOSS_SUM) + sw * nstats[:, C_NN_WINLOSS],
        wsum(C_SCORE_MEAN_SUM) + sw * nstats[:, C_NN_SCORE_MEAN],
        wsum(C_SCORE_MEANSQ_SUM) + sw * nstats[:, C_NN_SCORE_MEANSQ],
        wsum(C_LEAD_SUM) + sw * nstats[:, C_NN_LEAD],
        child_wsq + sw * sw,
        nstats[:, C_NN_UTILITY], nstats[:, C_NN_WINLOSS],
        nstats[:, C_NN_SCORE_MEAN], nstats[:, C_NN_SCORE_MEANSQ],
        nstats[:, C_NN_SCORE_STDEV], nstats[:, C_NN_LEAD],
        nstats[:, C_NN_WEIGHT], new_last_delta, new_last_weight,
        nstats[:, C_PATTERN_BONUS]], dim=-1)
    explore, value = _puct_terms(
        torch.where(active.unsqueeze(-1), new_row, nstats), pol, exists, w,
        torch.where(exists, u_avg, 0.0), pla, is_root, ending_bonus,
        dyn_center, sqrt_area, sp)
    return new_row, _argmax_score(explore, value, pol)


def backprop_path(ss: SearchState, sel: PathSel, levels: int, sp,
                  do_update) -> None:
    """Recompute stats for every path node, deepest first (in place).

    A path node's only on-path child is its successor, so each level
    gathers child rows from the pre-backup pool and patches the one row
    the previous level just recomputed; rows scatter into the pool at the
    end."""
    tree = ss.tree
    dev = tree.visits.device
    g, n = tree.visits.shape
    d = sel.path_nodes.shape[1]
    gi = torch.arange(g, device=dev)
    new_rows = torch.zeros((g, d, NUM_STATS), dtype=torch.float32,
                           device=dev)
    bas = torch.zeros((g, d), dtype=torch.int64, device=dev)
    prev_node = torch.full((g,), -1, dtype=torch.int64, device=dev)
    prev_row = torch.zeros((g, NUM_STATS), dtype=torch.float32, device=dev)
    for k in range(levels):
        i = sel.path_len - 1 - k
        ic = i.clamp(min=0)
        node_raw = sel.path_nodes[gi, ic]
        node = node_raw.clamp(min=0)
        active = do_update & (node_raw >= 0) & (i >= 0)
        children = tree.children[gi, node]
        cstats = _child_stats(tree, children)
        patch = (children.long() == prev_node.unsqueeze(-1)) & \
            (prev_node >= 0).unsqueeze(-1)
        cstats = torch.where(patch.unsqueeze(-1), prev_row.unsqueeze(1),
                             cstats)
        new_row, ba = _recompute_core(
            children, cstats, tree.stats[gi, node], tree.policy[gi, node],
            tree.pos.to_move[gi, node], tree.bias_key[gi, node], node == 0,
            sp, active, ss.bias_sum, ss.bias_weight, ss.ending_bonus,
            ss.dyn_score_center, ss.sqrt_board_area)
        a1 = active.unsqueeze(-1)
        new_rows[gi, ic] = torch.where(a1, new_row, new_rows[gi, ic])
        bas[gi, ic] = torch.where(active, ba, bas[gi, ic])
        prev_node = torch.where(active, node, -1)
        prev_row = torch.where(a1, new_row, prev_row)
    written = (sel.path_nodes >= 0) & \
        (torch.arange(d, device=dev) < sel.path_len.unsqueeze(-1)) & \
        do_update.unsqueeze(-1)
    target = torch.where(written, sel.path_nodes, n)
    stats = torch.cat([tree.stats, torch.zeros((g, 1, NUM_STATS),
                                               device=dev)], dim=1)
    stats[gi.unsqueeze(-1), target] = new_rows
    tree.stats = stats[:, :n]
    best = torch.cat([tree.best_action, torch.zeros((g, 1), dtype=torch.int64,
                                                    device=dev)], dim=1)
    best[gi.unsqueeze(-1), target] = bas
    tree.best_action = best[:, :n]


def insert_and_backup(ss: SearchState, sel: PathSel, levels: int, leaf_pos,
                      leaf_ko_hash, ev: LeafEval, superko_illegal, active, sp,
                      leaf_laddered, size: int, pat_bonus=None) -> None:
    """Allocate each game's leaf node (unless terminal / full / illegal,
    or linked to a same-key transposition) and back up (in place).
    pat_bonus: float32[G] pattern bonus of each leaf's move, or None."""
    tree = ss.tree
    dev = tree.visits.device
    g, n = tree.visits.shape
    nn = size * size
    gi = torch.arange(g, device=dev)
    would_alloc = ~sel.is_terminal & (tree.num_nodes < n) & \
        ~superko_illegal & active
    action_loc = torch.where(sel.is_terminal, nn, sel.leaf_action.clamp(min=0))
    state_h = GH.state_hash(leaf_ko_hash, leaf_pos.game_over,
                            leaf_pos.consec_passes)
    reset = GH.simple_repetition_bound_gt(leaf_pos.board.stones, size,
                                          action_loc,
                                          sp.graph_search_rep_bound)
    leaf_graph = GH.graph_hash_step(tree.graph_hash[gi, sel.leaf_parent],
                                    state_h, reset)
    idx = torch.arange(n, device=dev)
    is_tp = (idx < tree.num_nodes.unsqueeze(-1)) & \
        H.hash_eq(tree.graph_hash, leaf_graph.unsqueeze(1))
    tp_idx = B.first_true(is_tp)
    use_tp = sp.use_graph_search & is_tp.any(-1) & would_alloc
    can_alloc = would_alloc & ~use_tp
    new_idx = torch.where(can_alloc, tree.num_nodes, n - 1)

    lp = sel.leaf_parent
    leaf_row = leaf_stats_row(ev, 0.0 if pat_bonus is None else pat_bonus)
    pol16 = ev.policy.to(POL_DT)
    bias_key = _bias_key(tree.pos.board.stones[gi, lp],
                         tree.pos.recent_moves[gi, lp, 0], sel.leaf_action,
                         tree.pos.to_move[gi, lp],
                         tree.pos.simple_ko_loc[gi, lp], size)
    depth = tree.depth[gi, lp] + 1
    ba_leaf = leaf_best_action(leaf_row, pol16, leaf_pos.to_move, sp,
                               ss.dyn_score_center, ss.sqrt_board_area)
    T.tree_map(lambda store, v: _set_rows(store, new_idx, v, can_alloc),
               tree.pos, leaf_pos)
    _set_rows(tree.ko_hash, new_idx, leaf_ko_hash, can_alloc)
    _set_rows(tree.graph_hash, new_idx, leaf_graph, can_alloc)
    _set_rows(tree.parent, new_idx, lp, can_alloc)
    _set_rows(tree.parent_action, new_idx, sel.leaf_action, can_alloc)
    _set_rows(tree.depth, new_idx, depth, can_alloc)
    _set_rows(tree.policy, new_idx, pol16, can_alloc)
    _set_rows(tree.stats, new_idx, leaf_row, can_alloc)
    _set_rows(tree.bias_key, new_idx, bias_key, can_alloc)
    if leaf_laddered is not None:
        _set_rows(tree.laddered, new_idx, leaf_laddered, can_alloc)
    term_own = torch.where(leaf_pos.game_over.unsqueeze(-1),
                           torch.round(ev.ownership), 0.0).to(torch.int8)
    _set_rows(tree.term_own, new_idx, term_own, can_alloc)
    _set_rows(tree.best_action, new_idx, ba_leaf, can_alloc)
    tree.num_nodes = tree.num_nodes + can_alloc.long()

    la = sel.leaf_action.clamp(min=0)
    link_idx = torch.where(use_tp, tp_idx, new_idx)
    old_child = tree.children[gi, lp, la]
    tree.children[gi, lp, la] = torch.where(
        can_alloc | use_tp, link_idx.to(tree.children.dtype), old_child)
    ban = superko_illegal & ~sel.is_terminal
    old_pol = tree.policy[gi, lp, la]
    tree.policy[gi, lp, la] = torch.where(
        ban, torch.full_like(old_pol, -1.0), old_pol)
    ba_parent = node_best_action(tree, lp, sp, ss.ending_bonus,
                                 ss.dyn_score_center, ss.sqrt_board_area)
    tree.best_action[gi, lp] = torch.where(ban, ba_parent,
                                           tree.best_action[gi, lp])

    pad = n - 1
    upd_nodes = torch.cat([
        torch.where(sel.path_nodes >= 0, sel.path_nodes, pad),
        torch.where(can_alloc, new_idx,
                    torch.where(use_tp, tp_idx, pad)).unsqueeze(-1)], dim=1)
    valid = torch.cat([sel.path_nodes >= 0, (can_alloc | use_tp).unsqueeze(-1)],
                      dim=1)
    valid = valid & (~superko_illegal & active).unsqueeze(-1)
    tree.visits.scatter_add_(1, upd_nodes, valid.long())

    bump = sel.is_terminal & ~superko_illegal & active
    tnode = torch.where(bump, sel.terminal_node, pad)
    tree.stats[gi, tnode, C_NN_WEIGHT] = tree.stats[gi, tnode, C_NN_WEIGHT] + \
        torch.where(bump, ev.weight, 0.0)
    backprop_path(ss, sel, levels, sp, ~superko_illegal & active)


def make_nn_evaluator(model, size: int, with_ladders: bool = True,
                      feature_version: int = 7, ladder_mode: str = "chase",
                      sgf_meta=None):
    """Returns batched_eval(leaf_gs, feat_params, sym=None, prev_lad=None)
    -> (raw outputs, legal bool[G, A], laddered bool[G, NN]).

    With prev_lad (the cached ladder masks of the boards one and two moves
    back) only the current boards are solved, all games in one batched
    call of the mode's solver (for "chase", one K1 call on CUDA).
    feature_version: the net's input-feature version 3..7 (V5 has no
    ladder planes, so its evaluations solve no ladders). sgf_meta: a
    humanSL profile (models/sgfmetadata.SGFMetadata); its 192-float row
    depends on the mover (fillMetadataRow nextPlayerIsWhite), so both
    rows are built once and each game takes its mover's."""
    ladders = with_ladders and feature_version != 5
    meta_rows = None

    def batched_eval(leaf_gs, feat_params, sym=None, prev_lad=None):
        nonlocal meta_rows
        legal = H.legal_moves(leaf_gs, size)
        g = legal.shape[0]
        if prev_lad is not None and ladders:
            cur_lad = LAD.batch_solver(ladder_mode)(
                leaf_gs.pos.board.stones, size,
                ko_loc=leaf_gs.pos.simple_ko_loc)
            sp_feat, gl_feat = F.fill_features(
                leaf_gs, size, feat_params, legal, version=feature_version,
                with_ladders=with_ladders, ladder_mode=ladder_mode,
                prev_laddered=prev_lad[0], prev_prev_laddered=prev_lad[1],
                cur_ladder=cur_lad)
        else:
            sp_feat, gl_feat = F.fill_features(
                leaf_gs, size, feat_params, legal, version=feature_version,
                with_ladders=with_ladders, ladder_mode=ladder_mode)
        if ladders:
            laddered = sp_feat[:, :, 14] > 0.5
        else:
            laddered = torch.zeros((g, size * size), dtype=torch.bool,
                                   device=legal.device)
        if sym is not None:
            sp_feat = SYM.transform_spatial(sp_feat, sym, size)
        sp_feat = sp_feat.reshape(g, size, size,
                                  F.NUM_SPATIAL_BY_VERSION[feature_version])
        with torch.no_grad():
            if sgf_meta is not None:
                if meta_rows is None:
                    from katago_torch.models.sgfmetadata import \
                        fill_metadata_row
                    meta_rows = torch.from_numpy(np.stack([
                        fill_metadata_row(sgf_meta, next_player_is_white=w,
                                          board_area=size * size)
                        for w in (False, True)])).to(legal.device)
                rows = meta_rows[(leaf_gs.pos.to_move == B.WHITE).long()]
                raw = model(sp_feat, gl_feat, metadata=rows)
            else:
                raw = model(sp_feat, gl_feat)
        if sym is not None:
            raw = dict(raw)
            raw["policy_logits"] = SYM.untransform_policy(
                raw["policy_logits"], sym, size)
            own = raw["ownership_pretanh"]
            raw["ownership_pretanh"] = SYM.untransform_spatial(
                own.reshape(g, size * size), sym, size).reshape(own.shape)
        return raw, legal, laddered

    return batched_eval


def nn_leaf_eval(raw: dict, legal, to_move, sp, dyn_center, sqrt_area,
                 policy_temp, optimism=None) -> LeafEval:
    """NN outputs (mover perspective) -> white-perspective LeafEval with a
    legal-masked softmax prior."""
    value_probs = torch.softmax(raw["value_logits"].float(), dim=-1)
    winloss_mover = value_probs[:, 0] - value_probs[:, 1]
    mv = raw["miscvalue"].float()
    score_mover = mv[:, 0] * 20.0
    stdev = torch.nn.functional.softplus(mv[:, 1]) * 20.0
    lead_mover = mv[:, 2] * 20.0
    mmv = raw["moremiscvalue"].float()
    st_wl_err = torch.nn.functional.softplus(mmv[:, 0] * 0.5) * 0.5
    st_score_err = torch.nn.functional.softplus(mmv[:, 1] * 0.5) * 5.4772256
    winloss_w = _white_persp(winloss_mover, to_move)
    score_w = _white_persp(score_mover, to_move)
    lead_w = _white_persp(lead_mover, to_move)
    meansq_w = score_w * score_w + stdev * stdev
    util = utility_of(winloss_w, score_w, meansq_w, sp, dyn_center, sqrt_area)
    weight = uncertainty_weight(st_wl_err, st_score_err, score_w, sp,
                                dyn_center, sqrt_area)
    # pre-v9 nets have no error heads: weight 1.0, as the reference's
    # supportsShorttermError() guard (searchupdatehelpers.cpp:117)
    if raw.get("supports_shortterm_error", True) is False:
        weight = torch.ones_like(weight)
    pl = raw["policy_logits"].float()
    logits = pl[:, 0]
    if optimism is not None and pl.shape[1] > 1:
        logits = logits + (pl[:, 1] - logits) * optimism
    logits = logits / torch.clamp(sp.nn_policy_temperature, min=1e-6)
    logits = logits / torch.clamp(policy_temp, min=1e-6).unsqueeze(-1)
    logits = torch.where(legal, logits, -1e30)
    pol = torch.softmax(logits, dim=-1)
    pol = torch.where(legal, pol, -1.0)
    nn_area = legal.shape[1] - 1
    g = legal.shape[0]
    own_mover = torch.tanh(raw["ownership_pretanh"].float().reshape(g, -1)
                           [:, :nn_area])
    own_w = _white_persp(own_mover, to_move.unsqueeze(-1))
    return LeafEval(utility=util, winloss=winloss_w, score_mean=score_w,
                    score_meansq=meansq_w, score_stdev=stdev, lead=lead_w,
                    policy=pol, weight=weight, ownership=own_w)


def _sample_gamma(alpha, gen):
    """Gamma(alpha, 1) draws (Marsaglia-Tsang, with the alpha < 1 boost)
    from the given torch.Generator."""
    boost = alpha < 1.0
    a = torch.where(boost, alpha + 1.0, alpha)
    d = a - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.zeros_like(a)
    todo = torch.ones_like(a, dtype=torch.bool)
    while bool(todo.any()):
        x = torch.randn(a.shape, generator=gen, device=a.device)
        u = torch.rand(a.shape, generator=gen, device=a.device)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(torch.clamp(v, min=1e-30)))
        out = torch.where(todo & ok, d * v, out)
        todo = todo & ~ok
    u = torch.rand(a.shape, generator=gen, device=a.device)
    return torch.where(boost, out * torch.pow(u, 1.0 / alpha), out)


def root_ending_bonus(gs: H.GameState, own_white, sp, size: int):
    """getEndingWhiteScoreBonus per game: white-perspective per-root-move
    score bonuses scaled by rootEndingBonusPoints. [G, A]."""
    nn = size * size
    stones = gs.pos.board.stones
    pla = gs.pos.to_move
    opp = B.opponent(pla)
    labels = B.connected_labels(stones, size)
    libs = B.chain_liberties(stones, labels, size)
    area_ish = (gs.rules.scoring_rule == R.SCORING_AREA) | \
        (gs.pos.encore_phase >= 2)
    own_pla = torch.where((pla == B.WHITE).unsqueeze(-1), own_white,
                          -own_white)
    extreme, tail = 0.95, 0.05
    nbr_s = B.shift4(stones, size, B.WALL)
    nbr_libs = B.shift4(libs, size, 0)
    nbr_lab = B.shift4(labels, size, nn)
    op3 = opp.reshape(-1, 1, 1)
    would_capture = ((nbr_s == op3) & (nbr_libs == 1)).any(dim=-2)
    adj_opp = (nbr_s == op3).any(dim=-2)
    safe_all, _ = benson.pass_alive_area_for(
        stones, pla, gs.rules.multi_suicide, size, False, False)
    nbr_safe = B.shift4(safe_all.long(), size, 1) > 0
    nonpa_own = (nbr_s == pla.reshape(-1, 1, 1)) & ~nbr_safe
    lab_or_big = torch.where(nonpa_own, nbr_lab, nn)
    srt = torch.sort(lab_or_big, dim=-2).values
    distinct = (srt[:, 0] < nn).long() + (
        (srt[:, 1:] != srt[:, :-1]) & (srt[:, 1:] < nn)).long().sum(dim=-2)
    self_conn = distinct >= 2
    opp_owned = torch.clamp((-extreme - own_pla) / tail, 0.0, 1.0)
    own_owned = torch.clamp((own_pla - extreme) / tail, 0.0, 1.0)
    own_owned = torch.where(adj_opp | self_conn, 0.0, own_owned)
    pen = torch.where(area_ish.unsqueeze(-1),
                      torch.where(would_capture, 0.0, opp_owned) + own_owned,
                      opp_owned + own_owned)
    pen = torch.where((gs.pos.board.ko_loc < 0).unsqueeze(-1), pen, 0.0)
    pass_pen = torch.where(area_ish,
                           torch.where(gs.rules.has_button, 0.5, 0.0),
                           2.0 / 3.0).to(torch.float32)
    extra = torch.cat([-pen, -pass_pen.unsqueeze(-1)], dim=-1) * \
        sp.root_ending_bonus_points
    return torch.where((pla == B.WHITE).unsqueeze(-1), extra, -extra)


def _feature_params(sp) -> F.FeatureParams:
    return F.FeatureParams(
        draw_equiv_wins_for_white=sp.draw_equivalent_wins_for_white,
        playout_doubling_advantage=sp.playout_doubling_advantage,
        conservative_pass=sp.conservative_pass)


def _root_noise(pol, sp, gen: torch.Generator):
    """Dirichlet noise mixed into root priors [G, A] (-1 = illegal) when
    sp.root_noise_enabled (searchparams.h:44-47)."""
    if not bool(sp.root_noise_enabled):
        return pol
    legal_mask = pol >= 0
    n_legal = torch.clamp(legal_mask.sum(-1, keepdim=True), min=1)
    alpha = sp.root_dirichlet_noise_total_concentration / n_legal
    gamma = _sample_gamma(torch.where(legal_mask, alpha, 1e-6), gen)
    noise = gamma / torch.clamp(torch.where(legal_mask, gamma, 0.0).sum(
        -1, keepdim=True), min=1e-10)
    mixed = (1.0 - sp.root_dirichlet_noise_weight) * pol + \
        sp.root_dirichlet_noise_weight * noise
    return torch.where(legal_mask, mixed, -1.0)


def extract_subtree(tree: Tree, action) -> Tree:
    """Re-root every game's pool at the old root's child for action[g]
    (Search::makeMove tree reuse, search.h:253-257).

    The result is compacted: node 0 is that child and the nodes are
    exactly its subtree (stats, positions and links kept, everything
    else cleared, as the JAX package clears it). A game whose child was
    never expanded (or whose action is negative) gets num_nodes == 0
    and the caller falls back to a fresh root. Membership comes from
    pointer jumping over the parent links; children are allocated after
    their parents, so the new root is the least index of its subtree and
    the cumsum compaction maps it to slot 0."""
    g, n = tree.visits.shape
    dev = tree.visits.device
    gi = torch.arange(g, device=dev)
    idx = torch.arange(n, device=dev)
    action = action.long()
    new_root = tree.children[gi, 0, action.clamp(min=0)].long()
    has = (new_root >= 0) & (action >= 0)
    nr = new_root.clamp(min=0)

    valid = idx < tree.num_nodes.unsqueeze(-1)
    in_sub = (idx == nr.unsqueeze(-1)) & valid
    p = torch.where(valid & (tree.parent >= 0), tree.parent, idx)
    for _ in range(int(np.ceil(np.log2(max(n, 2)))) + 1):
        in_sub = in_sub | in_sub.gather(1, p)
        p = p.gather(1, p)
    in_sub = in_sub & valid & has.unsqueeze(-1)

    new_idx = torch.cumsum(in_sub.long(), dim=1) - 1
    target = torch.where(in_sub, new_idx, n)      # n: the dump slot
    rows = gi.unsqueeze(-1)

    def scatter(arr, fill=0):
        out = torch.full((g, n + 1) + arr.shape[2:], fill, dtype=arr.dtype,
                         device=dev)
        out[rows, target] = arr
        return out[:, :n]

    def remap(links):
        """Old node indices [G, N, ...] (-1 = none) -> new ones; a link
        out of the subtree becomes -1."""
        flat = links.long().reshape(g, -1)
        c = flat.clamp(0, n - 1)
        ok = (flat >= 0) & in_sub.gather(1, c)
        return torch.where(ok, new_idx.gather(1, c), -1).reshape(
            links.shape).to(links.dtype)

    stats = tree.stats.clone()
    stats[..., C_LAST_BIAS_DELTA] = 0.0
    stats[..., C_LAST_BIAS_WEIGHT] = 0.0
    return Tree(
        pos=T.tree_map(scatter, tree.pos),
        ko_hash=scatter(tree.ko_hash),
        graph_hash=scatter(tree.graph_hash),
        parent=scatter(remap(tree.parent), -1),
        parent_action=scatter(tree.parent_action, -1),
        depth=scatter(tree.depth - tree.depth[gi, nr].unsqueeze(-1)),
        children=scatter(remap(tree.children), -1),
        policy=scatter(tree.policy),
        visits=scatter(tree.visits),
        stats=scatter(stats),
        bias_key=scatter(tree.bias_key, -1),
        laddered=scatter(tree.laddered),
        term_own=scatter(tree.term_own),
        best_action=scatter(tree.best_action),
        num_nodes=in_sub.sum(-1))


def _reused_tree(prev_tree: Tree, prev_actions, roots: H.GameState, sp,
                 gen: torch.Generator, root_lad, root_town, size: int,
                 max_nodes: int, root_allowed_mask=None) -> Tree:
    """The previous search's trees re-rooted at the played moves (or, with
    prev_actions None, taken as already rooted at roots), padded to
    max_nodes, with the root's prior re-tempered and re-noised and its
    ladder mask, terminal ownership, pattern bonus and position set from
    the live roots."""
    prev_n = prev_tree.visits.shape[1]
    if prev_n > max_nodes:
        raise ValueError(
            f"tree reuse requires prev max_nodes ({prev_n}) <= new "
            f"max_nodes ({max_nodes}); shrinking pools would corrupt "
            "subtree links")
    if prev_actions is not None:
        tree = extract_subtree(prev_tree, prev_actions)
    else:
        tree = T.tree_map(torch.clone, prev_tree)
    g = tree.num_nodes.shape[0]
    dev = tree.num_nodes.device
    if prev_n < max_nodes:
        empty = empty_tree(size, max_nodes, g, dev)
        tree = T.tree_map(
            lambda a, e: torch.cat([a, e[:, prev_n:]], 1) if a.dim() >= 2
            else a, tree, empty)
    # the stored prior is the child's leaf prior: apply the root policy
    # temperature (as a power) and the root noise
    pol = tree.policy[:, 0, :]
    legal = pol >= 0
    p = torch.where(legal, torch.clamp(pol, min=1e-10), 1.0).float()
    p = torch.pow(p, 1.0 / torch.clamp(sp.root_policy_temperature,
                                       min=1e-6))
    p = p / torch.clamp(torch.where(legal, p, 0.0).sum(-1, keepdim=True),
                        min=1e-10)
    p = torch.where(legal, _root_noise(torch.where(legal, p, -1.0), sp, gen),
                    -1.0)
    if root_allowed_mask is not None:
        p = torch.where(root_allowed_mask, p, -1.0)
    tree.policy[:, 0, :] = p.to(POL_DT)
    tree.laddered[:, 0] = root_lad
    tree.term_own[:, 0] = root_town
    tree.stats[:, 0, C_PATTERN_BONUS] = 0.0   # none on the root itself
    zero = torch.zeros((g,), dtype=torch.int64, device=dev)
    on = torch.ones((g,), dtype=torch.bool, device=dev)
    T.tree_map(lambda store, v: _set_rows(store, zero, v, on), tree.pos,
               roots.pos)
    return tree


def init_search(model, roots: H.GameState, sp, gen: torch.Generator, *,
                size: int, max_nodes: int, with_ladders: bool = True,
                ladder_mode: str = "chase", root_num_symmetries: int = 1,
                feature_version: int = 7, prev_tree: Tree | None = None,
                prev_actions=None, root_allowed_mask=None, mirror=None,
                track_moves_ownership: bool = False, sgf_meta=None,
                _root_syms=None) -> SearchState:
    """SearchState for a batch of games (Search::beginSearch): root NN
    eval, Dirichlet noise, dynamic score center, root pruning.

    prev_tree / prev_actions: tree reuse — the previous search's trees
    and the actions then played; each game re-roots at the played child
    and falls back to a fresh root where that child was never expanded.
    With prev_actions None, prev_tree is taken as already rooted at the
    current positions. The reused root's stored prior gets the root
    temperature and noise again.

    root_allowed_mask bool[G, A]: avoid/allow moves; disallowed root
    moves get an illegal prior. root_num_symmetries > 1: the root eval
    averaged over that many dihedral symmetries per game, drawn from gen
    (_root_syms int[n, G] gives them instead: the tests pass the JAX
    fixture's, since a JAX key cannot be reproduced). mirror: the
    anti-mirror verdict (root prior boosts). track_moves_ownership:
    allocate the per-root-move ownership sums run_playouts fills.
    sgf_meta: the humanSL profile the evaluations are conditioned on."""
    nn = size * size
    dev = roots.pos.to_move.device
    g = roots.pos.to_move.shape[0]
    evaluator = make_nn_evaluator(model, size, with_ladders=with_ladders,
                                  feature_version=feature_version,
                                  ladder_mode=ladder_mode, sgf_meta=sgf_meta)
    feat_params = _feature_params(sp)
    tree = empty_tree(size, max_nodes, g, dev)
    root_ko_hash = H._pos_ko_hash(roots.pos, roots.rules)
    ss = SearchState(
        tree=tree, rules=roots.rules, root_hist=roots.ko_hash_hist,
        root_hist_len=roots.hist_len,
        dyn_score_center=torch.zeros((g,), device=dev),
        sqrt_board_area=torch.sqrt(
            (roots.pos.board.stones != B.WALL).float().sum(-1)),
        bias_sum=torch.zeros((g, BIAS_TABLE_SIZE), device=dev),
        bias_weight=torch.zeros((g, BIAS_TABLE_SIZE), device=dev),
        own_sum=torch.zeros((g, nn), device=dev),
        own_sq_sum=torch.zeros((g, nn), device=dev),
        own_weight=torch.zeros((g,), device=dev),
        ending_bonus=torch.zeros((g, nn + 1), device=dev),
        root_prev_laddered=torch.zeros((g, nn), dtype=torch.bool,
                                       device=dev),
        mo_sum=torch.zeros((g, nn + 1, nn) if track_moves_ownership
                           else (g, 1, 1), device=dev),
        mo_sq_sum=torch.zeros((g, nn + 1, nn) if track_moves_ownership
                              else (g, 1, 1), device=dev),
        mo_weight=torch.zeros((g, nn + 1 if track_moves_ownership else 1),
                              device=dev))
    if with_ladders:
        ss.root_prev_laddered = LAD.batch_solver(ladder_mode)(
            roots.pos.prev_stones.to(torch.int32), size,
            ko_loc=roots.pos.prev_ko_loc).laddered

    def eval_with_sym(sym):
        raw, legal, lad = evaluator(roots, feat_params, sym=sym)
        ev = nn_leaf_eval(raw, legal, roots.pos.to_move, sp,
                          ss.dyn_score_center, ss.sqrt_board_area,
                          sp.root_policy_temperature.expand(g),
                          optimism=sp.root_policy_optimism)
        return ev, legal, lad

    if root_num_symmetries <= 1:
        root_ev, root_legal, root_lad = eval_with_sym(None)
    else:
        # rootNumSymmetriesToSample (searchparams.h:76): sampled with
        # replacement; the derived values and policy probs are averaged
        # (illegal slots stay -1: legality is symmetry-invariant)
        syms = _root_syms if _root_syms is not None else torch.randint(
            0, 8, (root_num_symmetries, g), generator=gen, device=dev)
        syms = syms.to(dev)
        root_ev, root_legal, root_lad = eval_with_sym(syms[0])
        evs = [root_ev] + [eval_with_sym(syms[i])[0]
                           for i in range(1, root_num_symmetries)]
        root_ev = T.tree_map(lambda *xs: sum(xs) / float(len(xs)), *evs)

    if bool(sp.wide_root_noise > 0.0):
        pol = root_ev.policy
        legal_m = pol >= 0
        p = torch.pow(torch.clamp(pol, min=1e-30),
                      1.0 / (4.0 * sp.wide_root_noise + 1.0))
        p = torch.where(legal_m, p, 0.0)
        p = p / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
        root_ev.policy = torch.where(legal_m, p, -1.0)

    ss.ending_bonus = root_ending_bonus(roots, root_ev.ownership, sp, size)
    expected = root_ev.score_mean
    center = expected * (1.0 - sp.dynamic_score_center_zero_weight)
    cap = ss.sqrt_board_area * sp.dynamic_score_center_scale
    ss.dyn_score_center = torch.minimum(torch.maximum(center, expected - cap),
                                        expected + cap)

    if mirror is not None:
        from katago_torch.search import mirror as MIR
        root_ev.policy = MIR.adjust_policy(
            root_ev.policy, roots.pos.recent_moves[:, 0], roots.pos.to_move,
            torch.zeros((g,), dtype=torch.int64, device=dev),
            roots.pos.board.stones, mirror.mirroring, mirror.mirror_pla,
            mirror.advantage, roots.pos.to_move, size)

    root_pol = _root_noise(root_ev.policy, sp, gen)
    if root_allowed_mask is not None:
        # avoidMoves / allowMoves: disallowed root moves get an illegal
        # prior so the search never tries them
        root_pol = torch.where(root_allowed_mask, root_pol, -1.0)

    stones_r = roots.pos.board.stones
    rm = roots.pos.recent_moves
    opp_passed4 = (rm[:, [0, 2, 4, 6]] >= nn).all(-1)
    safe_pla, _ = benson.pass_alive_area_for(
        stones_r, roots.pos.to_move, roots.rules.multi_suicide, size,
        False, False)
    safe_opp, _ = benson.pass_alive_area_for(
        stones_r, B.opponent(roots.pos.to_move), roots.rules.multi_suicide,
        size, False, False)
    banned = (safe_pla | safe_opp) & opp_passed4.unsqueeze(-1) & \
        sp.root_prune_useless_moves
    if bool(sp.root_symmetry_pruning):
        banned = banned | _sym_dup_moves(roots, root_legal, size)
    banned = torch.cat([banned, torch.zeros((g, 1), dtype=torch.bool,
                                            device=dev)], dim=1)
    any_left = ((root_pol >= 0) & ~banned).any(-1, keepdim=True)
    root_pol = torch.where(banned & any_left, -1.0, root_pol)
    root_ev.policy = root_pol

    root_town = torch.zeros((g, nn), dtype=torch.int8, device=dev)
    over = roots.pos.game_over
    if bool(over.any()):
        root_term = terminal_eval_of_pos(roots.pos, roots.rules, sp, size,
                                         ss.dyn_score_center,
                                         ss.sqrt_board_area, nn + 1)
        root_term.policy = root_ev.policy
        root_ev = T.where(over, root_term, root_ev)
        root_town = torch.where(over.unsqueeze(-1),
                                torch.round(root_term.ownership),
                                0.0).to(torch.int8)

    zero = torch.zeros((g,), dtype=torch.int64, device=dev)
    on = torch.ones((g,), dtype=torch.bool, device=dev)
    T.tree_map(lambda store, v: _set_rows(store, zero, v, on), tree.pos,
               roots.pos)
    tree.ko_hash[:, 0] = root_ko_hash
    tree.graph_hash[:, 0] = GH.state_hash(root_ko_hash, over,
                                          roots.pos.consec_passes)
    tree.policy[:, 0] = root_ev.policy.to(POL_DT)
    tree.visits[:, 0] = 1
    tree.stats[:, 0] = leaf_stats_row(root_ev, 0.0)
    tree.laddered[:, 0] = root_lad
    tree.term_own[:, 0] = root_town
    tree.num_nodes[:] = 1
    if prev_tree is not None:
        reused = _reused_tree(prev_tree, prev_actions, roots, sp, gen,
                              root_lad, root_town, size, max_nodes,
                              root_allowed_mask)
        tree = T.where(reused.num_nodes > 0, reused, tree)
        ss.tree = tree
    ss.own_sum = root_ev.weight.unsqueeze(-1) * root_ev.ownership
    ss.own_sq_sum = root_ev.weight.unsqueeze(-1) * root_ev.ownership ** 2
    ss.own_weight = root_ev.weight
    tree.best_action[:, 0] = node_best_action(
        tree, zero, sp, ss.ending_bonus, ss.dyn_score_center,
        ss.sqrt_board_area)
    return ss


def _sym_dup_moves(gs: H.GameState, legal, size: int):
    """rootSymmetryPruning (markDuplicateMoveLocs): on symmetric positions
    free of ko bans keep one representative move per symmetry orbit."""
    nn = size * size
    dev = legal.device
    perm = torch.from_numpy(SYM.loc_perm_np(size)[:, :nn]).to(dev)  # [8, NN]
    stones_r = gs.pos.board.stones
    inv = (stones_r.unsqueeze(1) == stones_r[:, perm]).all(-1)      # [G, 8]
    in_encore = (gs.pos.encore_phase > 0).unsqueeze(-1)
    krb = gs.pos.ko_recap_blocked
    inv = inv & (~in_encore | (krb.unsqueeze(1) == krb[:, perm]).all(-1))
    ses = gs.pos.second_encore_start
    inv = inv & ((gs.pos.encore_phase < 2).unsqueeze(-1)
                 | (ses.unsqueeze(1) == ses[:, perm]).all(-1))
    inv[:, 0] = True
    board_no_ko = dataclasses.replace(
        gs.pos.board, ko_loc=torch.full_like(gs.pos.board.ko_loc, -1))
    basic = B.legal_moves_basic(board_no_ko, gs.pos.to_move,
                                gs.rules.multi_suicide, size)
    ko_banned_any = (basic & ~legal[:, :nn]).any(-1) | \
        (gs.pos.board.ko_loc >= 0)
    act = inv & ~ko_banned_any.unsqueeze(-1)
    act[:, 0] = True
    xs = torch.arange(nn, device=dev) % size
    ys = torch.div(torch.arange(nn, device=dev), size, rounding_mode="floor")
    rank = torch.where((gs.pos.to_move == B.BLACK).unsqueeze(-1),
                       (size - 1 - xs) * size + ys, xs * size + (size - 1 - ys))
    sym_rank = torch.where(act.unsqueeze(-1), rank[:, perm], 2 ** 30)
    orbit_min = sym_rank.amin(dim=1)
    return rank > orbit_min


def run_playouts(model, ss: SearchState, sp, gen: torch.Generator, *,
                 size: int, num_sims: int, max_depth: int = 64,
                 with_ladders: bool = True, ladder_mode: str = "chase",
                 max_visits: int | None = None, active_mask=None,
                 max_superko_retries: int = 3,
                 feature_version: int = 7, mirror=None,
                 pattern_bonus=None, sgf_meta=None,
                 track_moves_ownership: bool = False) -> SearchState:
    """Advance every game's search by num_sims playouts (in place).

    max_visits: games whose root reached it run masked no-op playouts.
    A superko-rejected expansion marks the prior illegal and retries the
    descent up to max_superko_retries times; only a game that exhausts
    the retries voids its playout. mirror: the anti-mirror verdict
    (descent-time forced exploration, fresh-node prior boosts).
    track_moves_ownership: each leaf eval's ownership is added to its
    playout's root move (init_search must have allocated the sums).
    pattern_bonus: a patternbonus.PatternBonusArrs table (None: off);
    each fresh node takes the bonus of its move's 9x9 pattern
    (patternbonustable.cpp get). sgf_meta: as init_search's."""
    nn = size * size
    a = nn + 1
    g = ss.root_hist_len.shape[0]
    dev = ss.root_hist_len.device
    gi = torch.arange(g, device=dev)
    evaluator = make_nn_evaluator(model, size, with_ladders=with_ladders,
                                  feature_version=feature_version,
                                  ladder_mode=ladder_mode, sgf_meta=sgf_meta)
    feat_params = _feature_params(sp)
    random_sym = bool(sp.nn_random_symmetry)     # one sync, not one a playout

    def select_leaf():
        sel, levels = select_path(ss, max_depth, sp, mirror, size)
        leaf_pos, leaf_kh, leaf_gs = make_leaf_gamestate(ss, sel, size)
        max_hist = leaf_gs.ko_hash_hist.shape[1]
        valid = torch.arange(max_hist, device=dev) < \
            (leaf_gs.hist_len - 1).unsqueeze(-1)
        sk = (H.hash_eq(leaf_gs.ko_hash_hist, leaf_kh.unsqueeze(1))
              & valid).any(-1)
        sk = sk & ~sel.is_terminal & (sel.leaf_action < nn)
        return sel, levels, leaf_pos, leaf_kh, leaf_gs, sk

    for _ in range(num_sims):
        active = torch.ones((g,), dtype=torch.bool, device=dev) \
            if active_mask is None else active_mask
        if max_visits is not None:
            active = active & (ss.tree.visits[:, 0] < max_visits)
            # every game at its cap: the remaining playouts of the chunk
            # would be masked no-ops, so stop (one sync per playout)
            if not bool(active.any()):
                break
        sel, levels, leaf_pos, leaf_kh, leaf_gs, sk = select_leaf()
        need = sk & active
        tries = 0
        while tries < max_superko_retries and bool(need.any()):
            tree = ss.tree
            pa = sel.leaf_action.clamp(min=0)
            old = tree.policy[gi, sel.leaf_parent, pa]
            tree.policy[gi, sel.leaf_parent, pa] = torch.where(
                need, torch.full_like(old, -1.0), old)
            ba = node_best_action(tree, sel.leaf_parent, sp, ss.ending_bonus,
                                  ss.dyn_score_center, ss.sqrt_board_area)
            tree.best_action[gi, sel.leaf_parent] = torch.where(
                need, ba, tree.best_action[gi, sel.leaf_parent])
            sel_n, levels_n, lp_n, lk_n, lg_n, sk_n = select_leaf()
            sel = T.where(need, sel_n, sel)
            leaf_pos = T.where(need, lp_n, leaf_pos)
            leaf_kh = torch.where(need.unsqueeze(-1), lk_n, leaf_kh)
            leaf_gs = T.where(need, lg_n, leaf_gs)
            levels = max(levels, levels_n)
            need = need & sk_n
            tries += 1
        void = need

        sym = None
        if random_sym:
            sym = torch.randint(0, 8, (g,), generator=gen, device=dev)
        pmask = ss.tree.laddered[gi, sel.leaf_parent]
        gp = ss.tree.parent[gi, sel.leaf_parent]
        gpmask = torch.where((gp >= 0).unsqueeze(-1),
                             ss.tree.laddered[gi, gp.clamp(min=0)],
                             ss.root_prev_laddered)
        raw, legal, leaf_lad = evaluator(leaf_gs, feat_params, sym=sym,
                                         prev_lad=(pmask, gpmask))
        nn_ev = nn_leaf_eval(raw, legal, leaf_gs.pos.to_move, sp,
                             ss.dyn_score_center, ss.sqrt_board_area,
                             torch.ones((g,), device=dev),
                             optimism=sp.policy_optimism)
        term_ev = terminal_eval(ss, sel.terminal_node, sp, size)
        if bool(leaf_pos.game_over.any()):
            leaf_term_ev = terminal_eval_of_pos(
                leaf_pos, ss.rules, sp, size, ss.dyn_score_center,
                ss.sqrt_board_area, a)
        else:
            leaf_term_ev = _leaf_eval_filled(g, a, nn, dev)
        leaf_term_ev.policy = nn_ev.policy
        ev = T.where(sel.is_terminal, term_ev,
                     T.where(leaf_pos.game_over, leaf_term_ev, nn_ev))
        if mirror is not None:
            # anti-mirror prior boosts on the fresh node's policy
            # (maybeApplyAntiMirrorPolicy, searchmirror.cpp:95-153)
            from katago_torch.search import mirror as MIR
            ev.policy = MIR.adjust_policy(
                ev.policy, sel.leaf_action, leaf_pos.to_move,
                ss.tree.depth[gi, sel.leaf_parent] + 1,
                leaf_pos.board.stones, mirror.mirroring, mirror.mirror_pla,
                mirror.advantage, ss.tree.pos.to_move[:, 0], size)
        pat_leaf = None
        if pattern_bonus is not None:
            # avoid-repeated-shapes bonus of the expansion move, resolved
            # against the host-built table (patternbonustable.cpp get)
            from katago_torch.search import patternbonus as PB
            pat_leaf = PB.lookup(pattern_bonus,
                                 ss.tree.pos.board.stones[gi, sel.leaf_parent],
                                 sel.leaf_action.clamp(min=0),
                                 ss.tree.pos.to_move[gi, sel.leaf_parent],
                                 size)
        insert_and_backup(ss, sel, levels, leaf_pos, leaf_kh, ev, void,
                          active, sp, leaf_lad if with_ladders else None,
                          size, pat_bonus=pat_leaf)
        ok = (active & ~void).unsqueeze(-1)
        ss.own_sum = ss.own_sum + torch.where(
            ok, ev.weight.unsqueeze(-1) * ev.ownership, 0.0)
        ss.own_sq_sum = ss.own_sq_sum + torch.where(
            ok, ev.weight.unsqueeze(-1) * ev.ownership ** 2, 0.0)
        ss.own_weight = ss.own_weight + torch.where(ok[:, 0], ev.weight, 0.0)
        if track_moves_ownership:
            # the leaf eval belongs to its playout's root child
            # (analysis.cpp includeMovesOwnership)
            ra = sel.root_action.clamp(min=0)
            okm = (ok[:, 0] & (sel.root_action >= 0)).unsqueeze(-1)
            wo = ev.weight.unsqueeze(-1) * ev.ownership
            ss.mo_sum[gi, ra] = ss.mo_sum[gi, ra] + torch.where(okm, wo, 0.0)
            ss.mo_sq_sum[gi, ra] = ss.mo_sq_sum[gi, ra] + torch.where(
                okm, wo * ev.ownership, 0.0)
            ss.mo_weight[gi, ra] = ss.mo_weight[gi, ra] + torch.where(
                okm[:, 0], ev.weight, 0.0)
    return ss


def run_search(model, roots: H.GameState, sp, gen: torch.Generator, *,
               size: int, num_sims: int, max_nodes: int, max_depth: int = 64,
               with_ladders: bool = True, ladder_mode: str = "chase",
               prev_tree: Tree | None = None, prev_actions=None,
               max_visits: int | None = None, active_mask=None,
               feature_version: int = 7, root_allowed_mask=None,
               root_num_symmetries: int = 1, mirror=None,
               pattern_bonus=None, track_moves_ownership: bool = False,
               sgf_meta=None, _root_syms=None) -> SearchResult:
    """One-shot search: init (with optional tree reuse), exactly num_sims
    playouts under the max_visits cap, then the results. The root
    extras are those of init_search and run_playouts."""
    ss = init_search(model, roots, sp, gen, size=size, max_nodes=max_nodes,
                     with_ladders=with_ladders, ladder_mode=ladder_mode,
                     feature_version=feature_version, prev_tree=prev_tree,
                     prev_actions=prev_actions,
                     root_allowed_mask=root_allowed_mask,
                     root_num_symmetries=root_num_symmetries, mirror=mirror,
                     track_moves_ownership=track_moves_ownership,
                     sgf_meta=sgf_meta, _root_syms=_root_syms)
    run_playouts(model, ss, sp, gen, size=size, num_sims=num_sims,
                 max_depth=max_depth, with_ladders=with_ladders,
                 ladder_mode=ladder_mode, max_visits=max_visits,
                 active_mask=active_mask, feature_version=feature_version,
                 mirror=mirror, pattern_bonus=pattern_bonus,
                 sgf_meta=sgf_meta,
                 track_moves_ownership=track_moves_ownership)
    return collect_results(ss)


def collect_results(ss: SearchState) -> SearchResult:
    """Root / child statistics of the current trees."""
    tree = ss.tree
    children = tree.children[:, 0, :].long()
    child_idx = children.clamp(min=0)
    has_child = children >= 0
    cvis = torch.where(has_child, tree.visits.gather(1, child_idx), 0)
    ws = tree.stats[..., C_WEIGHT_SUM]
    root_w = torch.clamp(ws[:, 0], min=1e-10)
    cw = torch.clamp(ws.gather(1, child_idx), min=1e-10)
    child_wl = torch.where(
        has_child, tree.stats[..., C_WINLOSS_SUM].gather(1, child_idx) / cw,
        0.0)
    child_sc = torch.where(
        has_child,
        tree.stats[..., C_SCORE_MEAN_SUM].gather(1, child_idx) / cw, 0.0)
    root = tree.stats[:, 0]
    own_w = torch.clamp(ss.own_weight, min=1e-10).unsqueeze(-1)
    own_mean = ss.own_sum / own_w
    mo_w = torch.clamp(ss.mo_weight, min=1e-10).unsqueeze(-1)
    mo_mean = ss.mo_sum / mo_w
    return SearchResult(
        ss=ss,
        root_visits=tree.visits[:, 0],
        child_visits=cvis,
        root_policy_prior=tree.policy[:, 0, :].float(),
        root_winloss=root[:, C_WINLOSS_SUM] / root_w,
        root_score_mean=root[:, C_SCORE_MEAN_SUM] / root_w,
        root_lead=root[:, C_LEAD_SUM] / root_w,
        root_utility=root[:, C_UTILITY_SUM] / root_w,
        child_winloss=child_wl,
        child_score_mean=child_sc,
        root_ownership=own_mean,
        root_ownership_stdev=torch.sqrt(torch.clamp(
            ss.own_sq_sum / own_w - own_mean ** 2, min=0.0)),
        moves_ownership=mo_mean,
        moves_ownership_stdev=torch.sqrt(torch.clamp(
            ss.mo_sq_sum / mo_w - mo_mean ** 2, min=0.0)),
        moves_own_weight=ss.mo_weight,
        root_score_stdev=torch.sqrt(torch.clamp(
            root[:, C_SCORE_MEANSQ_SUM] / root_w
            - (root[:, C_SCORE_MEAN_SUM] / root_w) ** 2, min=0.0)))


def _child_lcb_radius(result: SearchResult, sp):
    """Per-root-child self-utility LCB and radius
    (Search::getSelfUtilityLCBAndRadius), all [G, A]."""
    tree = result.ss.tree
    children = tree.children[:, 0, :].long()
    exists = children >= 0
    c = children.clamp(min=0)

    def gat(col):
        return tree.stats[..., col].gather(1, c)

    w = torch.where(exists, gat(C_WEIGHT_SUM), 0.0)
    wsq = torch.where(exists, gat(C_WEIGHT_SQ_SUM), 0.0)
    winv = 1.0 / torch.clamp(w, min=1e-10)
    u_avg = gat(C_UTILITY_SUM) * winv
    usq_avg = gat(C_UTILITY_SQ_SUM) * winv
    radius_max = 2.0 * (sp.win_loss_utility_factor
                        + sp.static_score_utility_factor
                        + sp.dynamic_score_utility_factor) * sp.lcb_stdevs
    ess = w * w / torch.clamp(wsq, min=1e-10)
    prior_w = w / torch.clamp(ess * ess * ess, min=1e-10)
    r2 = (radius_max / (2.0 * sp.lcb_stdevs)) ** 2
    usq_avg = torch.maximum(usq_avg, u_avg * u_avg + 1e-8)
    usq_avg = (usq_avg * w + (usq_avg + r2 * 4.0) * prior_w) / \
        torch.clamp(w + prior_w, min=1e-10)
    w2 = w + prior_w
    wsq2 = wsq + prior_w * prior_w
    ess2 = w2 * w2 / torch.clamp(wsq2, min=1e-10)
    pla = tree.pos.to_move[:, 0].unsqueeze(-1)
    self_u = torch.where(pla == B.WHITE, u_avg, -u_avg)
    var = torch.clamp(usq_avg - u_avg * u_avg, min=0.0)
    radius = torch.sqrt(var / torch.clamp(ess2, min=1e-10)) * sp.lcb_stdevs
    good = exists & (w > 0)
    lcb = torch.where(good, self_u - radius, -radius_max)
    return exists, good, w, self_u, radius, lcb


def extract_pv(tree: Tree, max_len: int = 15, start=0, games=None):
    """Principal variations by greedy max-edge-visits descent
    (Search::appendPV / getPV, searchresults.cpp:773-867), batched.

    games int[K]: the game of each PV (default: every game once); start:
    the node each PV descends from, an int or int[K] (0 = the root; a
    child index gives a candidate's continuation; negative = empty).
    Returns (moves int64[K, max_len], -1 padded, and lengths int64[K])."""
    dev = tree.visits.device
    if games is None:
        games = torch.arange(tree.visits.shape[0], device=dev)
    start = torch.as_tensor(start, device=dev).long().expand(games.shape)
    node = start.clamp(min=0)
    done = start < 0
    moves = torch.full((games.shape[0], max_len), -1, dtype=torch.int64,
                       device=dev)
    visits = tree.visits[games]
    kk = torch.arange(games.shape[0], device=dev)
    for i in range(max_len):
        children = tree.children[games, node].long()
        w = torch.where(children >= 0, visits.gather(1, children.clamp(
            min=0)), -1)
        best = torch.argmax(w, dim=1)
        child = children[kk, best]
        valid = (child >= 0) & (w[kk, best] > 0) & ~done
        moves[:, i] = torch.where(valid, best, -1)
        node = torch.where(valid, child.clamp(min=0), node)
        done = done | ~valid
    return moves, (moves >= 0).sum(1)


def child_analysis_extras(result: SearchResult, sp) -> dict:
    """Reporting-only per-root-child stats for moveInfos
    (searchresults.cpp getJson: lcb / utilityLcb / scoreStdev / weight).

    Returns a dict of [G, A] tensors: "weight" (subtree weight sum),
    "utility_lcb" (white-perspective utility LCB), "radius" (utility LCB
    radius), "lcb" (the winrate-scale LCB of
    PlayUtils::getHackedLCBForWinrate, white perspective), "score_stdev"
    (subtree score stdev) and "exists"."""
    tree = result.ss.tree
    exists, good, w, self_u, radius, lcb = _child_lcb_radius(result, sp)
    pla = tree.pos.to_move[:, 0].unsqueeze(-1)
    white_lcb = torch.where(pla == B.WHITE, lcb, -lcb)
    c = tree.children[:, 0, :].long().clamp(min=0)

    def gat(col):
        return tree.stats[..., col].gather(1, c)

    winv = 1.0 / torch.clamp(w, min=1e-10)
    wl_avg = gat(C_WINLOSS_SUM) * winv
    sc_avg = gat(C_SCORE_MEAN_SUM) * winv
    scsq_avg = gat(C_SCORE_MEANSQ_SUM) * winv
    score_stdev = torch.sqrt(torch.clamp(scsq_avg - sc_avg * sc_avg,
                                         min=0.0))
    # winrate-scale LCB (playutils.cpp:345-361): the utility radius scaled
    # by how much winrate matters within utility, in the mover's direction
    hack = 0.5 * sp.win_loss_utility_factor / (
        sp.win_loss_utility_factor + sp.static_score_utility_factor
        + sp.dynamic_score_utility_factor + 1e-20)
    winrate = 0.5 * (1.0 + wl_avg)
    hacked = torch.where(pla == B.WHITE, winrate - radius * hack,
                         winrate + radius * hack)
    return {"weight": w, "utility_lcb": white_lcb, "radius": radius,
            "lcb": hacked, "score_stdev": score_stdev, "exists": good}


def _lcb_adjusted_selection_weights(result: SearchResult, sp):
    exists, good, w, self_u, radius, lcb = _child_lcb_radius(result, sp)
    psv = w
    gi = torch.arange(psv.shape[0], device=psv.device)
    best_w = psv.amax(dim=1, keepdim=True)
    eligible = good & (psv >= sp.min_visit_prop_for_lcb * best_w)
    lcb_elig = torch.where(eligible, lcb, -math.inf)
    best_idx = torch.argmax(lcb_elig, dim=1)
    best_lcb = lcb_elig[gi, best_idx].unsqueeze(-1)
    excess = best_lcb - lcb
    radius_factor = (radius + excess) / (radius + 0.20 * excess)
    lbound = torch.where(good & (excess >= 0),
                         radius_factor * radius_factor * psv, 0.0)
    bonus = lbound.amax(dim=1)
    any_elig = eligible.any(dim=1)
    new_best = torch.maximum(psv[gi, best_idx], bonus)
    psv_adj = psv.clone()
    psv_adj[gi, best_idx] = torch.where(any_elig, new_best, psv[gi, best_idx])
    return torch.where(sp.use_lcb_for_selection, psv_adj, psv)


def choose_moves(result: SearchResult, sp, move_nums,
                 gen: torch.Generator) -> torch.Tensor:
    """Temperature-based move choice from root edge weights (with the
    optional LCB adjustment); sampling uses the given generator."""
    psv = _lcb_adjusted_selection_weights(result, sp)
    has = result.child_visits > 0
    psv = torch.where(has, psv, 0.0)
    temp = sp.chosen_move_temperature + (
        sp.chosen_move_temperature_early - sp.chosen_move_temperature) * \
        torch.exp2(-move_nums.float() / sp.chosen_move_temperature_halflife)
    logv = torch.where(has, torch.log(torch.clamp(psv, min=1e-10)), -math.inf)
    maxlog = logv.amax(dim=1, keepdim=True)
    t = torch.clamp(temp, min=1e-4).unsqueeze(-1)
    logits = (logv - maxlog) / t
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=1e-20, max=1.0 - 1e-7)))
    sampled = torch.argmax(logits + gumbel, dim=1)
    greedy = torch.argmax(torch.where(has, psv, -1.0), dim=1)
    return torch.where(temp < 1e-3, greedy, sampled)
