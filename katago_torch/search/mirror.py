"""Anti-mirror-Go countering — port of katago_tpu/search/mirror.py
(reference cpp/search/searchmirror.cpp + search.h:470-492,
searchParams.antiMirror).

Mirror Go (the opponent point-reflecting our every move) exploits naive
MCTS; the reference (a) detects mirroring from the game's move history
(Search::updateMirroring), (b) boosts policy priors on the opponent
continuing to mirror and on our center-oriented refutations
(maybeApplyAntiMirrorPolicy), and (c) force-explores mirror replies and
center/tengen moves during PUCT so their true (bad-for-mirror) values
surface (maybeApplyAntiMirrorForcedExplore).

Detection is host-side numpy once per search over each game's move
history; the per-game verdict goes to the device as a small MirrorArrs,
and the in-tree adjustments are branchless [G, A] tensor math keyed off
each node's last move. A search given mirror=None runs none of it.

Deviations from the reference, kept from the JAX package:
  - isMirroringSinceSearchStart's full-path re-check is approximated by
    the per-node "this move mirrors the parent's last move" test;
  - isAdjacentToChain(center) / getNumLiberties(center) refinements are
    replaced by the distance<=2 test that subsumes adjacency.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from katago_torch.game import board as B


@dataclasses.dataclass
class MirrorArrs:
    """Per-game anti-mirror verdict, on the search's device."""
    mirroring: torch.Tensor      # bool[G]: opponent of root pla mirrors
    mirror_pla: torch.Tensor     # int64[G]: the mirroring player (0 if none)
    advantage: torch.Tensor      # float32[G] mirrorAdvantage
    center_err: torch.Tensor     # float32[G] mirrorCenterSymmetryError

    @staticmethod
    def none(g: int, device) -> "MirrorArrs":
        return MirrorArrs(
            mirroring=torch.zeros((g,), dtype=torch.bool, device=device),
            mirror_pla=torch.zeros((g,), dtype=torch.int64, device=device),
            advantage=torch.zeros((g,), device=device),
            center_err=torch.full((g,), 1e10, device=device))


def mirror_of(loc, size: int):
    """Point reflection (Location::getMirrorLoc); pass/invalid unchanged."""
    nn = size * size
    y = torch.div(loc, size, rounding_mode="floor")
    x = loc % size
    m = (size - 1 - y) * size + (size - 1 - x)
    return torch.where((loc >= 0) & (loc < nn), m, loc)


def center_loc(size: int) -> int:
    return (size // 2) * size + size // 2 if size % 2 == 1 else -1


def detect_game(moves: list[int], plas: list[int], root_pla: int,
                stones: np.ndarray, komi: float, scoring_area: bool,
                size: int, num_handicap: int = 0,
                handicap_bonus: int = 0) -> tuple[bool, float, float]:
    """Host-side updateMirroring for one game (searchmirror.cpp:10-83).

    moves/plas: the game's move history (flat locs, pass = size*size).
    stones: current board int[NN]. handicap_bonus: white's handicap
    compensation points under the game's whiteHandicapBonus rule.
    Returns (opponent_is_mirroring, mirror_advantage, center_symmetry_err).
    """
    nn = size * size
    mirror_count, total_count = 0, 0
    mirror_ewms, total_ewms = 0.0, 0.0
    last_was_mirror = False
    for i in range(1, len(moves)):
        if plas[i] != root_pla:
            last_was_mirror = False
            prev = moves[i - 1]
            if prev < nn and moves[i] == (
                    (size - 1 - prev // size) * size
                    + (size - 1 - prev % size)):
                mirror_count += 1
                mirror_ewms += 1
                last_was_mirror = True
            total_count += 1
            total_ewms += 1
            mirror_ewms *= 0.75
            total_ewms *= 0.75
    mirroring = (mirror_count >= 7.0 + 0.5 * total_count
                 and mirror_ewms >= 0.45 * total_ewms and last_was_mirror)

    advantage = 0.0
    mirror_pla = 3 - root_pla
    if mirroring:
        black_extra = 0.0
        if scoring_area:
            if num_handicap > 0:
                black_extra += num_handicap - 1
            black_gets_last = (size % 2 == 1) == (num_handicap == 0
                                                  or num_handicap % 2 == 1)
            if black_gets_last:
                black_extra += 1
        black_extra -= handicap_bonus
        advantage = (black_extra - komi if mirror_pla == B.BLACK
                     else komi - black_extra)

    center_err = 1e10
    if size >= 7:
        center_err = 0.0
        unmatched = 0
        half = size // 2
        for dy in range(-3, 4):
            for dx in range(-3, 4):
                y, x = half + dy, half + dx
                loc = y * size + x
                mloc = (size - 1 - y) * size + (size - 1 - x)
                if loc == mloc:
                    continue
                c0, c1 = int(stones[loc]), int(stones[mloc])
                if c0 == 3 - mirror_pla and c1 != mirror_pla:
                    center_err += 1.0
                if c0 == mirror_pla and c1 == 0:
                    unmatched += 1
        if center_err > 0.0:
            center_err += 0.2 * unmatched
        if center_err >= 1.0:
            center_err = 0.5 * center_err * (1.0 + center_err)
    return mirroring, advantage, center_err


def _board_xy(size: int, device):
    a = torch.arange(size * size, device=device)
    return torch.div(a, size, rounding_mode="floor"), a % size


def _legal_at(legal, loc, nn):
    """legal[g, loc[g]] where 0 <= loc < nn, else False."""
    a = legal.shape[1]
    got = legal.gather(1, loc.clamp(0, a - 1).unsqueeze(-1))[:, 0]
    return torch.where((loc < nn) & (loc >= 0), got, False)


def adjust_policy(pol, prev_loc, move_pla, depth_from_root, stones,
                  m_mirroring, m_pla, m_adv, root_pla, size: int):
    """maybeApplyAntiMirrorPolicy on prior vectors pol [G, A]
    (searchmirror.cpp:95-153): boost the opponent continuing the mirror
    and our center-oriented answers, discounted by sqrt depth. Every
    other argument is [G] (stones [G, NN])."""
    nn = size * size
    g, a = pol.shape
    dev = pol.device
    legal = pol >= 0
    cl = center_loc(size)
    actions = torch.arange(a, device=dev)

    # opponent-continues-to-mirror boost
    mloc = mirror_of(prev_loc, size)
    mloc_eff = torch.where(_legal_at(legal, mloc, nn), mloc, nn)
    if cl >= 0:
        is_difficult = (stones[:, cl] == m_pla) & (m_adv >= -0.5)
    else:
        is_difficult = torch.zeros((g,), dtype=torch.bool, device=dev)
    opp_w = torch.where(actions == mloc_eff.unsqueeze(-1),
                        torch.where(is_difficult, 3.0, 1.0).unsqueeze(-1),
                        0.0)
    opp_active = (move_pla == m_pla) & (prev_loc < nn) & (prev_loc >= 0)

    # our center-oriented boosts
    ys, xs = _board_xy(size, dev)
    lo, hi = (size - 1) // 2, size // 2
    central = (xs >= lo) & (xs <= hi) & (ys >= lo) & (ys <= hi)
    near_central = (xs >= lo - 1) & (xs <= hi + 1) & (ys >= lo - 1) & \
        (ys <= hi + 1)
    our_w_sp = torch.where(central, 0.3, torch.where(near_central, 0.05,
                                                     0.0))
    our_w_sp = our_w_sp.unsqueeze(0).expand(g, nn)
    if cl >= 0:
        cy, cx = cl // size, cl % size
        dist_sq = (ys - cy) ** 2 + (xs - cx) ** 2
        opp_holds_center = stones[:, cl] == (3 - move_pla)
        near = torch.where(dist_sq <= 2, 0.05,
                           torch.where(dist_sq <= 4, 0.03, 0.0))
        our_w_sp = torch.maximum(our_w_sp, torch.where(
            opp_holds_center.unsqueeze(-1), near, 0.0))
    our_w = torch.cat([our_w_sp, torch.zeros((g, 1), device=dev)], dim=1)
    our_active = move_pla == root_pla

    weight = torch.where(opp_active.unsqueeze(-1), opp_w,
                         torch.where(our_active.unsqueeze(-1), our_w, 0.0))
    weight = weight / (1.0 + torch.sqrt(
        depth_from_root.clamp(min=0).float())).unsqueeze(-1)
    boosted = pol + (1.0 - pol) * weight
    return torch.where(legal & m_mirroring.unsqueeze(-1), boosted, pol)


def puct_adjust(value_comp, actions_pol, prev_loc, node_pla, cw, total_cw,
                parent_util_self, stones, is_root,
                m_mirroring, m_pla, m_adv, m_err, root_pla, size: int):
    """maybeApplyAntiMirrorForcedExplore as a [G, A] addition to the
    self-perspective value component of PUCT (searchmirror.cpp:156-278).

    value_comp, actions_pol, cw: [G, A]; stones [G, NN]; the rest [G].
    Returns the adjusted value_comp."""
    nn = size * size
    a = value_comp.shape[1]
    dev = value_comp.device
    actions = torch.arange(a, device=dev)
    legal = actions_pol >= 0
    cl = center_loc(size)
    if cl < 0:  # even board: no center-based anti-mirror
        return value_comp

    cy, cx = cl // size, cl % size
    is_difficult = (stones[:, cl] == m_pla) & (m_adv >= -0.5)

    # ---- mirroring player dumping down the mirror reply ----
    mloc = mirror_of(prev_loc, size)
    mloc_eff = torch.where(_legal_at(legal, mloc, nn), mloc, nn)
    my = torch.div(mloc_eff, size, rounding_mode="floor")
    mdist_sq = ((my - cy) ** 2 + (mloc_eff % size - cx) ** 2).float()
    dump_d = torch.clamp(1.0 / (0.75 + 0.5 * torch.sqrt(mdist_sq))
                         / torch.clamp(m_err, min=1.0), min=0.20)
    dump = torch.where(is_difficult, dump_d,
                       torch.where(m_adv >= 5.0, 0.15,
                                   torch.where(m_adv >= -5.0, 0.10 + m_adv,
                                               0.05)))
    bias = torch.where(is_difficult, 0.75,
                       torch.where(m_adv >= 5.0, 0.50,
                                   torch.where(m_adv >= -5.0,
                                               0.30 + m_adv * 4.0, 0.10)))
    pass_scale = torch.where(
        mloc_eff == nn, 0.35 / torch.clamp(torch.sqrt(m_err), min=1.0), 1.0)
    dump = dump * pass_scale
    err_div = torch.where(m_err >= 1.0, m_err, 1.0)
    dump, bias = dump / err_div, bias / err_div

    pu2 = torch.clamp(1.0 - 0.7 * parent_util_self * parent_util_self,
                      min=0.3)
    is_mirror_move = actions == mloc_eff.unsqueeze(-1)
    opp_case = m_mirroring & (node_pla == m_pla) & (prev_loc >= 0) & \
        (prev_loc < nn)
    tcw = total_cw.unsqueeze(-1)
    add_opp = (torch.where(cw < (dump * total_cw).unsqueeze(-1), 100.0, 0.0)
               + torch.where(cw < (bias * total_cw).unsqueeze(-1),
                             (0.18 * pu2).unsqueeze(-1), 0.0)
               + torch.where(cw < (0.5 * bias * total_cw).unsqueeze(-1),
                             (0.36 * pu2).unsqueeze(-1), 0.0))
    adj = torch.where(opp_case.unsqueeze(-1) & is_mirror_move, add_opp, 0.0)

    # ---- root player force-exploring center refutations ----
    ys, xs = _board_xy(size, dev)
    dist_sq = ((ys - cy) ** 2 + (xs - cx) ** 2).float()
    dump_r_sp = torch.where(
        is_difficult.unsqueeze(-1),
        torch.where(dist_sq <= 2, 0.010, torch.where(dist_sq <= 4, 0.005,
                                                     0.0)), 0.0)
    dump_r_sp = torch.where(actions[:nn] == cl,
                            torch.where(is_root, 0.06, 0.12).unsqueeze(-1),
                            dump_r_sp)
    dump_r = torch.cat([dump_r_sp, torch.zeros_like(dump_r_sp[:, :1])], 1)
    # dampen by utility loss (searchmirror.cpp:258-260)
    util_loss = parent_util_self.unsqueeze(-1) - value_comp
    over = (util_loss > 0) & (util_loss * dump_r > 0.03)
    dump_r = torch.where(
        over, dump_r + 0.5 * (0.03 / torch.clamp(util_loss, min=1e-9)
                              - dump_r), dump_r)
    # scale down when the opponent's last move was already central
    py = torch.div(prev_loc, size, rounding_mode="floor")
    pdist_sq = ((py - cy) ** 2 + (prev_loc % size - cx) ** 2).float()
    prev_on_board = (prev_loc >= 0) & (prev_loc < nn)
    scale = torch.where(prev_on_board & (pdist_sq <= 16), 0.900, 1.0)
    scale = scale * torch.where(prev_on_board & (pdist_sq <= 5), 0.825, 1.0)
    scale = scale * torch.where(prev_on_board & (pdist_sq <= 2), 0.750, 1.0)
    dump_r = dump_r * scale.unsqueeze(-1)
    our_case = m_mirroring & (node_pla == root_pla)
    adj = adj + torch.where(our_case.unsqueeze(-1) & (cw < dump_r * tcw)
                            & legal & (actions < nn), 100.0, 0.0)
    return value_comp + torch.where(legal, adj, 0.0)
