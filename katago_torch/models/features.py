"""Input featurizer — port of katago_tpu/models/features.py, batched
over games. Reference: KataGo NNInputs::fillRowV7
(nninputs.cpp:2300-2740): 22 spatial binary planes + 19 global floats
from the perspective of the player to move, and the older versions V3-V6
derived from them (`fill_features`). See the JAX module docstring for
the plane and global maps.

Ladder planes 14-17 come from the exact backtracking solver
(ladder_mode "exact", the JAX default: per-move and data-writing
featurization) or the greedy chase (ladder_mode "chase": the search
evaluator's).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from katago_torch.game import benson
from katago_torch.game import board as B
from katago_torch.game import history as H
from katago_torch.game import ladder
from katago_torch.game import rules as R

NUM_SPATIAL_V7 = 22
NUM_GLOBAL_V7 = 19
KOMI_CLIP_RADIUS = 20.0


@dataclasses.dataclass
class FeatureParams:
    """Per-eval knobs (MiscNNInputParams) as 0-dim tensors."""
    draw_equiv_wins_for_white: torch.Tensor   # float32
    playout_doubling_advantage: torch.Tensor  # float32
    conservative_pass: torch.Tensor           # bool

    @staticmethod
    def default(device) -> "FeatureParams":
        return FeatureParams(
            torch.tensor(0.5, device=device), torch.tensor(0.0, device=device),
            torch.tensor(False, device=device))


def self_komi(gs: H.GameState, params: FeatureParams) -> torch.Tensor:
    """currentSelfKomi: komi + white bonus from the mover's perspective,
    with the draw-utility fold. float32[G]."""
    komi = gs.rules.komi + gs.pos.white_bonus
    komi_is_int = gs.rules.komi == torch.round(gs.rules.komi)
    result_int = komi_is_int != gs.rules.has_button
    draw_adj = torch.where(result_int,
                           params.draw_equiv_wins_for_white - 0.5,
                           torch.zeros((), device=komi.device))
    white_komi = komi + draw_adj
    return torch.where(gs.to_move == B.WHITE, white_komi, -white_komi)


def fill_features_v7(gs: H.GameState, size: int, params: FeatureParams,
                     legal_full: torch.Tensor | None = None,
                     with_ladders: bool = True,
                     ladder_mode: str = "exact",
                     prev_laddered=None, prev_prev_laddered=None,
                     cur_ladder: ladder.LadderResult | None = None,
                     ladder_stats: dict | None = None):
    """(spatial float32[G, NN, 22], global float32[G, 19]) for each game's
    player to move. prev_laddered / prev_prev_laddered: cached ladder
    masks of the boards one and two moves ago (the search's per-node
    cache); cur_ladder: a precomputed LadderResult of the current boards.
    Without cached masks the current, previous and pre-previous boards
    of every game are solved in one batched call. ladder_stats: passed to
    the exact solver (ladder.ladder_map_batch's stats)."""
    solve = ladder.batch_solver(ladder_mode)
    if ladder_mode == "exact":
        solve = functools.partial(solve, stats=ladder_stats)
    nn = size * size
    dev = gs.board.stones.device
    g = gs.board.stones.shape[0]
    stones = gs.board.stones
    pla = gs.to_move
    opp = B.opponent(pla)
    pl1 = pla.unsqueeze(-1)
    op1 = opp.unsqueeze(-1)
    f32 = torch.float32

    labels = B.connected_labels(stones, size)
    libs = B.chain_liberties(stones, labels, size)
    planes = [None] * NUM_SPATIAL_V7
    gl = [None] * NUM_GLOBAL_V7
    zero_plane = torch.zeros((g, nn), dtype=f32, device=dev)

    onboard = stones != B.WALL
    planes[0] = onboard.to(f32)
    planes[1] = (stones == pl1).to(f32)
    planes[2] = (stones == op1).to(f32)
    occupied = stones != B.EMPTY
    planes[3] = (occupied & (libs == 1)).to(f32)
    planes[4] = (occupied & (libs == 2)).to(f32)
    planes[5] = (occupied & (libs == 3)).to(f32)

    board_no_ko = dataclasses.replace(gs.board,
                                      ko_loc=torch.full_like(gs.board.ko_loc,
                                                             -1))
    basic_no_ko = B.legal_moves_basic(board_no_ko, pla,
                                      gs.rules.multi_suicide, size)
    if legal_full is None:
        legal_full = H.legal_moves(gs, size)
    full = legal_full[:, :nn]
    planes[6] = (basic_no_ko & ~full & ~gs.game_over.unsqueeze(-1)).to(f32)
    planes[7] = gs.pos.ko_recap_blocked.to(f32)
    planes[8] = zero_plane

    in_encore = gs.pos.encore_phase > 0
    ko = gs.rules.ko_rule
    pass_counts = in_encore | (ko != R.KO_SPIGHT)
    kh_now = H._pos_ko_hash(gs.pos, gs.rules)
    spight_phase = in_encore | (ko == R.KO_SIMPLE) | (ko == R.KO_SPIGHT)
    is_black_mover = pla == B.BLACK
    ring = torch.where(is_black_mover.reshape(-1, 1, 1), gs.pass_hash_black,
                       gs.pass_hash_white)
    ring_n = torch.where(is_black_mover, gs.pass_hash_black_n,
                         gs.pass_hash_white_n)
    ring_valid = torch.arange(H.MAX_PASS_HASHES, device=dev) < \
        ring_n.unsqueeze(-1)
    spightlike = spight_phase & (H.hash_eq(ring, kh_now.unsqueeze(1))
                                 & ring_valid).any(dim=-1)
    pass_would_end_phase = (((pass_counts & (gs.consec_passes >= 1))
                             | spightlike) & ~gs.game_over)
    is_area_rules = gs.rules.scoring_rule == R.SCORING_AREA
    pass_would_end_game = pass_would_end_phase & (
        is_area_rules | (gs.pos.encore_phase >= 2))
    friendly_suppress = (gs.rules.friendly_pass_ok & is_area_rules
                         & pass_counts & (gs.consec_passes == 1)
                         & ~spightlike & ~gs.game_over)
    suppress_pass_end = pass_would_end_game & (params.conservative_pass
                                               | friendly_suppress)
    max_turns = torch.where(suppress_pass_end, 0,
                            torch.where(gs.game_over, 1, 5))
    amount = torch.minimum(max_turns, gs.pos.turns_this_phase)

    gi = torch.arange(g, device=dev)
    for k in range(5):
        mv = gs.recent_moves[:, k]
        have = (amount > k) & (gs.move_num > k)
        is_pass = have & (mv >= nn)
        on_board = have & (mv >= 0) & (mv < nn)
        plane = torch.zeros((g, nn + 1), dtype=f32, device=dev)
        plane[gi, mv.clamp(0, nn)] = on_board.to(f32)
        planes[9 + k] = plane[:, :nn]
        gl[k] = is_pass.to(f32)

    if with_ladders:
        if prev_laddered is not None:
            lad = cur_ladder if cur_ladder is not None else \
                solve(stones, size, ko_loc=gs.pos.simple_ko_loc)
            lad15 = torch.where((amount >= 1).unsqueeze(-1), prev_laddered,
                                lad.laddered)
            lad16 = torch.where((amount >= 2).unsqueeze(-1),
                                prev_prev_laddered, lad15)
        else:
            a1 = (amount >= 1).unsqueeze(-1)
            a2 = (amount >= 2).unsqueeze(-1)
            prev = torch.where(a1, gs.pos.prev_stones.to(stones.dtype),
                               stones)
            prev_ko = torch.where(amount >= 1, gs.pos.prev_ko_loc,
                                  gs.pos.simple_ko_loc)
            pp = torch.where(a2, gs.pos.prev_prev_stones.to(stones.dtype),
                             prev)
            pp_ko = torch.where(amount >= 2, gs.pos.prev_prev_ko_loc, prev_ko)
            # one batched solve over {current, prev, prev-prev}
            lad3 = solve(
                torch.cat([stones, prev, pp]), size,
                ko_loc=torch.cat([gs.pos.simple_ko_loc, prev_ko, pp_ko]))
            lad = ladder.LadderResult(*(getattr(lad3, f.name)[:g] for f in
                                        dataclasses.fields(lad3)))
            lad15 = lad3.laddered[g:2 * g]
            lad16 = lad3.laddered[2 * g:]
        planes[14] = lad.laddered.to(f32)
        planes[15] = lad15.to(f32)
        planes[16] = lad16.to(f32)
        working = torch.where((opp == B.BLACK).unsqueeze(-1),
                              lad.working_vs_black, lad.working_vs_white)
        planes[17] = working.to(f32)
    else:
        for k in range(14, 18):
            planes[k] = zero_plane

    is_area_scoring = gs.rules.scoring_rule == R.SCORING_AREA
    tax_none = gs.rules.tax_rule == R.TAX_NONE
    in_encore2 = gs.pos.encore_phase >= 2
    area_plain = benson.calculate_area(stones, size, True, True, True,
                                       gs.rules.multi_suicide)
    keep_territories = ~is_area_scoring & tax_none
    keep_stones = is_area_scoring & ~tax_none
    area_il, _ = benson.calculate_independent_life_area(
        stones, size, keep_territories=keep_territories,
        keep_stones=keep_stones, suicide_legal=gs.rules.multi_suicide)
    area = torch.where((is_area_scoring & tax_none).unsqueeze(-1),
                       area_plain, area_il)
    has_area = (is_area_scoring | in_encore2).unsqueeze(-1)
    ses = gs.pos.second_encore_start.long()
    terr_rules = (~is_area_scoring).unsqueeze(-1)
    pla_terr = (area == pl1) | (terr_rules & (area == B.EMPTY)
                                & (stones == pl1) & (ses == pl1))
    opp_terr = (area == op1) | (terr_rules & (area == B.EMPTY)
                                & (stones == op1) & (ses == op1))
    planes[18] = (has_area & pla_terr).to(f32)
    planes[19] = (has_area & opp_terr).to(f32)
    enc2 = in_encore2.unsqueeze(-1)
    planes[20] = (enc2 & (ses == pl1)).to(f32)
    planes[21] = (enc2 & (ses == op1)).to(f32)

    sk = self_komi(gs, params)
    b_area = onboard.to(f32).sum(dim=-1)
    sk = torch.clamp(sk, -b_area - KOMI_CLIP_RADIUS, b_area + KOMI_CLIP_RADIUS)
    gl[5] = sk * 0.05   # XLA folds the JAX package's sk / 20 into this
    is_pos_like = (ko == R.KO_POSITIONAL) | (ko == R.KO_SPIGHT)
    is_sit = ko == R.KO_SITUATIONAL
    gl[6] = (is_pos_like | is_sit).to(f32)
    gl[7] = torch.where(is_pos_like, 0.5, torch.where(is_sit, -0.5, 0.0))
    gl[8] = gs.rules.multi_suicide.to(f32)
    gl[9] = (gs.rules.scoring_rule == R.SCORING_TERRITORY).to(f32)
    tax = gs.rules.tax_rule
    gl[10] = ((tax == R.TAX_SEKI) | (tax == R.TAX_ALL)).to(f32)
    gl[11] = (tax == R.TAX_ALL).to(f32)
    gl[12] = (gs.pos.encore_phase > 0).to(f32)
    gl[13] = (gs.pos.encore_phase > 1).to(f32)
    gl[14] = (pass_would_end_phase & ~suppress_pass_end).to(f32)
    pda = params.playout_doubling_advantage
    gl[15] = (pda != 0.0).to(f32).expand(g)
    gl[16] = (0.5 * pda).expand(g)
    gl[17] = (gs.rules.has_button & ~gs.button_taken).to(f32)
    area_scoring = (gs.rules.scoring_rule == R.SCORING_AREA) | in_encore2
    drawable_even = (onboard.sum(dim=-1) % 2) == 0
    komi_floor = torch.where(drawable_even,
                             torch.floor(sk / 2.0) * 2.0,
                             torch.floor((sk - 1.0) / 2.0) * 2.0 + 1.0)
    delta = torch.clamp(sk - komi_floor, 0.0, 2.0)
    wave = torch.where(delta < 0.5, delta,
                       torch.where(delta < 1.5, 1.0 - delta, delta - 2.0))
    gl[18] = torch.where(area_scoring, wave, 0.0)
    return torch.stack(planes, dim=-1), torch.stack(gl, dim=-1)


# Older input-feature versions (modelversion.cpp getInputsVersion):
# model v3/v4 -> inputs V3, v5 -> V4, v6 -> V5, v7 -> V6, v8+ -> V7.
# V3/V4/V6 share V7's 22-plane spatial layout with different territory
# semantics on planes 18/19 (fillRowV3 nninputs.cpp:1145, fillRowV4
# "pass-alive only" nninputs.cpp:1490, fillRowV6 nninputs.cpp:1935); V5
# is the reduced 13-plane set (fillRowV5 nninputs.cpp:1649: no ko-ban or
# ladder planes, history at 6-10, second-encore stones at 11/12).
# Globals are subsets or permutations of V7's with komi scaled /15
# before V6.

NUM_SPATIAL_BY_VERSION = {3: 22, 4: 22, 5: 13, 6: 22, 7: NUM_SPATIAL_V7}
NUM_GLOBAL_BY_VERSION = {3: 14, 4: 14, 5: 12, 6: 16, 7: NUM_GLOBAL_V7}


def fill_features(gs: H.GameState, size: int, params: FeatureParams,
                  legal: torch.Tensor, *, version: int = 7,
                  with_ladders: bool = True, ladder_mode: str = "exact",
                  prev_laddered=None, prev_prev_laddered=None,
                  cur_ladder=None, ladder_stats: dict | None = None):
    """Versioned featurizer: V3..V7 (spatial float32[G, NN, C],
    global float32[G, Cg]) rows, C and Cg per version."""
    if version not in NUM_SPATIAL_BY_VERSION:
        raise ValueError(f"unsupported input-features version {version}")
    sp, gl = fill_features_v7(gs, size, params, legal,
                              with_ladders=(with_ladders and version != 5),
                              ladder_mode=ladder_mode,
                              prev_laddered=prev_laddered,
                              prev_prev_laddered=prev_prev_laddered,
                              cur_ladder=cur_ladder,
                              ladder_stats=ladder_stats)
    if version == 7:
        return sp, gl
    if version in (3, 4):
        # planes 18/19: V3 = scoring-dependent plain area (area scoring:
        # all stones and territories; territory scoring: pass-alive and
        # safe big territories only); V4 = always the pass-alive recipe
        pla = gs.to_move.unsqueeze(-1)
        opp = B.opponent(gs.to_move).unsqueeze(-1)
        is_area = gs.rules.scoring_rule == R.SCORING_AREA
        non_pass_alive = False if version == 4 else is_area
        area = benson.calculate_area(gs.board.stones, size, non_pass_alive,
                                     True, non_pass_alive,
                                     gs.rules.multi_suicide)
        sp = sp.clone()
        sp[..., 18] = (area == pla).float()
        sp[..., 19] = (area == opp).float()
    if version == 5:
        # [0-5 board/libs][6-10 prev moves 1-5][11,12 second-encore]
        sp = torch.cat([sp[..., 0:6], sp[..., 9:14], sp[..., 20:22]], dim=-1)
    # V3/V4/V5 scale selfKomi by /15 (JAX's * 20 / 15, as XLA folds it)
    komi15 = gl[:, 5:6] * (20.0 / 15.0)
    if version in (3, 4):
        gl = torch.cat([gl[:, 0:5], komi15, gl[:, 6:10],
                        gl[:, 12:14],     # encore phase flags
                        gl[:, 14:15],     # passWouldEndPhase
                        gl[:, 18:19]],    # komi parity wave
                       dim=-1)
    elif version == 5:
        gl = torch.cat([gl[:, 0:5], komi15, gl[:, 6:10], gl[:, 12:14]],
                       dim=-1)
    else:   # version 6: V7 minus pda (15, 16) and button (17), wave at 15
        gl = torch.cat([gl[:, 0:15], gl[:, 18:19]], dim=-1)
    return sp, gl
