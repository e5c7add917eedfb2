"""Game history layer: superko, passes, game end, scoring — port of
katago_tpu/game/history.py, batched over games.

PosState holds one position per game (everything a search node stores);
GameState adds the rules and the superko ko-hash ring. Every function
takes [G]-batched dataclasses of tensors and matches the JAX package's
per-game function under vmap, field for field (hashes as int64 uint32
lanes, see game/zobrist.py).
"""

from __future__ import annotations

import dataclasses

import torch

from katago_torch import _tensortree as T
from katago_torch.device import resolve_device
from katago_torch.game import benson
from katago_torch.game import board as B
from katago_torch.game import rules as R
from katago_torch.game import zobrist

MAX_ENCORE_KO_CAPS = 8
MAX_PASS_HASHES = 16


@dataclasses.dataclass
class RulesArr:
    """Per-game rules tensors ([G] each)."""
    ko_rule: torch.Tensor
    scoring_rule: torch.Tensor
    tax_rule: torch.Tensor
    multi_suicide: torch.Tensor     # bool
    has_button: torch.Tensor        # bool
    friendly_pass_ok: torch.Tensor  # bool
    komi: torch.Tensor              # float32 (white handicap bonus folded in)

    @staticmethod
    def from_rules(rules: R.Rules, g: int = 1, device=None,
                   num_handicap: int = 0) -> "RulesArr":
        dev = resolve_device(device)
        komi = rules.komi
        if rules.white_handicap_bonus_rule == R.WHB_N:
            komi += num_handicap
        elif (rules.white_handicap_bonus_rule == R.WHB_N_MINUS_ONE
              and num_handicap > 0):
            komi += num_handicap - 1

        def full(v, dt):
            return torch.full((g,), v, dtype=dt, device=dev)

        return RulesArr(
            ko_rule=full(rules.ko_rule, torch.int64),
            scoring_rule=full(rules.scoring_rule, torch.int64),
            tax_rule=full(rules.tax_rule, torch.int64),
            multi_suicide=full(rules.multi_stone_suicide_legal, torch.bool),
            has_button=full(rules.has_button, torch.bool),
            friendly_pass_ok=full(rules.friendly_pass_ok, torch.bool),
            komi=full(komi, torch.float32))


@dataclasses.dataclass
class PosState:
    """One position + per-position bookkeeping, [G]-batched."""
    board: B.BoardState
    to_move: torch.Tensor            # int64 1/2
    move_num: torch.Tensor           # int64
    consec_passes: torch.Tensor      # int64
    button_taken: torch.Tensor       # bool
    button_for: torch.Tensor         # int64
    game_over: torch.Tensor          # bool
    recent_moves: torch.Tensor       # int64[G, 8], most recent first
    turns_this_phase: torch.Tensor   # int64
    simple_ko_loc: torch.Tensor      # int64
    prev_stones: torch.Tensor        # int8[G, NN]
    prev_prev_stones: torch.Tensor   # int8[G, NN]
    prev_ko_loc: torch.Tensor        # int64
    prev_prev_ko_loc: torch.Tensor   # int64
    encore_phase: torch.Tensor       # int64
    ko_recap_blocked: torch.Tensor   # bool[G, NN]
    ko_recap_block_hash: torch.Tensor  # int64[G, 2]
    second_encore_start: torch.Tensor  # int8[G, NN]
    white_bonus: torch.Tensor        # float32
    is_no_result: torch.Tensor       # bool
    ko_cap_hash: torch.Tensor        # int64[G, E, 2]
    ko_cap_loc: torch.Tensor         # int64[G, E]
    ko_cap_pla: torch.Tensor         # int64[G, E]
    ko_cap_n: torch.Tensor           # int64


@dataclasses.dataclass
class GameState:
    pos: PosState
    rules: RulesArr
    ko_hash_hist: torch.Tensor       # int64[G, MAX_HIST, 2]
    hist_len: torch.Tensor           # int64[G]
    pass_hash_black: torch.Tensor    # int64[G, P, 2]
    pass_hash_black_n: torch.Tensor
    pass_hash_white: torch.Tensor
    pass_hash_white_n: torch.Tensor

    @property
    def board(self):
        return self.pos.board

    @property
    def to_move(self):
        return self.pos.to_move

    @property
    def move_num(self):
        return self.pos.move_num

    @property
    def consec_passes(self):
        return self.pos.consec_passes

    @property
    def button_taken(self):
        return self.pos.button_taken

    @property
    def game_over(self):
        return self.pos.game_over

    @property
    def recent_moves(self):
        return self.pos.recent_moves

    @property
    def encore_phase(self):
        return self.pos.encore_phase


def _lanes(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Broadcast a [G] or [G, 2] per-game value against ref [G, ..., 2]."""
    if x.dim() == 1:
        return x.reshape((-1,) + (1,) * (ref.dim() - 1))
    return x.reshape((x.shape[0],) + (1,) * (ref.dim() - 2) + (x.shape[-1],))


def _ko_hash(pos_hash, to_move_next, ko_rule, encore_phase=None,
             ko_recap_block_hash=None):
    """Superko / repetition hash (getKoHash): position hash, the mover key
    under situational ko, encore phase key and ko-recap-block marks.
    pos_hash [G, ..., 2]; the others per game."""
    dev = pos_hash.device
    zpl = zobrist.player_table(dev)
    situational = ko_rule == R.KO_SITUATIONAL
    h = torch.where(_lanes(situational, pos_hash),
                    pos_hash ^ _lanes(zpl[to_move_next - 1], pos_hash),
                    pos_hash)
    if encore_phase is not None:
        zen = zobrist.encore_table(dev)
        h = h ^ _lanes(zen[encore_phase.clamp(0, 2)], pos_hash)
    if ko_recap_block_hash is not None:
        h = h ^ _lanes(ko_recap_block_hash, pos_hash)
    return h


def _pos_ko_hash(pos: PosState, rules: RulesArr) -> torch.Tensor:
    return _ko_hash(pos.board.pos_hash, pos.to_move, rules.ko_rule,
                    pos.encore_phase, pos.ko_recap_block_hash)


def hash_eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Equality of broadcastable [..., 2] hashes -> bool[...]."""
    return (a[..., 0] == b[..., 0]) & (a[..., 1] == b[..., 1])


def new_pos(size: int, g: int = 1, device=None,
            shape_mask=None) -> PosState:
    """shape_mask: optional bool[NN] on-board mask for rectangular boards;
    off-shape cells hold WALL stones, which behave like the board edge."""
    dev = resolve_device(device)
    nn = size * size
    e = MAX_ENCORE_KO_CAPS
    board = B.empty_board(size, g, dev)
    if shape_mask is not None:
        board.stones = torch.where(
            torch.as_tensor(shape_mask, device=dev), board.stones,
            torch.full_like(board.stones, B.WALL))

    def full(shape, v, dt):
        return torch.full(shape, v, dtype=dt, device=dev)

    i64, boo = torch.int64, torch.bool
    return PosState(
        board=board,
        to_move=full((g,), B.BLACK, i64),
        move_num=full((g,), 0, i64),
        consec_passes=full((g,), 0, i64),
        button_taken=full((g,), False, boo),
        button_for=full((g,), 0, i64),
        game_over=full((g,), False, boo),
        recent_moves=full((g, 8), -1, i64),
        turns_this_phase=full((g,), 0, i64),
        simple_ko_loc=full((g,), -1, i64),
        prev_stones=board.stones.to(torch.int8),
        prev_prev_stones=board.stones.to(torch.int8),
        prev_ko_loc=full((g,), -1, i64),
        prev_prev_ko_loc=full((g,), -1, i64),
        encore_phase=full((g,), 0, i64),
        ko_recap_blocked=full((g, nn), False, boo),
        ko_recap_block_hash=full((g, 2), 0, i64),
        second_encore_start=full((g, nn), 0, torch.int8),
        white_bonus=full((g,), 0.0, torch.float32),
        is_no_result=full((g,), False, boo),
        ko_cap_hash=full((g, e, 2), 0, i64),
        ko_cap_loc=full((g, e), -1, i64),
        ko_cap_pla=full((g, e), 0, i64),
        ko_cap_n=full((g,), 0, i64))


def new_game(size: int, rules, max_hist: int, g: int = 1,
             device=None, shape_mask=None) -> GameState:
    """A batch of g fresh games. rules: a Rules (same for every game) or a
    RulesArr of batch g (its device wins). shape_mask: see new_pos."""
    if isinstance(rules, R.Rules):
        rules = RulesArr.from_rules(rules, g, device)
    dev = rules.komi.device
    pos = new_pos(size, g, dev, shape_mask)
    hist = torch.zeros((g, max_hist, 2), dtype=torch.int64, device=dev)
    hist[:, 0] = _pos_ko_hash(pos, rules)
    p = MAX_PASS_HASHES
    zeros = torch.zeros((g,), dtype=torch.int64, device=dev)
    return GameState(
        pos=pos, rules=rules, ko_hash_hist=hist,
        hist_len=torch.ones((g,), dtype=torch.int64, device=dev),
        pass_hash_black=torch.zeros((g, p, 2), dtype=torch.int64,
                                    device=dev),
        pass_hash_black_n=zeros.clone(),
        pass_hash_white=torch.zeros((g, p, 2), dtype=torch.int64,
                                    device=dev),
        pass_hash_white_n=zeros.clone())


def _ko_capture_loc(stones, libs, chain_size, loc, player, size):
    """Board::getKoCaptureLoc per (game, candidate): loc int[G, K] in
    [0, NN) -> the lone atari stone a ko-shaped capture at loc would take,
    else -1."""
    nn = size * size
    dev = stones.device
    g, k = loc.shape
    neigh = B.neighbor_table(size, dev)[loc]                      # [G,K,4]
    flat = neigh.reshape(g, -1)
    opp = B.opponent(player).reshape(-1, 1, 1)
    on = neigh < nn
    nbr_s = B.pad_last(stones, B.WALL).gather(1, flat).reshape(g, k, 4)
    nbr_l = B.pad_last(libs, 0).gather(1, flat).reshape(g, k, 4)
    all_opp_or_wall = (~on | (nbr_s == opp)).all(dim=-1)
    capturable = on & (nbr_s == opp) & (nbr_l == 1)
    one_cap = capturable.sum(dim=-1) == 1
    cap = neigh.gather(-1, B.first_true(capturable).unsqueeze(-1))[..., 0]
    cap_sz = B.pad_last(chain_size, 0).gather(1, cap)
    ok = (stones.gather(1, loc) == B.EMPTY) & all_opp_or_wall & one_cap & \
        (cap_sz == 1)
    return torch.where(ok, cap, -1)


def _chain_sizes(stones, labels, nn):
    occupied = stones != B.EMPTY
    counts = B.bincount_rows(torch.where(occupied, labels, -1), nn)
    return torch.where(occupied, counts.gather(1, labels), 0)


def step_pos(pos: PosState, rules: RulesArr, loc: torch.Tensor, size: int,
             spightlike_ending_pass=None):
    """Play loc[G] (NN = pass) for each game's player to move; assumed
    legal. Returns (new PosState, MoveInfo, new ko hash [G, 2]). Stepping
    a finished game is a masked no-op."""
    nn = size * size
    dev = pos.board.stones.device
    g = pos.to_move.shape[0]
    gi = torch.arange(g, device=dev)
    kmt = zobrist.ko_mark_table(size, dev)                      # [NN+1, 2]
    was_over = pos.game_over
    loc_eff = torch.where(was_over, nn, loc.long())
    player = pos.to_move
    opp = B.opponent(player)
    in_encore = pos.encore_phase > 0
    is_pass_move = loc_eff >= nn
    lc = loc_eff.clamp(0, nn - 1)
    if spightlike_ending_pass is None:
        spightlike_ending_pass = torch.zeros_like(was_over)

    stones = pos.board.stones
    labels = B.connected_labels(stones, size)
    libs = B.chain_liberties(stones, labels, size)
    sizes = _chain_sizes(stones, labels, nn)
    live_play = in_encore & ~is_pass_move & ~was_over
    case_a = (live_play & (stones[gi, lc] == opp)
              & pos.ko_recap_blocked[gi, lc] & (sizes[gi, lc] == 1)
              & (libs[gi, lc] == 1))
    kcl = _ko_capture_loc(stones, libs, sizes, lc.unsqueeze(-1), player,
                          size)[:, 0]
    kcl_c = kcl.clamp(0, nn - 1)
    case_b = (live_play & ~case_a & (kcl >= 0)
              & pos.ko_recap_blocked[gi, kcl_c] & (stones[gi, kcl_c] == opp))
    pass_for_ko = case_a | case_b
    lift_loc = torch.where(case_a, lc, torch.where(case_b, kcl_c, nn))

    play_loc = torch.where(pass_for_ko, nn, loc_eff)
    new_board, info = B.play_move(pos.board, play_loc, player, size)
    info.is_pass = is_pass_move

    recap = pos.ko_recap_blocked.clone()
    ll = lift_loc.clamp(max=nn - 1)
    recap[gi, ll] = torch.where(pass_for_ko, False, recap[gi, ll])
    recap_hash = pos.ko_recap_block_hash ^ torch.where(
        pass_for_ko.unsqueeze(-1), kmt[lift_loc], 0)
    was_ko_cap = live_play & ~pass_for_ko & (new_board.ko_loc >= 0)
    recap[gi, lc] = torch.where(was_ko_cap, True, recap[gi, lc])
    recap_hash = recap_hash ^ torch.where(was_ko_cap.unsqueeze(-1),
                                          kmt[lc], 0)
    e = MAX_ENCORE_KO_CAPS
    slot = pos.ko_cap_n % e
    ko_cap_hash = pos.ko_cap_hash.clone()
    ko_cap_hash[gi, slot] = torch.where(was_ko_cap.unsqueeze(-1),
                                        pos.board.pos_hash,
                                        ko_cap_hash[gi, slot])
    ko_cap_loc = pos.ko_cap_loc.clone()
    ko_cap_loc[gi, slot] = torch.where(was_ko_cap, lc, ko_cap_loc[gi, slot])
    ko_cap_pla = pos.ko_cap_pla.clone()
    ko_cap_pla[gi, slot] = torch.where(was_ko_cap, player,
                                       ko_cap_pla[gi, slot])
    ko_cap_n = pos.ko_cap_n + was_ko_cap.long()
    simple_ko_loc = torch.where(pass_for_ko, -1, new_board.ko_loc)
    new_board.ko_loc = torch.where(in_encore, -1, new_board.ko_loc)
    now_empty = new_board.stones == B.EMPTY
    to_unmark = recap & now_empty & in_encore.unsqueeze(-1)
    recap_hash = recap_hash ^ zobrist.xor_reduce_masked(
        kmt[:nn].expand(g, nn, 2), to_unmark)
    recap = recap & ~to_unmark

    claims_button = (rules.has_button
                     & (rules.scoring_rule == R.SCORING_AREA)
                     & is_pass_move & ~pos.button_taken & ~was_over
                     & ~in_encore)
    button_taken = pos.button_taken | claims_button
    button_for = torch.where(claims_button, player, pos.button_for)
    pass_counts = in_encore | (rules.ko_rule != R.KO_SPIGHT)
    consec = torch.where(
        is_pass_move & ~claims_button,
        torch.where(pass_counts, pos.consec_passes + 1, 0), 0)
    ending = (~was_over & is_pass_move & ~claims_button
              & ((consec >= 2) | spightlike_ending_pass))

    chill = ((rules.scoring_rule == R.SCORING_TERRITORY)
             & (pos.encore_phase <= 1) & ~is_pass_move & ~pass_for_ko
             & ~was_over)
    white_bonus = pos.white_bonus + torch.where(
        chill, torch.where(player == B.BLACK, 1.0, -1.0), 0.0)
    white_bonus = white_bonus + torch.where(
        claims_button, torch.where(player == B.WHITE, 0.5, -0.5), 0.0)

    is_area = rules.scoring_rule == R.SCORING_AREA
    end_now = ending & (is_area | (pos.encore_phase >= 2))
    advance = ending & ~is_area & (pos.encore_phase < 2)
    encore2 = pos.encore_phase + advance.long()
    recap = recap & ~advance.unsqueeze(-1)
    recap_hash = torch.where(advance.unsqueeze(-1), 0, recap_hash)
    ko_cap_n = torch.where(advance, 0, ko_cap_n)
    ko_cap_loc = torch.where(advance.unsqueeze(-1), -1, ko_cap_loc)
    consec = torch.where(advance, 0, consec)
    entered_2 = advance & (encore2 == 2)
    second_start = torch.where(entered_2.unsqueeze(-1),
                               new_board.stones.to(torch.int8),
                               pos.second_encore_start)

    game_over = was_over | end_now
    recent = torch.where(
        was_over.unsqueeze(-1), pos.recent_moves,
        torch.cat([loc_eff.unsqueeze(-1), pos.recent_moves[:, :-1]], 1))

    def keep(old, new):
        return torch.where(
            was_over.reshape((-1,) + (1,) * (old.dim() - 1)), old, new)

    new_pos_state = PosState(
        board=T.tree_map(keep, pos.board, new_board),
        to_move=keep(pos.to_move, opp),
        move_num=keep(pos.move_num, pos.move_num + 1),
        consec_passes=keep(pos.consec_passes, consec),
        button_taken=button_taken,
        button_for=button_for,
        game_over=game_over,
        recent_moves=recent,
        turns_this_phase=keep(pos.turns_this_phase, torch.where(
            advance, 0, pos.turns_this_phase + 1)),
        simple_ko_loc=keep(pos.simple_ko_loc, simple_ko_loc),
        prev_stones=keep(pos.prev_stones, stones.to(torch.int8)),
        prev_prev_stones=keep(pos.prev_prev_stones, pos.prev_stones),
        prev_ko_loc=keep(pos.prev_ko_loc, pos.simple_ko_loc),
        prev_prev_ko_loc=keep(pos.prev_prev_ko_loc, pos.prev_ko_loc),
        encore_phase=keep(pos.encore_phase, encore2),
        ko_recap_blocked=keep(pos.ko_recap_blocked, recap),
        ko_recap_block_hash=keep(pos.ko_recap_block_hash, recap_hash),
        second_encore_start=second_start,
        white_bonus=keep(pos.white_bonus, white_bonus),
        is_no_result=pos.is_no_result,
        ko_cap_hash=ko_cap_hash,
        ko_cap_loc=ko_cap_loc,
        ko_cap_pla=ko_cap_pla,
        ko_cap_n=keep(pos.ko_cap_n, ko_cap_n))
    hk = _pos_ko_hash(new_pos_state, rules)
    return new_pos_state, info, hk


def step(gs: GameState, loc: torch.Tensor, size: int):
    """Play loc[G] (NN = pass); the full-history layer over step_pos
    (Spight-like ending passes, pass-hash rings, ko-history resets and
    long-cycle no-results)."""
    nn = size * size
    dev = gs.pos.to_move.device
    g = gs.pos.to_move.shape[0]
    gi = torch.arange(g, device=dev)
    loc = loc.long()
    was_over = gs.pos.game_over
    player = gs.pos.to_move
    is_pass_req = (loc >= nn) & ~was_over
    kh_before = _pos_ko_hash(gs.pos, gs.rules)

    spight_phase = ((gs.pos.encore_phase > 0)
                    | (gs.rules.ko_rule == R.KO_SIMPLE)
                    | (gs.rules.ko_rule == R.KO_SPIGHT))
    claims_button = (gs.rules.has_button
                     & (gs.rules.scoring_rule == R.SCORING_AREA)
                     & is_pass_req & ~gs.pos.button_taken
                     & (gs.pos.encore_phase == 0))
    is_black = player == B.BLACK
    p = MAX_PASS_HASHES
    ring = torch.where(is_black.reshape(-1, 1, 1), gs.pass_hash_black,
                       gs.pass_hash_white)
    ring_n = torch.where(is_black, gs.pass_hash_black_n,
                         gs.pass_hash_white_n)
    ring_valid = torch.arange(p, device=dev) < ring_n.unsqueeze(-1)
    seen = (hash_eq(ring, kh_before.unsqueeze(1)) & ring_valid).any(dim=-1)
    spightlike = spight_phase & is_pass_req & ~claims_button & seen

    pos2, info, hk = step_pos(gs.pos, gs.rules, loc, size, spightlike)
    advanced = pos2.encore_phase != gs.pos.encore_phase

    record = is_pass_req & ~claims_button

    def push(ring_arr, n, mine):
        do = record & mine & (n < p)
        slot = n.clamp(max=p - 1)
        arr = ring_arr.clone()
        arr[gi, slot] = torch.where(do.unsqueeze(-1), kh_before,
                                    arr[gi, slot])
        return arr, n + (do & (n < p)).long()

    phb, phbn = push(gs.pass_hash_black, gs.pass_hash_black_n, is_black)
    phw, phwn = push(gs.pass_hash_white, gs.pass_hash_white_n, ~is_black)
    clear_rings = advanced | claims_button
    phbn = torch.where(clear_rings, 0, phbn)
    phwn = torch.where(clear_rings, 0, phwn)

    reset_hist = ~was_over & (claims_button | (is_pass_req & spight_phase)
                              | advanced)
    max_hist = gs.ko_hash_hist.shape[1]
    write_idx = torch.where(reset_hist, 0,
                            gs.hist_len.clamp(max=max_hist - 1))
    hist = torch.where(reset_hist.reshape(-1, 1, 1), 0, gs.ko_hash_hist)
    hist[gi, write_idx] = torch.where(was_over.unsqueeze(-1),
                                      gs.ko_hash_hist[gi, write_idx], hk)
    hist_len = torch.where(was_over, gs.hist_len,
                           torch.where(reset_hist, 1,
                                       (gs.hist_len + 1).clamp(
                                           max=max_hist)))

    cyc_check = ~was_over & ~is_pass_req & (
        (gs.pos.encore_phase > 0) | (gs.rules.ko_rule == R.KO_SIMPLE))
    valid = torch.arange(max_hist, device=dev) < hist_len.unsqueeze(-1)
    occurrences = (hash_eq(hist, hk.unsqueeze(1)) & valid).sum(dim=-1)
    no_result = cyc_check & (occurrences >= 3)
    pos2.game_over = pos2.game_over | no_result
    pos2.is_no_result = pos2.is_no_result | no_result
    return GameState(pos=pos2, rules=gs.rules, ko_hash_hist=hist,
                     hist_len=hist_len, pass_hash_black=phb,
                     pass_hash_black_n=phbn, pass_hash_white=phw,
                     pass_hash_white_n=phwn), info


def legal_moves(gs: GameState, size: int) -> torch.Tensor:
    """bool[G, NN+1] full legality for each game's player to move,
    including superko; index NN is pass (legal while the game is live)."""
    nn = size * size
    dev = gs.pos.to_move.device
    g = gs.pos.to_move.shape[0]
    zst = zobrist.stone_table(size, dev)
    stones = gs.board.stones
    player = gs.to_move
    opp = B.opponent(player)
    pl3 = player.reshape(-1, 1, 1)
    opp3 = opp.reshape(-1, 1, 1)

    basic = B.legal_moves_basic(gs.board, player, gs.rules.multi_suicide,
                                size)
    labels = B.connected_labels(stones, size)
    libs = B.chain_liberties(stones, labels, size)
    occupied = (stones == B.BLACK) | (stones == B.WHITE)
    own_keys = torch.where((stones == B.BLACK).unsqueeze(-1), zst[0, :nn],
                           zst[1, :nn])
    own_keys = torch.where(occupied.unsqueeze(-1), own_keys, 0)
    chain_key = zobrist.segment_xor(own_keys, labels, nn)      # [G, NN, 2]
    table = torch.cat([chain_key, torch.zeros((g, 1, 2), dtype=torch.int64,
                                              device=dev)], dim=1)

    nbr_s = B.shift4(stones, size, B.WALL)
    nbr_lab = B.shift4(labels, size, nn)
    nbr_libs = B.shift4(libs, size, 0)

    def xor_adjacent_chains(match):
        cand = B.dedup_dirs(torch.where(match, nbr_lab, nn), nn)  # [G,4,NN]
        rows = table.gather(1, cand.reshape(g, 4 * nn, 1).expand(
            g, 4 * nn, 2)).reshape(g, 4, nn, 2)
        return rows[:, 0] ^ rows[:, 1] ^ rows[:, 2] ^ rows[:, 3]

    delta_cap = xor_adjacent_chains((nbr_s == opp3) & (nbr_libs == 1))
    has_empty_nbr = (nbr_s == B.EMPTY).any(dim=-2)
    own_safe = ((nbr_s == pl3) & (nbr_libs >= 2)).any(dim=-2)
    captures_any = ((nbr_s == opp3) & (nbr_libs == 1)).any(dim=-2)
    own_any = (nbr_s == pl3).any(dim=-2)
    is_suicide_move = ((stones == B.EMPTY) & ~has_empty_nbr & ~own_safe
                       & ~captures_any & own_any)
    delta_own = xor_adjacent_chains((nbr_s == pl3) & (nbr_libs == 1))

    place_key = zst[player - 1, :nn]                            # [G, NN, 2]
    ph = gs.board.pos_hash.unsqueeze(1)
    post_hash = torch.where(is_suicide_move.unsqueeze(-1), ph ^ delta_own,
                            ph ^ place_key ^ delta_cap)
    ko_after = _ko_hash(post_hash, opp, gs.rules.ko_rule)       # [G, NN, 2]

    max_hist = gs.ko_hash_hist.shape[1]
    valid = torch.arange(max_hist, device=dev) < gs.hist_len.unsqueeze(-1)
    hist = gs.ko_hash_hist
    eq = ((ko_after[..., 0].unsqueeze(-1) == hist[..., 0].unsqueeze(1))
          & (ko_after[..., 1].unsqueeze(-1) == hist[..., 1].unsqueeze(1)))
    repeats = (eq & valid.unsqueeze(1)).any(dim=-1)             # [G, NN]

    in_encore = gs.pos.encore_phase > 0
    ko = gs.rules.ko_rule
    use_superko = ((ko == R.KO_POSITIONAL) | (ko == R.KO_SITUATIONAL)
                   | (ko == R.KO_SPIGHT)) & ~in_encore
    legal = basic & ~(use_superko.unsqueeze(-1) & repeats)

    e = MAX_ENCORE_KO_CAPS
    cap_valid = ((torch.arange(e, device=dev)
                  < gs.pos.ko_cap_n.clamp(max=e).unsqueeze(-1))
                 & (gs.pos.ko_cap_pla == player.unsqueeze(-1)))
    cap_match = cap_valid & hash_eq(gs.pos.ko_cap_hash,
                                    gs.board.pos_hash.unsqueeze(1))
    ban_idx = torch.where(cap_match, gs.pos.ko_cap_loc.clamp(0, nn), nn)
    encore_ban = torch.zeros((g, nn + 1), dtype=torch.int64, device=dev)
    encore_ban.scatter_reduce_(1, ban_idx, cap_match.long(), "amax")
    legal = legal & ~(in_encore.unsqueeze(-1) & (encore_ban[:, :nn] > 0))

    chain_sz = _chain_sizes(stones, labels, nn)
    recap = gs.pos.ko_recap_blocked
    pfk_a = (stones == opp.unsqueeze(-1)) & recap & (chain_sz == 1) & \
        (libs == 1)
    idxs = torch.arange(nn, device=dev).expand(g, nn)
    kcls = _ko_capture_loc(stones, libs, chain_sz, idxs, player, size)
    kcls_c = kcls.clamp(0, nn - 1)
    pfk_b = (kcls >= 0) & recap.gather(1, kcls_c) & \
        (stones.gather(1, kcls_c) == opp.unsqueeze(-1))
    legal = torch.where(in_encore.unsqueeze(-1), legal | pfk_a | pfk_b,
                        legal)
    legal = legal & ~gs.game_over.unsqueeze(-1)
    return torch.cat([legal, ~gs.game_over.unsqueeze(-1)], dim=1)


def _area_score_board(stones, rules: RulesArr, size: int):
    tax_none = rules.tax_rule == R.TAX_NONE
    area_plain = benson.calculate_area(stones, size, True, True, True,
                                       rules.multi_suicide)
    area_il, wmb = benson.calculate_independent_life_area(
        stones, size, keep_territories=False, keep_stones=True,
        suicide_legal=rules.multi_suicide)
    area = torch.where(tax_none.unsqueeze(-1), area_plain, area_il)
    score = torch.where(area == B.WHITE, 1,
                        torch.where(area == B.BLACK, -1, 0)).sum(-1).float()
    score = score - torch.where(rules.tax_rule == R.TAX_ALL,
                                2.0 * wmb.float(), 0.0)
    return area, score


def _territory_score_board(stones, second_encore_start, encore_phase,
                           rules: RulesArr, size: int):
    keep_territories = rules.tax_rule == R.TAX_NONE
    area, wmb = benson.calculate_independent_life_area(
        stones, size, keep_territories=keep_territories, keep_stones=False,
        suicide_legal=rules.multi_suicide)
    ses = second_encore_start.long()
    unclaimed = area == B.EMPTY
    early = (encore_phase < 2).unsqueeze(-1)
    white_stone = unclaimed & (stones == B.WHITE) & (early | (ses == B.WHITE))
    black_stone = unclaimed & (stones == B.BLACK) & (early | (ses == B.BLACK))
    area = torch.where(white_stone, B.WHITE,
                       torch.where(black_stone, B.BLACK, area))
    score = torch.where(area == B.WHITE, 1,
                        torch.where(area == B.BLACK, -1, 0)).sum(-1).float()
    score = score - torch.where(rules.tax_rule == R.TAX_ALL,
                                2.0 * wmb.float(), 0.0)
    return area, score


def final_score_pos(pos: PosState, rules: RulesArr, size: int):
    """(ownership int64[G, NN] +1 black / -1 white, white_minus_black
    float32[G]) of each position as if the game ended now."""
    stones = pos.board.stones
    is_territory = rules.scoring_rule == R.SCORING_TERRITORY
    area_a, score_a = _area_score_board(stones, rules, size)
    area_t, score_t = _territory_score_board(
        stones, pos.second_encore_start, pos.encore_phase, rules, size)
    area = torch.where(is_territory.unsqueeze(-1), area_t, area_a)
    board_score = torch.where(is_territory, score_t, score_a)
    button = torch.where(
        rules.has_button & ~pos.button_taken & (pos.encore_phase == 0),
        torch.where(pos.to_move == B.WHITE, 0.5, -0.5), 0.0)
    own = torch.where(area == B.BLACK, 1, torch.where(area == B.WHITE, -1, 0))
    score = board_score + rules.komi + pos.white_bonus + button
    return own, score


def final_score(gs: GameState, size: int):
    return final_score_pos(gs.pos, gs.rules, size)


def replace_pos(gs: GameState, **kw) -> GameState:
    """Replace PosState fields through the GameState wrapper (setup)."""
    return dataclasses.replace(gs, pos=dataclasses.replace(gs.pos, **kw))


def _restart_from_board(gs: GameState, stones, pos_hash) -> GameState:
    """Install a starting board: the prev-board snapshots clamp to it
    (getRecentBoard) and history slot 0 records its ko hash."""
    board = dataclasses.replace(gs.pos.board, stones=stones,
                                pos_hash=pos_hash)
    gs = replace_pos(gs, board=board, prev_stones=stones.to(torch.int8),
                     prev_prev_stones=stones.to(torch.int8))
    hist = gs.ko_hash_hist.clone()
    hist[:, 0] = _pos_ko_hash(gs.pos, gs.rules)
    return dataclasses.replace(gs, ko_hash_hist=hist)


def setup_board(gs: GameState, stones, size: int) -> GameState:
    """Replace every game's whole starting board (stones int[G, NN]):
    recomputes the zobrist pos_hash, seeds the prev-board snapshots and
    refreshes the recorded starting ko-hash. Only valid before any moves
    are played."""
    nn = size * size
    stones = stones.to(device=gs.hist_len.device, dtype=torch.int32)
    st = zobrist.stone_table(size, stones.device)[:, :nn]   # [2, NN, 2]
    zero = torch.zeros((), dtype=torch.int64, device=stones.device)
    keys = torch.where((stones == B.BLACK).unsqueeze(-1), st[0], zero) ^ \
        torch.where((stones == B.WHITE).unsqueeze(-1), st[1], zero)
    return _restart_from_board(gs, stones, zobrist.xor_reduce(keys, dim=-2))


def setup_stone(gs: GameState, loc, color, size: int) -> GameState:
    """Place (or clear, color=EMPTY) one pre-game setup stone per game
    (loc, color [G]): updates the zobrist pos_hash, seeds the prev-board
    snapshots and refreshes the recorded starting ko-hash
    (Board::setStone + BoardHistory::clear). Only valid before any
    moves are played."""
    dev = gs.hist_len.device
    st = zobrist.stone_table(size, dev)                      # [2, NN+1, 2]
    loc = torch.as_tensor(loc, dtype=torch.int64, device=dev).expand(
        gs.hist_len.shape)
    color = torch.as_tensor(color, dtype=torch.int64, device=dev).expand(
        gs.hist_len.shape)
    gi = torch.arange(loc.shape[0], device=dev)
    old = gs.pos.board.stones[gi, loc].long()
    h = gs.pos.board.pos_hash
    h = torch.where((old > 0).unsqueeze(-1),
                    h ^ st[old.clamp(1, 2) - 1, loc], h)
    h = torch.where((color > 0).unsqueeze(-1),
                    h ^ st[color.clamp(1, 2) - 1, loc], h)
    stones = gs.pos.board.stones.clone()
    stones[gi, loc] = color.to(stones.dtype)
    return _restart_from_board(gs, stones, h)


# the JAX package's name for final_score in the selfplay writer
final_score_area = final_score
