"""Ladder solvers for NN input planes 14-17 — port of
katago_tpu/game/ladder.py, batched over boards.

Two solvers, as in the JAX package:

  * the exact backtracking search (`ladder_map` / `ladder_map_batch`,
    Board::searchIsLadderCaptured semantics with the JAX package's caps),
    used where features are written per move: the selfplay data rows;
  * the greedy chase (`ladder_map_chase_batch`), used inside the search.
    Its per-lane solve (`_chase_one` / `_chase_apply` /
    `_would_be_ko_capture_at`) lives in ops/chase.py beside its CUDA
    kernel (K1): every board's 2 * max_chains query lanes go through one
    `chase_lanes` call, as the JAX package's TPU path does.

The exact solver is plain PyTorch (the JAX package runs it outside any
Pallas kernel). Every lane of every board runs the same explicit-stack
machine as the JAX `_search_captured` while_loop, one iteration per
lockstep step; the results, including the node budget, the depth cap and
the per-lane iteration cap, are bit for bit those of the JAX function.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from katago_torch.game import board as B
from katago_torch.ops import chase as K1


@dataclasses.dataclass
class LadderResult:
    laddered: torch.Tensor          # bool[G, NN]: stones of captured chains
    working_vs_black: torch.Tensor  # bool[G, NN]: working attacker moves
    working_vs_white: torch.Tensor  # bool[G, NN]


def default_max_steps(size: int) -> int:
    # a corner-to-corner ladder consumes ~4 plies per diagonal cell
    return 4 * size + 14


def _stone_labels(stones, size):
    """Min-index labels of stone chains; empty points keep their own index.
    Stone components are the same under connected_labels, so this is one
    K2 call: where(occupied, connected_labels(stones), arange)."""
    nn = size * size
    occ = (stones == B.BLACK) | (stones == B.WHITE)
    idx = torch.arange(nn, device=stones.device)
    return torch.where(occ, B.connected_labels(stones, size), idx)


def _dilate(mask, size):
    """4-neighbour dilation of bool [..., NN] (the mask itself excluded)."""
    return (B.shift4(mask.to(torch.int8), size, 0) > 0).any(dim=-2)


def _chain_lib_points(stones, labels, rep, size):
    """bool[G, K, NN]: empty points adjacent to the chain containing
    rep[G, K]."""
    lrep = labels.gather(1, rep)                              # [G, K]
    chain = (labels.unsqueeze(1) == lrep.unsqueeze(-1)) & \
        (stones != B.EMPTY).unsqueeze(1)
    return (stones == B.EMPTY).unsqueeze(1) & _dilate(chain, size)


def _lowest_k(mask, k: int):
    """Indices of the k lowest set positions of bool[..., NN] (NN where
    unset)."""
    nn = mask.shape[-1]
    idx = torch.arange(nn, device=mask.device)
    vals = torch.where(mask, idx, nn)
    return torch.sort(vals, dim=-1).values[..., :k]


def _chase_setup(stones, size: int, max_chains: int, ko):
    """Per-board lane construction: the lowest-index chains with 1 or 2
    liberties (up to max_chains) each get two query lanes."""
    nn = size * size
    ctx = _heads(stones, size, max_chains)
    h, head_ok, hlibcnt = ctx["h"], ctx["head_ok"], ctx["hlibcnt"]
    libpts = ctx["libpts"]
    ko = ko.long().unsqueeze(-1)
    pre_a = torch.where((hlibcnt == 2) & (libpts[..., 0] < nn),
                        libpts[..., 0], -1)
    pre_b = torch.where(libpts[..., 1] < nn, libpts[..., 1], -1)
    act_a = head_ok & ((hlibcnt == 1)
                       | ((hlibcnt == 2) & (libpts[..., 0] < nn)
                          & (libpts[..., 0] != ko)))
    act_b = head_ok & (hlibcnt == 2) & (libpts[..., 1] < nn) & \
        (libpts[..., 1] != ko)
    return dict(ctx, reps=torch.cat([h, h], 1),
                defenders=torch.cat([ctx["hdef"]] * 2, 1),
                premoves=torch.cat([pre_a, pre_b], 1),
                active=torch.cat([act_a, act_b], 1))


def chase_lane_inputs(stones, ctx, max_chains: int):
    """chase_lanes' positional inputs for the 2 * max_chains lanes of
    each board that _chase_setup built (board-major)."""
    k2 = 2 * max_chains
    i32 = torch.int32
    return (stones.to(i32).repeat_interleave(k2, dim=0),
            ctx["labels"].to(i32).repeat_interleave(k2, dim=0),
            ctx["libs"].to(i32).repeat_interleave(k2, dim=0),
            ctx["reps"].reshape(-1).to(i32),
            ctx["defenders"].reshape(-1).to(i32),
            ctx["premoves"].reshape(-1).to(i32),
            ctx["active"].reshape(-1))


def _chase_finish(ctx, results, size: int, max_chains: int) -> LadderResult:
    """Mark laddered chains / working attacker moves from lane verdicts
    (results bool[G, 2K])."""
    nn = size * size
    k = max_chains
    labels, occupied = ctx["labels"], ctx["occupied"]
    h, head_ok = ctx["h"], ctx["head_ok"]
    hdef, hlibcnt, libpts = ctx["hdef"], ctx["hlibcnt"], ctx["libpts"]
    lad_a, lad_b = results[:, :k], results[:, k:]
    mark = B.bincount_rows(torch.where(head_ok & (lad_a | lad_b), h, -1), nn)
    laddered = (mark.gather(1, labels) >= 1) & occupied

    def working_mask(color):
        sel_a = head_ok & lad_a & (hdef == color) & (hlibcnt == 2)
        sel_b = head_ok & lad_b & (hdef == color)
        m = B.bincount_rows(torch.where(sel_a, libpts[..., 0], -1), nn)
        m = m + B.bincount_rows(torch.where(sel_b, libpts[..., 1], -1), nn)
        return m >= 1

    return LadderResult(laddered=laddered,
                        working_vs_black=working_mask(B.BLACK),
                        working_vs_white=working_mask(B.WHITE))


def ladder_map_chase_batch(stones, size: int, max_chains: int = 16,
                           max_steps: int | None = None,
                           ko_loc=None) -> LadderResult:
    """Chase-solver ladder planes for [G, NN] boards: every board's
    2 * max_chains lanes go through ONE chase_lanes call (K1 on CUDA)."""
    g, nn = stones.shape
    if max_steps is None:
        max_steps = default_max_steps(size)
    if ko_loc is None:
        ko_loc = torch.full((g,), -1, dtype=torch.int64,
                            device=stones.device)
    ctx = _chase_setup(stones, size, max_chains, ko_loc)
    cap = K1.chase_lanes(*chase_lane_inputs(stones, ctx, max_chains),
                         size=size, max_steps=max_steps)
    return _chase_finish(ctx, cap.reshape(g, 2 * max_chains), size,
                         max_chains)


def ladder_map_chase(stones, size: int, max_chains: int = 16,
                     max_steps: int | None = None,
                     ko_loc: int = -1) -> LadderResult:
    """One board int[NN] -> LadderResult of [NN] masks."""
    ko = torch.tensor([ko_loc], dtype=torch.int64, device=stones.device)
    res = ladder_map_chase_batch(stones.unsqueeze(0), size, max_chains,
                                 max_steps, ko)
    return LadderResult(*(getattr(res, f.name)[0]
                          for f in dataclasses.fields(res)))


# ---------------------------------------------------------------------------
# Exact backtracking solver (ladder.py::ladder_map and its helpers).
# ---------------------------------------------------------------------------
#
# Lanes are flat [L, NN] batches with per-lane scalars [L]. The JAX
# package's one-hot `_row_read` / `_row_write` and 2-bit packed stack rows
# were TPU workarounds: here the stack is int8 boards and int16 labels,
# indexed directly. Labels are only ever compared for chain identity and
# the stored rows are the exact min-index labels the JAX package
# recomputes on restore, so keeping them is the same as recomputing them.
# Liberties are always chain_liberties(stones, labels) of the current
# board; they are recomputed once per iteration.

NUM_CAPS = 4
BUDGET = 25000
POLL_EVERY = 8      # lockstep iterations between two done-checks


def _at(x, m):
    """x [L, NN] at per-lane points m [L] -> [L]."""
    return x.gather(1, m.unsqueeze(-1)).squeeze(-1)


def _chain_mask(stones, labels, rep):
    """bool [L, NN]: the stone chain holding rep [L]."""
    return (labels == _at(labels, rep).unsqueeze(-1)) & (stones != B.EMPTY)


@dataclasses.dataclass
class _Effects:
    """Exact incremental effects of one stone placement per lane."""
    new_stones: torch.Tensor   # [L, NN]
    new_labels: torch.Tensor   # [L, NN]
    my_mask: torch.Tensor      # bool [L, NN]: chain holding the new stone
    ko_loc: torch.Tensor       # [L] simple-ko ban or -1
    legal: torch.Tensor        # bool [L]: empty target, not suicide


def _move_effects(stones, labels, libs, m, player, size) -> _Effects:
    """`player` [L] plays at m [L] (< NN) using only the current analysis:
    merges the adjacent own chains, captures the adjacent opponent chains
    in atari, keeps labels exact (merged points take the least label,
    captured points their own index)."""
    nn = size * size
    dev = stones.device
    neigh = B.neighbor_table(size, dev)[m]                      # [L, 4]
    nbr_s = B.pad_last(stones, B.WALL).gather(1, neigh)
    nbr_l = B.pad_last(labels, nn).gather(1, neigh)
    nbr_libs = B.pad_last(libs, 0).gather(1, neigh)
    pl = player.unsqueeze(-1)
    opp = B.opponent(pl)
    own_sel = nbr_s == pl
    cap_sel = (nbr_s == opp) & (nbr_libs == 1)
    lab_eq = labels.unsqueeze(1) == nbr_l.unsqueeze(-1)         # [L, 4, NN]
    own_mask = (lab_eq & own_sel.unsqueeze(-1)).any(1) & (stones == pl)
    cap_mask = (lab_eq & cap_sel.unsqueeze(-1)).any(1) & (stones == opp)
    merged = torch.minimum(m, torch.where(own_sel, nbr_l,
                                          m.unsqueeze(-1)).amin(-1))
    idx = torch.arange(nn, device=dev)
    at_m = idx == m.unsqueeze(-1)
    new_stones = torch.where(at_m, pl, torch.where(cap_mask, B.EMPTY,
                                                   stones))
    my_mask = own_mask | at_m
    new_labels = torch.where(my_mask, merged.unsqueeze(-1),
                             torch.where(cap_mask, idx, labels))
    my_libs = ((new_stones == B.EMPTY) & _dilate(my_mask, size)).sum(-1)
    is_ko = (cap_mask.sum(-1) == 1) & ~own_sel.any(-1) & (my_libs == 1)
    ko_loc = torch.where(is_ko, B.first_true(cap_mask), -1)
    legal = (_at(stones, m) == B.EMPTY) & (my_libs > 0)
    return _Effects(new_stones, new_labels, my_mask, ko_loc, legal)


def _rep_libs_after(stones, labels, rep, eff: _Effects, size):
    """Liberties of the chain holding rep after eff's move (0 if it was
    captured)."""
    alive = _at(eff.new_stones, rep) == _at(stones, rep)
    mask = torch.where(_at(eff.my_mask, rep).unsqueeze(-1), eff.my_mask,
                       _chain_mask(stones, labels, rep))
    cnt = ((eff.new_stones == B.EMPTY) & _dilate(mask, size)).sum(-1)
    return torch.where(alive, cnt, 0)


def _defender_candidates(stones, labels, libs, rep, defender, size,
                         num_caps: int):
    """Up to num_caps liberty-gaining captures (the lone liberties of
    attacker chains in atari touching the defender chain), then the
    extension at the defender's lone liberty. Returns (cand [L, C+1],
    valid [L, C+1], any_caps [L])."""
    nn = size * size
    attacker = B.opponent(defender).unsqueeze(-1)
    chain = _chain_mask(stones, labels, rep)
    lib_pts = (stones == B.EMPTY) & _dilate(chain, size)
    extend_loc = B.first_true(lib_pts)
    opp_atari_adj = (stones == attacker) & (libs == 1) & _dilate(chain, size)
    lab_mark = B.bincount_rows(torch.where(opp_atari_adj, labels, -1), nn)
    marked = (stones == attacker) & (lab_mark.gather(1, labels) >= 1)
    cap_moves = (stones == B.EMPTY) & _dilate(marked, size)
    caps = _lowest_k(cap_moves, num_caps)
    cand = torch.cat([caps, extend_loc.unsqueeze(-1)], -1)
    valid = torch.cat([caps < nn, lib_pts.any(-1, keepdim=True)], -1)
    return cand, valid, cap_moves.any(-1)


def _double_ko(stones, labels, libs, defender, lib2, any_caps, rep_libs2,
               size):
    """The double-ko death pattern at the attacker's two liberties lib2
    [L, 2]: both are empty points with no empty neighbour and would be a
    ko capture for the attacker (all neighbours defender or wall, exactly
    one neighbouring defender chain in atari, and that chain a single
    stone), connecting at either gives the defender at most 2 liberties,
    and the defender has no capture."""
    nn = size * size
    lc = lib2.clamp(max=nn - 1)
    neigh = B.neighbor_table(size, stones.device)[lc]           # [L, 2, 4]
    flat = neigh.reshape(neigh.shape[0], -1)
    sizes = B.bincount_rows(torch.where(stones != B.EMPTY, labels, -1), nn)
    chain_size = torch.where(stones != B.EMPTY, sizes.gather(1, labels), 0)
    ns = B.pad_last(stones, B.WALL).gather(1, flat).reshape(neigh.shape)
    nl = B.pad_last(libs, 0).gather(1, flat).reshape(neigh.shape)
    nz = B.pad_last(chain_size, 0).gather(1, flat).reshape(neigh.shape)
    d = defender.reshape(-1, 1, 1)
    cap_nbr = (ns == d) & (nl == 1)
    kocap = (stones.gather(1, lc) == B.EMPTY) & \
        ((ns == d) | (ns == B.WALL)).all(-1) & (cap_nbr.sum(-1) == 1) & \
        ((cap_nbr & (nz == 1)).sum(-1) == 1)
    imm0 = (ns == B.EMPTY).sum(-1) == 0
    both = (lib2 < nn).all(-1)
    return both & (imm0 & kocap).all(-1) & (rep_libs2 <= 2).all(-1) & \
        ~any_caps


@dataclasses.dataclass
class _Stack:
    """Explicit-stack state of a set of lanes (the JAX `_Stk`, one row
    per lane); every field is [L, ...]."""
    rep: torch.Tensor          # defender chain's representative point
    defender: torch.Tensor
    lane: torch.Tensor         # index of the lane in the caller's set
    stones: torch.Tensor       # int64 [L, NN] current board
    labels: torch.Tensor       # int64 [L, NN] exact stone-chain labels
    ko: torch.Tensor           # simple-ko point or -1
    stk_stones: torch.Tensor   # int8 [L, D, NN] pre-move board per level
    stk_labels: torch.Tensor   # int16 [L, D, NN] its labels
    stk_ko: torch.Tensor       # [L, D]
    stk_moves: torch.Tensor    # [L, D, C+1] candidate moves per level
    stk_len: torch.Tensor      # [L, D]
    stk_cur: torch.Tensor      # [L, D]; -1 = level not yet expanded
    idx: torch.Tensor          # stack level; -1 = returned from the root
    ret: torch.Tensor          # bool value being returned
    from_deeper: torch.Tensor  # bool: restore the board on re-entry
    nodes: torch.Tensor        # moves played (node budget)
    iters: torch.Tensor        # loop iterations

    def running(self, budget: int, max_iters: int):
        return (self.idx >= 0) & (self.nodes < budget) & \
            (self.iters < max_iters)

    def select(self, keep) -> "_Stack":
        return _Stack(**{f.name: getattr(self, f.name)[keep]
                         for f in dataclasses.fields(self)})


def _new_stack(stones, labels, rep, defender, lane, active, depth: int,
               num_caps: int) -> _Stack:
    n, nn = stones.shape
    dev = stones.device

    def full(shape, v, dt=torch.int64):
        return torch.full(shape, v, dtype=dt, device=dev)

    return _Stack(
        rep=rep, defender=defender, lane=lane, stones=stones, labels=labels,
        ko=full((n,), -1),
        stk_stones=full((n, depth, nn), 0, torch.int8),
        stk_labels=full((n, depth, nn), 0, torch.int16),
        stk_ko=full((n, depth), 0), stk_moves=full((n, depth, num_caps + 1),
                                                    0),
        stk_len=full((n, depth), 0), stk_cur=full((n, depth), -1),
        idx=torch.where(active, 0, -1), ret=full((n,), False, torch.bool),
        from_deeper=full((n,), False, torch.bool), nodes=full((n,), 0),
        iters=full((n,), 0))


def _search_step(s: _Stack, size: int, depth: int, num_caps: int,
                 budget: int, max_iters: int, depth_hits) -> None:
    """One iteration of Board::searchIsLadderCaptured's stack machine
    (defender first) for every running lane, in place: the body of the
    JAX `_search_captured` while_loop; lanes that are not running keep
    their state, as under the JAX loop's per-lane condition."""
    nn = size * size
    n = s.idx.shape[0]
    dev = s.idx.device
    ar = torch.arange(n, device=dev)
    m_moves = num_caps + 1
    run = s.running(budget, max_iters)
    lvl = s.idx.clamp(0, depth - 1)
    is_def = (s.idx % 2) == 0
    defender = s.defender
    mover = torch.where(is_def, defender, B.opponent(defender))
    cur = s.stk_cur[ar, lvl]
    entering = cur == -1

    # re-entry after a child returned: restore this level's board
    restore = (~entering & s.from_deeper).unsqueeze(-1)
    stones = torch.where(restore, s.stk_stones[ar, lvl].long(), s.stones)
    labels = torch.where(restore, s.stk_labels[ar, lvl].long(), s.labels)
    ko = torch.where(restore[:, 0], s.stk_ko[ar, lvl], s.ko)
    libs = B.chain_liberties(stones, labels, size)

    rep = s.rep
    dlibs = torch.where(_at(stones, rep) != defender, 0, _at(libs, rep))
    cand, valid, any_caps = _defender_candidates(
        stones, labels, libs, rep, defender, size, num_caps)
    lib_pts = (stones == B.EMPTY) & _dilate(
        _chain_mask(stones, labels, rep), size)
    lib2 = _lowest_k(lib_pts, 2)

    # the defender at its extension and at each attacker liberty, as one
    # batch of 3L moves
    probe = torch.cat([cand[:, num_caps], lib2[:, 0], lib2[:, 1]]).clamp(
        max=nn - 1)
    st3, lab3 = stones.repeat(3, 1), labels.repeat(3, 1)
    eff3 = _move_effects(st3, lab3, libs.repeat(3, 1), probe,
                         defender.repeat(3), size)
    rl3 = _rep_libs_after(st3, lab3, rep.repeat(3), eff3, size).reshape(3, n)
    ext_libs = rl3[0]
    ext_valid = valid[:, num_caps] & eff3.legal[:n]
    double_ko = _double_ko(stones, labels, libs, defender, lib2, any_caps,
                           rl3[1:].T, size)

    # base cases at entry (board.cpp:1694-1704, 1717-1729, 1746-1756)
    def_win = is_def & ((ko >= 0) | (dlibs >= 2)
                        | (ext_valid & (ext_libs >= 3)))
    def_lose = is_def & ~def_win & ~any_caps & \
        ((ext_valid & (ext_libs <= 1)) | ~ext_valid)
    att_win = ~is_def & ((dlibs <= 1) | double_ko)
    att_lose = ~is_def & (dlibs >= 3)
    base = entering & (def_win | def_lose | att_win | att_lose)
    base_ret = def_lose | att_win

    # move list on true entry, valid moves first (stable)
    pad = torch.full((n, m_moves - 2), nn, dtype=torch.int64, device=dev)
    moves = torch.where(is_def.unsqueeze(-1), cand, torch.cat([lib2, pad], 1))
    mvalid = torch.where(is_def.unsqueeze(-1), valid,
                         torch.cat([lib2 < nn, pad < 0], 1))
    moves = torch.where(mvalid, moves, nn)
    order = torch.sort((~mvalid).to(torch.int8), dim=1, stable=True).indices
    moves = moves.gather(1, order)
    n_moves = mvalid.sum(-1)
    gen = entering & ~base
    old_moves = s.stk_moves[ar, lvl]
    move_row = torch.where(gen.unsqueeze(-1), moves, old_moves)
    old_len = s.stk_len[ar, lvl]
    llen = torch.where(gen, n_moves, old_len)
    cur2 = torch.where(gen, 0, cur)

    # re-entry: the child's verdict cuts this level or moves to the next
    child_cut = ~entering & ((is_def & ~s.ret) | (~is_def & s.ret))
    cur2 = torch.where(~entering & ~child_cut, cur2 + 1, cur2)
    exhausted = ~base & ~child_cut & (cur2 >= llen)
    popping = base | child_cut | exhausted
    ret_out = torch.where(base, base_ret,
                          torch.where(child_cut, s.ret, is_def))

    # try the next move of the list
    move = _at(move_row, cur2.clamp(0, m_moves - 1))
    move_c = move.clamp(0, nn - 1)
    eff = _move_effects(stones, labels, libs, move_c, mover, size)
    legal = ~popping & (move < nn) & eff.legal & (move_c != ko)
    depth_hit = legal & (s.idx + 1 >= depth)
    push = legal & ~depth_hit & run
    # an illegal move stays at this level; a depth-capped one returns
    # "captured" (the stack-limit bias)
    ret_stay = depth_hit | is_def
    depth_hits += (depth_hit & run).sum()

    wgen = gen & run
    s.stk_moves[ar, lvl] = torch.where(wgen.unsqueeze(-1), moves, old_moves)
    s.stk_len[ar, lvl] = torch.where(wgen, n_moves, old_len)
    p1 = push.unsqueeze(-1)
    s.stk_stones[ar, lvl] = torch.where(p1, stones.to(torch.int8),
                                        s.stk_stones[ar, lvl])
    s.stk_labels[ar, lvl] = torch.where(p1, labels.to(torch.int16),
                                        s.stk_labels[ar, lvl])
    s.stk_ko[ar, lvl] = torch.where(push, ko, s.stk_ko[ar, lvl])
    s.stk_cur[ar, lvl] = torch.where(run, cur2, cur)
    child = (lvl + 1).clamp(max=depth - 1)
    s.stk_cur[ar, child] = torch.where(push, -1, s.stk_cur[ar, child])

    r1 = run.unsqueeze(-1)
    s.stones = torch.where(p1, eff.new_stones,
                           torch.where(r1, stones, s.stones))
    s.labels = torch.where(p1, eff.new_labels,
                           torch.where(r1, labels, s.labels))
    s.ko = torch.where(push, eff.ko_loc, torch.where(run, ko, s.ko))
    new_idx = torch.where(popping, s.idx - 1,
                          torch.where(push, s.idx + 1, s.idx))
    new_ret = torch.where(popping, ret_out,
                          torch.where(push, s.ret, ret_stay))
    s.idx = torch.where(run, new_idx, s.idx)
    s.ret = torch.where(run, new_ret, s.ret)
    s.from_deeper = torch.where(run, popping, s.from_deeper)
    s.nodes = s.nodes + push.long()
    s.iters = s.iters + run.long()


def _heads(stones, size: int, max_chains: int):
    """Analysis shared by both solvers: stone labels, liberties and the
    lowest-index chains with 1 or 2 liberties (up to max_chains per
    board) with their two lowest liberties."""
    nn = size * size
    labels = _stone_labels(stones, size)
    libs = B.chain_liberties(stones, labels, size)
    occupied = (stones == B.BLACK) | (stones == B.WHITE)
    idx = torch.arange(nn, device=stones.device)
    is_head = occupied & (labels == idx) & (libs >= 1) & (libs <= 2)
    heads = _lowest_k(is_head, max_chains)                    # [G, K]
    h = heads.clamp(max=nn - 1)
    return dict(labels=labels, libs=libs, occupied=occupied, h=h,
                head_ok=heads < nn, hdef=stones.gather(1, h).long(),
                hlibcnt=libs.gather(1, h),
                libpts=_lowest_k(_chain_lib_points(stones, labels, h, size),
                                 2))


def _solve_exact(stones, labels, libs, rep, defender, premove, size: int,
                 depth: int, num_caps: int, budget: int, max_iters: int,
                 stats=None):
    """Verdicts bool[L] of ladder queries on boards stones [L, NN]: an
    optional attacker premove (the 2-liberty attacker-first form), then
    the defender-first backtracking search (the JAX `_run_sim`). Lanes
    run in lockstep; every POLL_EVERY iterations one sync checks whether
    any lane still runs, and the set is compacted once at most half of
    its lanes still run."""
    nn = size * size
    n = rep.shape[0]
    dev = rep.device
    has_pre = premove >= 0
    pre = _move_effects(stones, labels, libs, premove.clamp(0, nn - 1),
                        B.opponent(defender), size)
    h1 = has_pre.unsqueeze(-1)
    s = _new_stack(torch.where(h1, pre.new_stones, stones),
                   torch.where(h1, pre.new_labels, labels), rep, defender,
                   torch.arange(n, device=dev), ~has_pre | pre.legal, depth,
                   num_caps)
    out = torch.zeros((n,), dtype=torch.bool, device=dev)
    iters = torch.zeros((n,), dtype=torch.int64, device=dev)
    ended = torch.zeros((n,), dtype=torch.bool, device=dev)
    depth_hits = torch.zeros((), dtype=torch.int64, device=dev)
    steps = 0

    def retire(st, done):
        out[st.lane[done]] = (st.ret & (st.idx < 0))[done]
        iters[st.lane[done]] = st.iters[done]
        ended[st.lane[done]] = (st.idx >= 0)[done]

    while n > 0:
        for _ in range(POLL_EVERY):
            _search_step(s, size, depth, num_caps, budget, max_iters,
                         depth_hits)
        steps += POLL_EVERY
        run = s.running(budget, max_iters)
        left = int(run.sum())
        if left == 0:
            break
        if left <= run.shape[0] // 2:
            retire(s, ~run)
            s = s.select(run.nonzero().squeeze(-1))
    retire(s, torch.ones_like(s.idx, dtype=torch.bool))
    if stats is not None:
        stats["lanes"] = stats.get("lanes", 0) + n
        stats["lockstep_iters"] = stats.get("lockstep_iters", 0) + steps
        stats.setdefault("max_lane_iters", 0)
        i = int(iters.argmax()) if n else 0
        if n and int(iters[i]) > stats["max_lane_iters"]:
            # the longest lane's query: its board (before any premove)
            stats["max_lane_iters"] = int(iters[i])
            stats["longest_lane"] = {
                "board": "".join(map(str, stones[i].tolist())),
                "rep": int(rep[i]), "defender": int(defender[i]),
                "premove": int(premove[i])}
        stats["unfinished_lanes"] = stats.get("unfinished_lanes", 0) + \
            int(ended.sum())
        stats["depth_hits"] = stats.get("depth_hits", 0) + int(depth_hits)
    return out


def ladder_map_batch(stones, size: int, max_chains: int | None = None,
                     max_depth: int | None = None, num_caps: int = NUM_CAPS,
                     budget: int = BUDGET, ko_loc=None,
                     max_iters: int | None = None,
                     stats: dict | None = None) -> LadderResult:
    """Exact ladder planes for boards stones [G, NN]: the JAX
    `ladder_map` of every board, all boards' lanes solved as one set.

    Per board the lowest-index chains with 1 or 2 liberties (up to
    max_chains, default NN // 3 + 8) get three lanes: defender to move
    (1 liberty), and attacker first at either liberty (2 liberties, a
    premove on the ko point excluded). A lane counts as captured only
    if its search returned; exhausting the node budget (25000) or the
    iteration cap (default 4 * budget + 64) counts as not captured, and
    reaching max_depth (default 4 * size + 12) plies as captured.

    stats, when given, accumulates: lanes, lockstep_iters,
    max_lane_iters and the query of that longest lane (longest_lane),
    unfinished_lanes (budget or iteration cap), depth_hits, calls and
    seconds (host wall time, which includes the one sync per POLL_EVERY
    iterations)."""
    t0 = time.perf_counter()
    g, nn = stones.shape
    dev = stones.device
    max_chains = nn // 3 + 8 if max_chains is None else max_chains
    depth = 4 * size + 12 if max_depth is None else max_depth
    max_iters = 4 * budget + 64 if max_iters is None else max_iters
    stones = stones.long()
    if ko_loc is None:
        ko_loc = torch.full((g,), -1, dtype=torch.int64, device=dev)
    ko = ko_loc.long().unsqueeze(-1)
    hd = _heads(stones, size, max_chains)
    h, head_ok, hdef, hlib = hd["h"], hd["head_ok"], hd["hdef"], \
        hd["hlibcnt"]
    lp0, lp1 = hd["libpts"][..., 0], hd["libpts"][..., 1]
    two = head_ok & (hlib == 2)
    active = torch.cat([head_ok & (hlib == 1),
                        two & (lp0 < nn) & (lp0 != ko),
                        two & (lp1 < nn) & (lp1 != ko)], 1)   # [G, 3K]
    premove = torch.cat([torch.full_like(h, -1), torch.where(lp0 < nn, lp0,
                                                             -1),
                         torch.where(lp1 < nn, lp1, -1)], 1)
    sel = active.reshape(-1).nonzero().squeeze(-1)
    board = sel // (3 * max_chains)
    verdict = _solve_exact(
        stones[board], hd["labels"][board], hd["libs"][board],
        h.repeat(1, 3).reshape(-1)[sel], hdef.repeat(1, 3).reshape(-1)[sel],
        premove.reshape(-1)[sel], size, depth, num_caps, budget, max_iters,
        stats)
    results = torch.zeros((g * 3 * max_chains,), dtype=torch.bool,
                          device=dev)
    results[sel] = verdict
    results = results.reshape(g, 3, max_chains)
    lad2a, lad2b = results[:, 1], results[:, 2]
    mark = B.bincount_rows(torch.where(head_ok & results.any(1), h, -1), nn)
    laddered = (mark.gather(1, hd["labels"]) >= 1) & hd["occupied"]

    def working_mask(color):
        m = B.bincount_rows(torch.where(head_ok & lad2a & (hdef == color),
                                        lp0, -1), nn)
        m = m + B.bincount_rows(torch.where(head_ok & lad2b & (hdef == color),
                                            lp1, -1), nn)
        return m >= 1

    res = LadderResult(laddered=laddered,
                       working_vs_black=working_mask(B.BLACK),
                       working_vs_white=working_mask(B.WHITE))
    if stats is not None:
        stats["calls"] = stats.get("calls", 0) + 1
        stats["seconds"] = stats.get("seconds", 0.0) + \
            time.perf_counter() - t0
    return res


def ladder_map(stones, size: int, max_chains: int | None = None,
               max_depth: int | None = None, num_caps: int = NUM_CAPS,
               budget: int = BUDGET, ko_loc: int = -1,
               max_iters: int | None = None) -> LadderResult:
    """One board int[NN] -> exact LadderResult of [NN] masks."""
    ko = torch.tensor([ko_loc], dtype=torch.int64, device=stones.device)
    res = ladder_map_batch(stones.unsqueeze(0), size, max_chains, max_depth,
                           num_caps, budget, ko, max_iters)
    return LadderResult(*(getattr(res, f.name)[0]
                          for f in dataclasses.fields(res)))


def batch_solver(ladder_mode: str):
    """The batched solver of a ladder mode: "exact" (the backtracking
    search, `ladder_map_batch`) or "chase" (`ladder_map_chase_batch`, K1
    on CUDA); both take (stones [G, NN], size, ko_loc=...)."""
    if ladder_mode == "exact":
        return ladder_map_batch
    if ladder_mode == "chase":
        return ladder_map_chase_batch
    raise ValueError(f"unknown ladder_mode {ladder_mode!r}")
