"""Batched Benson pass-alive analysis — port of katago_tpu/game/benson.py.

Reference semantics (KataGo Board::calculateArea, board.h:285-366): for
each player, regions are connected components of empty-or-opponent
points; a region is vital to an adjacent player chain if every counting
point of the region is adjacent to that chain. Benson iteration kills
chains with < 2 vital regions and invalidates regions adjacent to killed
chains until a fixpoint; surviving chains are pass-alive.

The region x chain adjacency is built densely ([G, NN, NN], by
scatter-add of (region, adjacent chain) pairs) and the fixpoint is two
batched matrix-vector products per round over 0/1 float32 values, so
every count is an exact small integer, as in the JAX einsum form.
"""

from __future__ import annotations

import torch

from katago_torch.game import board as B

# fixpoint rounds between convergence checks (each check is a host sync;
# extra rounds at the fixpoint change nothing)
_ROUNDS_PER_CHECK = 4


def _adjacent_chain_labels(labels, stones, pla, size):
    """[G, 4, NN]: labels of adjacent pla chains, deduped, pad NN."""
    nn = size * size
    nbr_s = B.shift4(stones, size, B.WALL)
    nbr_l = B.shift4(labels, size, nn)
    cand = torch.where(nbr_s == pla.reshape(-1, 1, 1), nbr_l, nn)
    return B.dedup_dirs(cand, nn)


def _per_game(x, g, device, dtype):
    """A Python scalar or a tensor ([] or [G]) as a [G] tensor of dtype; a
    Python scalar is filled on the device, not copied there (a copy would
    synchronise with the device)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype).expand(g)
    return torch.full((g,), x, dtype=dtype, device=device)


def _as_bool(x, g, device):
    return _per_game(x, g, device, torch.bool)


def pass_alive_area_for(stones, pla, suicide_legal, size: int,
                        safe_big_territories, unsafe_big_territories):
    """One player's pass-alive marking, per game.

    Returns (mark_all bool[G, NN], mark_if_empty bool[G, NN])."""
    nn = size * size
    g = stones.shape[0]
    dev = stones.device
    pla = _per_game(pla, g, dev, torch.int64)
    suicide_legal = _as_bool(suicide_legal, g, dev)
    safe_big_territories = _as_bool(safe_big_territories, g, dev)
    unsafe_big_territories = _as_bool(unsafe_big_territories, g, dev)
    opp = B.opponent(pla)
    is_pla = stones == pla.unsqueeze(-1)
    is_opp = stones == opp.unsqueeze(-1)
    is_empty = stones == B.EMPTY
    region_mask = is_empty | is_opp
    idx = torch.arange(nn, device=dev)

    chain_lab = B.connected_labels(stones, size)
    region_vals = torch.where(region_mask, -7, idx)
    region_lab_all = B.connected_labels(region_vals, size)
    region_lab = torch.where(region_mask, region_lab_all, nn)

    counting = torch.where(suicide_legal.unsqueeze(-1), region_mask,
                           is_empty)
    adj = _adjacent_chain_labels(chain_lab, stones, pla, size)  # [G,4,NN]

    # dense [G, NN+1, NN+1] region x chain counts (row/col NN = none)
    m = nn + 1
    pair = (region_lab.unsqueeze(-2) * m + adj).reshape(g, -1)  # [G, 4NN]
    cnt = torch.zeros((g, m * m), dtype=torch.float32, device=dev)
    cnt.scatter_add_(1, pair, counting.unsqueeze(-2).expand(
        g, 4, nn).reshape(g, -1).float())
    anyc = torch.zeros((g, m * m), dtype=torch.float32, device=dev)
    anyc.scatter_add_(1, pair, torch.ones_like(cnt[:, :4 * nn]))
    cnt_rc = cnt.reshape(g, m, m)[:, :nn, :nn]
    any_rc = anyc.reshape(g, m, m)[:, :nn, :nn] > 0.5

    n_count = B.bincount_rows(torch.where(region_mask, region_lab, -1), nn,
                              counting.float(), dtype=torch.float32)
    vital_rc = any_rc & (cnt_rc >= n_count.unsqueeze(-1) - 0.5) & \
        (n_count.unsqueeze(-1) > 0.5)
    vital_f = vital_rc.float()
    any_f = any_rc.float()

    def body(chain_alive):
        dead = 1.0 - chain_alive.float()
        region_valid = torch.bmm(any_f, dead.unsqueeze(-1)).squeeze(-1) < 0.5
        vital_ct = torch.bmm(region_valid.float().unsqueeze(-2),
                             vital_f).squeeze(-2)
        return chain_alive & (vital_ct >= 1.5), region_valid

    alive, region_valid = body(torch.ones((g, nn), dtype=torch.bool,
                                          device=dev))
    while True:
        before = alive
        for _ in range(_ROUNDS_PER_CHECK):
            alive, region_valid = body(alive)
        if not bool((alive != before).any()):
            break

    pass_alive_stone = is_pla & alive.gather(1, chain_lab)

    at_least_one_pla = is_pla.any(dim=-1, keepdim=True)
    adj_to_pla = (B.shift4(stones, size, B.WALL)
                  == pla.reshape(-1, 1, 1)).any(dim=-2)
    internal = region_mask & ~adj_to_pla
    rl = torch.where(region_mask, region_lab, -1)
    n_internal = B.bincount_rows(rl, nn, internal.float(),
                                 dtype=torch.float32)
    contains_opp = B.bincount_rows(rl, nn, is_opp.float(),
                                   dtype=torch.float32) > 0.5

    borders_dead = ~region_valid
    small = (n_internal <= 1.5) & ~borders_dead & at_least_one_pla
    safe_big = safe_big_territories.unsqueeze(-1) & ~contains_opp & \
        ~borders_dead & at_least_one_pla
    region_marked = B.gather_rows(small | safe_big, region_lab) & region_mask
    unsafe = unsafe_big_territories.unsqueeze(-1) & \
        ~B.gather_rows(contains_opp, region_lab) & at_least_one_pla & \
        region_mask & is_empty & ~region_marked
    return pass_alive_stone | region_marked, unsafe


def calculate_area(stones, size: int, non_pass_alive_stones,
                   safe_big_territories, unsafe_big_territories,
                   suicide_legal) -> torch.Tensor:
    """int64[G, NN] area colors (0/1/2), mirroring Board::calculateArea."""
    g = stones.shape[0]
    dev = stones.device
    b_all, b_unsafe = pass_alive_area_for(
        stones, B.BLACK, suicide_legal, size, safe_big_territories,
        unsafe_big_territories)
    w_all, w_unsafe = pass_alive_area_for(
        stones, B.WHITE, suicide_legal, size, safe_big_territories,
        unsafe_big_territories)
    non_pa = _as_bool(non_pass_alive_stones, g, dev).unsqueeze(-1)
    result = torch.zeros_like(stones, dtype=torch.int64)
    result = torch.where(b_all, B.BLACK, result)
    result = torch.where(b_unsafe & (result == 0), B.BLACK, result)
    result = torch.where(w_all, B.WHITE, result)
    result = torch.where(w_unsafe & (result == 0), B.WHITE, result)
    result = torch.where(non_pa & (result == 0), stones.long(), result)
    return torch.where(stones == B.WALL, B.EMPTY, result)


def calculate_independent_life_area(stones, size: int, keep_territories,
                                    keep_stones, suicide_legal):
    """(area int64[G, NN], white_minus_black_region_count int64[G]),
    mirroring Board::calculateIndependentLifeArea (seki excluded)."""
    nn = size * size
    g = stones.shape[0]
    dev = stones.device
    basic = calculate_area(stones, size, True, True, True, suicide_legal)
    chain_lab = B.connected_labels(stones, size)
    libs = B.chain_liberties(stones, chain_lab, size)

    owned = basic != B.EMPTY
    nbr_s = B.shift4(stones, size, B.WALL)
    nbr_b = B.shift4(basic, size, B.WALL)
    touches_dame = ((nbr_s == B.EMPTY) & (nbr_b == B.EMPTY)).any(dim=-2)
    atari_own = (stones == basic) & owned & (libs == 1)
    seed = owned & (atari_own | touches_dame)

    idx = torch.arange(nn, device=dev)
    comp_vals = torch.where(owned, basic, idx + 8)
    comp = B.connected_labels(comp_vals, size)
    seki_c = B.bincount_rows(torch.where(owned & seed, comp, -1), nn)
    seki = owned & (seki_c.gather(1, comp) >= 1)
    result = torch.where(owned & ~seki, basic, B.EMPTY)

    is_root = owned & ~seki & (comp == idx)
    wmb = torch.where(is_root, torch.where(basic == B.WHITE, 1, -1),
                      0).sum(dim=-1)

    keep_t = _as_bool(keep_territories, g, dev).unsqueeze(-1)
    keep_s = _as_bool(keep_stones, g, dev).unsqueeze(-1)
    result = torch.where(keep_t & owned & (basic != stones), basic, result)
    result = torch.where(keep_s & owned & (basic == stones), basic, result)
    return result, wmb
