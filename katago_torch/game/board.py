"""Batched Go board engine — port of katago_tpu/game/board.py.

A batch of G boards is a set of [G, NN] tensors (NN = size*size, flat
row-major locations, PASS == NN). Every operation is a batched tensor
function with the same semantics as the JAX package's per-game function
under vmap:

  * stones: int32[G, NN] (0 empty / 1 black / 2 white / 3 wall)
  * chains: connected-component labels from ops.labels (the K2 kernel on
    CUDA), exact per-chain liberty counts by scatter-add of deduplicated
    (empty point, adjacent chain) pairs
  * position hash: two uint32 lanes held in int64 ([G, 2], game/zobrist.py)

The JAX package's ops/lookup.py one-hot gathers were TPU workarounds; the
port indexes directly (gather / scatter_add_).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from katago_torch.game import zobrist
from katago_torch.ops import labels as K2

EMPTY = 0
BLACK = 1
WHITE = 2
WALL = 3  # value of the pad slot, never equal to any on-board value

INT_MAX = 2 ** 31 - 1


def opponent(player):
    return 3 - player


@functools.lru_cache(maxsize=None)
def neighbor_table_np(size: int) -> np.ndarray:
    """int64[NN, 4] flat neighbor indices (left, right, up, down);
    off-board -> NN (pad slot)."""
    nn = size * size
    neigh = np.full((nn, 4), nn, dtype=np.int64)
    for y in range(size):
        for x in range(size):
            p = y * size + x
            if x > 0:
                neigh[p, 0] = p - 1
            if x < size - 1:
                neigh[p, 1] = p + 1
            if y > 0:
                neigh[p, 2] = p - size
            if y < size - 1:
                neigh[p, 3] = p + size
    return neigh


@functools.lru_cache(maxsize=None)
def _neighbor_table(size: int, device: str) -> torch.Tensor:
    return torch.from_numpy(neighbor_table_np(size)).to(device)


def neighbor_table(size: int, device) -> torch.Tensor:
    return _neighbor_table(size, str(device))


@dataclasses.dataclass
class BoardState:
    """Batched board position (no history)."""
    stones: torch.Tensor    # int32[G, NN]
    ko_loc: torch.Tensor    # int64[G]: simple-ko banned loc or -1
    pos_hash: torch.Tensor  # int64[G, 2]: zobrist xor of stones


@dataclasses.dataclass
class MoveInfo:
    num_captured: torch.Tensor       # int64[G]
    num_self_captured: torch.Tensor  # int64[G]
    is_pass: torch.Tensor            # bool[G]
    captured_mask: torch.Tensor      # bool[G, NN]


def empty_board(size: int, g: int, device) -> BoardState:
    nn = size * size
    return BoardState(
        stones=torch.zeros((g, nn), dtype=torch.int32, device=device),
        ko_loc=torch.full((g,), -1, dtype=torch.int64, device=device),
        pos_hash=torch.zeros((g, 2), dtype=torch.int64, device=device))


def pad_last(x: torch.Tensor, value) -> torch.Tensor:
    """Append one `value` slot on the last axis ([..., NN] -> [..., NN+1])."""
    return torch.cat([x, torch.full(x.shape[:-1] + (1,), value,
                                    dtype=x.dtype, device=x.device)], -1)


def shift4(x: torch.Tensor, size: int, pad_val) -> torch.Tensor:
    """[..., 4, NN]: row d holds each point's d-direction neighbour value
    (p+size, p-size, p+1, p-1), pad_val off-board — the JAX shift4 order."""
    lead = x.shape[:-1]
    x2 = x.reshape(lead + (size, size))
    row = torch.full(lead + (1, size), pad_val, dtype=x.dtype,
                     device=x.device)
    col = torch.full(lead + (size, 1), pad_val, dtype=x.dtype,
                     device=x.device)
    up = torch.cat([x2[..., 1:, :], row], dim=-2)
    down = torch.cat([row, x2[..., :-1, :]], dim=-2)
    left = torch.cat([x2[..., :, 1:], col], dim=-1)
    right = torch.cat([col, x2[..., :, :-1]], dim=-1)
    return torch.stack([up, down, left, right], dim=-3).reshape(
        lead + (4, size * size))


def connected_labels(values: torch.Tensor, size: int) -> torch.Tensor:
    """int64[G, NN] labels of equal-value components (K2 on CUDA)."""
    return K2.connected_labels(values.to(torch.int32).contiguous(),
                               size).long()


def first_true(mask: torch.Tensor) -> torch.Tensor:
    """jnp.argmax of a bool mask over its last axis: the lowest set index,
    0 when none is set."""
    n = mask.shape[-1]
    idx = torch.arange(n, device=mask.device)
    m = torch.where(mask, idx, n).amin(dim=-1)
    return torch.where(m == n, 0, m)


def bincount_rows(idx: torch.Tensor, num_bins: int,
                  weights: torch.Tensor | None = None,
                  dtype=torch.int64) -> torch.Tensor:
    """Per-row bincount: idx [G, K] (out of [0, num_bins) drops) ->
    [G, num_bins] sums of weights (default 1)."""
    g = idx.shape[0]
    flat = idx.reshape(g, -1)
    inb = (flat >= 0) & (flat < num_bins)
    safe = torch.where(inb, flat, num_bins).long()
    w = (torch.ones_like(flat, dtype=dtype) if weights is None
         else weights.reshape(g, -1).to(dtype))
    w = torch.where(inb, w, torch.zeros((), dtype=dtype, device=w.device))
    out = torch.zeros((g, num_bins + 1), dtype=dtype, device=idx.device)
    out.scatter_add_(1, safe, w)
    return out[:, :num_bins]


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [G, M] read at idx [G, ...]; out-of-range indices read 0."""
    g, m = table.shape
    flat = idx.reshape(g, -1)
    inb = (flat >= 0) & (flat < m)
    out = table.gather(1, torch.where(inb, flat, 0).long())
    out = torch.where(inb, out, torch.zeros((), dtype=table.dtype,
                                             device=table.device))
    return out.reshape(idx.shape)


def dedup_dirs(cand: torch.Tensor, pad: int) -> torch.Tensor:
    """cand [..., 4, NN]: replace a direction's label by pad when an
    earlier direction holds the same label (count each chain once)."""
    rows = [cand[..., 0, :]]
    for k in range(1, 4):
        dup = torch.zeros_like(rows[0], dtype=torch.bool)
        for j in range(k):
            dup = dup | (cand[..., k, :] == cand[..., j, :])
        rows.append(torch.where(dup, pad, cand[..., k, :]))
    return torch.stack(rows, dim=-2)


def chain_liberties(stones: torch.Tensor, labels: torch.Tensor,
                    size: int) -> torch.Tensor:
    """int64[G, NN]: exact liberty count of each point's chain (0 on empty
    points)."""
    nn = size * size
    is_empty = stones == EMPTY
    nbr_s = shift4(stones, size, WALL)
    nbr_lab = shift4(labels, size, nn)
    nbr_occ = (nbr_s == BLACK) | (nbr_s == WHITE)
    cand = torch.where(is_empty.unsqueeze(-2) & nbr_occ, nbr_lab, nn)
    cand = dedup_dirs(cand, nn)
    counts = bincount_rows(cand, nn)
    libs = counts.gather(1, labels)
    occupied = (stones == BLACK) | (stones == WHITE)
    return torch.where(occupied, libs, 0)


def legal_moves_basic(board: BoardState, player: torch.Tensor,
                      multi_suicide_legal: torch.Tensor,
                      size: int) -> torch.Tensor:
    """bool[G, NN]: legality ignoring superko (empty, ko ban, suicide)."""
    nn = size * size
    stones = board.stones
    labels = connected_labels(stones, size)
    libs = chain_liberties(stones, labels, size)
    nbr_s = shift4(stones, size, WALL)
    nbr_libs = shift4(libs, size, 0)
    pl = player.reshape(-1, 1, 1)
    opp = opponent(pl)
    is_empty = stones == EMPTY
    has_empty_nbr = (nbr_s == EMPTY).any(dim=-2)
    own_safe = ((nbr_s == pl) & (nbr_libs >= 2)).any(dim=-2)
    captures = ((nbr_s == opp) & (nbr_libs == 1)).any(dim=-2)
    own_any = (nbr_s == pl).any(dim=-2)
    suicide = ~has_empty_nbr & ~own_safe & ~captures
    legal_suicide = suicide & multi_suicide_legal.unsqueeze(-1) & own_any
    idx = torch.arange(nn, device=stones.device)
    not_ko = idx != board.ko_loc.unsqueeze(-1)
    return is_empty & not_ko & (~suicide | legal_suicide)


def play_move(board: BoardState, loc: torch.Tensor, player: torch.Tensor,
              size: int) -> tuple[BoardState, MoveInfo]:
    """Apply loc (assumed basic-legal, or PASS == NN) for player, per game."""
    nn = size * size
    dev = board.stones.device
    neigh = neighbor_table(size, dev)
    zst = zobrist.stone_table(size, dev)          # [2, NN+1, 2]
    loc = loc.long()
    player = player.long()
    is_pass = loc >= nn
    loc_c = loc.clamp(0, nn)
    opp = opponent(player)
    g = loc.shape[0]
    gi = torch.arange(g, device=dev)

    stones1 = pad_last(board.stones, EMPTY)
    stones1[gi, loc_c] = torch.where(is_pass, EMPTY, player).to(
        stones1.dtype)
    stones1 = stones1[:, :nn]

    labels = connected_labels(stones1, size)
    libs = chain_liberties(stones1, labels, size)
    captured = (stones1 == opp.unsqueeze(-1)) & (libs == 0)
    num_captured = captured.sum(dim=-1)
    stones2 = torch.where(captured, EMPTY, stones1)

    lab_at = pad_last(labels, nn)[gi, loc_c]
    libs_at = pad_last(libs, 0)[gi, loc_c]
    is_suicide = ~is_pass & (num_captured == 0) & (libs_at == 0)
    own_chain = (labels == lab_at.unsqueeze(-1)) & \
        (stones1 == player.unsqueeze(-1))
    self_captured = is_suicide.unsqueeze(-1) & own_chain
    num_self = self_captured.sum(dim=-1)
    stones3 = torch.where(self_captured, EMPTY, stones2)

    key_place = torch.where(is_pass.unsqueeze(-1), 0,
                            zst[player - 1, loc_c])
    h = board.pos_hash ^ key_place
    h = h ^ zobrist.xor_reduce_masked(zst[opp - 1, :nn], captured)
    h = h ^ zobrist.xor_reduce_masked(zst[player - 1, :nn], self_captured)

    nbr_after = pad_last(stones3, WALL).gather(
        1, neigh[loc.clamp(0, nn - 1)])                       # [G, 4]
    own_nbr_after = (nbr_after == player.unsqueeze(-1)).any(dim=-1)
    empty_nbrs_after = (nbr_after == EMPTY).sum(dim=-1)
    is_ko = ~is_pass & (num_captured == 1) & ~own_nbr_after & \
        (empty_nbrs_after == 1)
    ko_loc_new = torch.where(is_ko, first_true(captured), -1)

    new_board = BoardState(stones=stones3, ko_loc=ko_loc_new, pos_hash=h)
    info = MoveInfo(num_captured=num_captured, num_self_captured=num_self,
                    is_pass=is_pass, captured_mask=captured | self_captured)
    return new_board, info


def area_score_tromp_taylor(stones: torch.Tensor, size: int):
    """(ownership int64[G, NN] +1 black / -1 white / 0 dame, score_diff
    float32[G] = black points - white points, no komi)."""
    nn = size * size
    labels = connected_labels(stones, size)
    is_empty = stones == EMPTY
    nbr_s = shift4(stones, size, WALL)
    touches_black = is_empty & (nbr_s == BLACK).any(dim=-2)
    touches_white = is_empty & (nbr_s == WHITE).any(dim=-2)
    lab_e = torch.where(is_empty, labels, -1)
    tb = bincount_rows(torch.where(touches_black, lab_e, -1), nn)
    tw = bincount_rows(torch.where(touches_white, lab_e, -1), nn)
    region_black = (tb.gather(1, labels) >= 1) & \
        (tw.gather(1, labels) == 0) & is_empty
    region_white = (tw.gather(1, labels) >= 1) & \
        (tb.gather(1, labels) == 0) & is_empty
    ownership = torch.where(
        stones == BLACK, 1, torch.where(
            stones == WHITE, -1, torch.where(
                region_black, 1, torch.where(region_white, -1, 0))))
    return ownership, ownership.sum(dim=-1).float()


def board_to_string(stones, size: int) -> str:
    """One row of X (black), O (white), . (empty), # (wall) per board row."""
    chars = {EMPTY: ".", BLACK: "X", WHITE: "O", WALL: "#"}
    return "\n".join("".join(chars[int(stones[y * size + x])]
                             for x in range(size)) for y in range(size))
