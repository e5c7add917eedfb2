"""Graph-search transposition hashing — port of katago_tpu/game/graphhash.py
(reference cpp/game/graphhash.{h,cpp}), batched over games.

Hashes are uint32 lane pairs held in int64 (game/zobrist.py); lane
multiplications wrap mod 2^32 exactly as the JAX uint32 arithmetic.
"""

from __future__ import annotations

import functools

import torch

from katago_torch.game import board as B
from katago_torch.game import zobrist

GAME_IS_OVER_KEY = (0x9E3779B9, 0x7F4A7C15)
CONSEC_PASS_MULT = (0xDEADBEE7, 0x85EBCA6B)
MAX_REP_BOUND = 15

_M = zobrist.LANE_MASK


@functools.lru_cache(maxsize=None)
def _lane_constants(device: str):
    """The two-lane keys as int64[2] tensors, copied to a device once."""
    return tuple(torch.tensor(k, dtype=torch.int64, device=device)
                 for k in (GAME_IS_OVER_KEY, CONSEC_PASS_MULT))


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 per uint32 lane."""
    x = x ^ (x >> 16)
    x = zobrist.mul_lane(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = zobrist.mul_lane(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def state_hash(ko_hash, game_over, consec_passes) -> torch.Tensor:
    """GraphHash::getStateHash: ko hash folded with game-over and the
    consecutive ending-pass count. [G, 2] lanes."""
    over_key, mult = _lane_constants(str(ko_hash.device))
    h = ko_hash ^ torch.where(game_over.unsqueeze(-1), over_key, 0)
    return (h + zobrist.mul_lane(consec_passes.long().unsqueeze(-1) & _M,
                                 mult)) & _M


def graph_hash_step(prev_graph, state_h, reset) -> torch.Tensor:
    """GraphHash::getGraphHash: reset to the state hash when the local
    region bounds out repetition, else mix the parent's hash in."""
    mixed = (_mix32(prev_graph ^ prev_graph.flip(-1)) + state_h) & _M
    return torch.where(reset.unsqueeze(-1), state_h, mixed)


def simple_repetition_bound_gt(stones, size: int, loc, bound):
    """Board::simpleRepetitionBoundGt per game: size of the moved-to chain
    plus its adjacent empty regions > bound (exact for bound <= 15)."""
    nn = size * size
    dev = stones.device
    loc = loc.long()
    on_board = (loc >= 0) & (loc < nn)
    lc = loc.clamp(0, nn - 1)
    idx = torch.arange(nn, device=dev)
    point = idx == lc.unsqueeze(-1)
    st_lc = stones.gather(1, lc.unsqueeze(-1))
    is_stone = on_board & (st_lc[:, 0] != B.EMPTY)
    empty = stones == B.EMPTY
    same_chain_medium = (stones == st_lc) & ~empty

    def grow(mask, medium, rounds):
        for _ in range(rounds):
            grown = (B.shift4(mask.to(torch.int8), size, 0) > 0).any(dim=-2)
            mask = mask | (grown & medium)
        return mask

    chain = grow(point & is_stone.unsqueeze(-1), same_chain_medium,
                 MAX_REP_BOUND + 1)
    adj_chain = (B.shift4(chain.to(torch.int8), size, 0) > 0).any(dim=-2)
    empty_seed = torch.where(is_stone.unsqueeze(-1), empty & adj_chain,
                             point & empty & on_board.unsqueeze(-1))
    region = grow(empty_seed, empty, MAX_REP_BOUND + 1)
    total = chain.sum(dim=-1) + region.sum(dim=-1)
    bound_c = torch.as_tensor(bound, device=dev).long().clamp(
        max=MAX_REP_BOUND)
    return on_board & (total > bound_c)
