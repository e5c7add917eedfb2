"""Deterministic Zobrist hash tables — port of katago_tpu/game/zobrist.py.

The tables are rebuilt from the same PCG64 seed, so hashes match the JAX
package bit for bit. A 64-bit hash is a pair of uint32 lanes; torch's
uint32 support is patchy, so each lane is held in an int64 tensor
([..., 2], values in [0, 2^32)) where xor and equality are exact.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

MAX_BOARD_LEN = 19

_SEED = 0x6B61746167  # arbitrary fixed constant ("katag")

LANE_MASK = 0xFFFFFFFF


@functools.lru_cache(maxsize=None)
def _master_tables():
    rng = np.random.Generator(np.random.PCG64(_SEED))

    def draw(*shape):
        return rng.integers(0, 2**32, size=shape + (2,), dtype=np.uint32)

    return {
        "stone": draw(2, MAX_BOARD_LEN, MAX_BOARD_LEN),
        "player": draw(2),
        "ko_loc": draw(MAX_BOARD_LEN, MAX_BOARD_LEN),
        "encore": draw(3),
        "ko_mark": draw(MAX_BOARD_LEN, MAX_BOARD_LEN),
    }


def stone_table_np(size: int) -> np.ndarray:
    """uint32 [2, NN+1, 2]: [color-1, flat_loc, lane]; row NN is a zero pad
    so a pass (loc == NN) scatters/gathers harmlessly."""
    t = _master_tables()["stone"][:, :size, :size, :].reshape(
        2, size * size, 2)
    return np.concatenate([t, np.zeros((2, 1, 2), np.uint32)], axis=1)


def player_table_np() -> np.ndarray:
    """uint32 [2, 2]: player-to-move keys (index by player-1)."""
    return _master_tables()["player"]


def encore_table_np() -> np.ndarray:
    """uint32 [3, 2]: encore-phase keys; phase 0 is all-zero."""
    t = _master_tables()["encore"].copy()
    t[0] = 0
    return t


def ko_mark_table_np(size: int) -> np.ndarray:
    """uint32 [NN+1, 2]: encore ko-recapture-block mark keys, zero pad."""
    t = _master_tables()["ko_mark"][:size, :size, :].reshape(size * size, 2)
    return np.concatenate([t, np.zeros((1, 2), np.uint32)], axis=0)


@functools.lru_cache(maxsize=None)
def _cached(name: str, size: int, device: str) -> torch.Tensor:
    arr = {"stone": lambda: stone_table_np(size),
           "player": player_table_np,
           "encore": encore_table_np,
           "ko_mark": lambda: ko_mark_table_np(size)}[name]()
    return torch.from_numpy(arr.astype(np.int64)).to(device)


def stone_table(size: int, device) -> torch.Tensor:
    return _cached("stone", size, str(device))


def player_table(device) -> torch.Tensor:
    return _cached("player", 0, str(device))


def encore_table(device) -> torch.Tensor:
    return _cached("encore", 0, str(device))


def ko_mark_table(size: int, device) -> torch.Tensor:
    return _cached("ko_mark", size, str(device))



def xor_reduce(keys: torch.Tensor, dim: int) -> torch.Tensor:
    """XOR-reduce int64 uint32-lane values along `dim` (torch has no xor
    reduction): the parity of each of the 32 bit planes."""
    shifts = torch.arange(32, device=keys.device, dtype=torch.int64)
    bits = (keys.unsqueeze(-1) >> shifts) & 1
    d = dim if dim >= 0 else dim - 1
    parity = bits.sum(dim=d) & 1
    return (parity << shifts).sum(dim=-1)


def xor_reduce_masked(keys: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """keys [..., NN, 2], mask [..., NN] -> XOR of the masked rows [..., 2]."""
    return xor_reduce(torch.where(mask.unsqueeze(-1), keys,
                                  torch.zeros((), dtype=keys.dtype,
                                              device=keys.device)), dim=-2)


def segment_xor(values: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """values [G, N, W] int64 lanes, seg [G, N] in [0, num_segments] (the
    value num_segments drops) -> [G, num_segments, W] per-segment XOR."""
    g, n, w = values.shape
    shifts = torch.arange(32, device=values.device, dtype=torch.int64)
    bits = ((values.unsqueeze(-1) >> shifts) & 1).reshape(g, n, w * 32)
    out = torch.zeros((g, num_segments + 1, w * 32), dtype=torch.int64,
                      device=values.device)
    out.scatter_add_(1, seg.long().unsqueeze(-1).expand(g, n, w * 32), bits)
    parity = (out[:, :num_segments] & 1).reshape(g, num_segments, w, 32)
    return (parity << shifts).sum(dim=-1)


def mul_lane(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2^32 for uint32 lanes in int64, without signed overflow:
    b is split in 16-bit halves so every partial product stays < 2^48.
    b is a Python int or an int64 tensor (a Python int is never copied to
    the device, which would synchronise with it)."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & LANE_MASK
