"""Local-pattern Zobrist hashing — the part of
katago_tpu/search/localpattern.py the search step uses (the subtree
value bias key's 5x5 window, no atari keys, no symmetry images).

Tables come from the same fixed-seed PCG64 draws, so hashes match the
JAX package bit for bit (uint32 lanes held in int64).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from katago_torch.game import zobrist

_SEED = 0x70617474  # fixed constant ("patt")
_NUM_STATES = 3


@functools.lru_cache(maxsize=None)
def _tables_np(win: int):
    assert win % 2 == 1 and win > 0
    rng = np.random.Generator(np.random.PCG64(_SEED + win))

    def draw(*shape):
        return rng.integers(0, 2**32, size=shape + (2,), dtype=np.uint32)

    return {"pattern": draw(_NUM_STATES, win * win), "pla": draw(2),
            "atari": draw(win * win)}


@functools.lru_cache(maxsize=None)
def _tables(win: int, device: str):
    t = _tables_np(win)
    r = win // 2
    dy, dx = np.meshgrid(np.arange(-r, r + 1), np.arange(-r, r + 1),
                         indexing="ij")
    conv = lambda a: torch.from_numpy(  # noqa: E731
        np.asarray(a).astype(np.int64)).to(device)
    return (conv(t["pattern"]), conv(t["pla"]), conv(dy.reshape(-1)),
            conv(dx.reshape(-1)))


def local_pattern_hash(stones, loc, pla, size: int, win: int):
    """[G, 2] hash of the win x win window at loc[G] played by pla[G] on
    stones[G, NN] (the board before the move); an off-board loc hashes to
    the pla key alone."""
    nn = size * size
    pattern, pla_t, dy, dx = _tables(win, str(stones.device))
    loc = loc.long()
    h = pla_t[(pla.long() - 1).clamp(0, 1)]
    y = torch.div(loc, size, rounding_mode="floor").unsqueeze(-1)
    x = torch.remainder(loc, size).unsqueeze(-1)
    ty, tx = y + dy, x + dx
    valid = (ty >= 0) & (ty < size) & (tx >= 0) & (tx < size)
    loc2 = (ty * size + tx).clamp(0, nn - 1)
    # a WALL cell (rectangular boards) reads the last state's keys, as
    # the JAX gather clamps its out-of-range index
    state = stones.gather(1, loc2).long().clamp(max=pattern.shape[0] - 1)
    cell = torch.arange(dy.shape[0], device=stones.device)
    pat = pattern[state, cell]                                  # [G, K, 2]
    vals = torch.where(valid.unsqueeze(-1), pat, 0)
    body = zobrist.xor_reduce(vals, dim=-2)
    on_board = ((loc >= 0) & (loc < nn)).unsqueeze(-1)
    return h ^ torch.where(on_board, body, 0)
