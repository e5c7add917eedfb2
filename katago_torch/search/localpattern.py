"""Local-pattern Zobrist hashing — port of katago_tpu/search/localpattern.py
(the reference's cpp/search/localpattern.{h,cpp} LocalPatternHasher).

The reference hashes the WxW window of board colors centered on a move
(off-board cells contribute nothing), the mover, and the atari status of
each stone in the window, into a Hash128. Two consumers:

  - subtree value bias (subtreevaluebiastable.cpp:19): 5x5 window, no
    atari keys, XOR'd with move-loc and ko-ban keys (search/mcts.py);
  - pattern bonus / avoid-repeated-shapes (patternbonustable.cpp:25): 9x9
    window, plus the 16 symmetry images (8 dihedral x color flip) via
    getHashWithSym (search/patternbonus.py).

Tables come from the same fixed-seed PCG64 draws, so hashes match the
JAX package bit for bit (uint32 lanes held in int64). `local_pattern_hash`
is batched over games on tensors; `host_pattern_hash` is the numpy
version for host-side bookkeeping (building pattern-bonus tables between
searches), bit-identical to it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from katago_torch.game import zobrist

_SEED = 0x70617474  # fixed constant ("patt")

# board color states: 0 empty, 1 black, 2 white (game/board.py)
_NUM_STATES = 3


@functools.lru_cache(maxsize=None)
def _tables_np(win: int):
    """Zobrist tables for a win x win window (win odd): uint32 arrays
    pattern [NUM_STATES, win*win, 2], pla [2, 2], atari [win*win, 2]."""
    assert win % 2 == 1 and win > 0
    rng = np.random.Generator(np.random.PCG64(_SEED + win))

    def draw(*shape):
        return rng.integers(0, 2**32, size=shape + (2,), dtype=np.uint32)

    return {"pattern": draw(_NUM_STATES, win * win), "pla": draw(2),
            "atari": draw(win * win)}


@functools.lru_cache(maxsize=None)
def sym_cell_perm(win: int) -> np.ndarray:
    """[8, win*win] int32: the cell each window cell maps to under
    dihedral symmetry s (bit0 transpose, bit1 flipX, bit2 flipY — the
    reference's SymmetryHelpers convention, getHashWithSym's symXY2)."""
    cells = np.arange(win * win)
    y, x = cells // win, cells % win
    out = np.zeros((8, win * win), np.int32)
    for s in range(8):
        sx = (win - x - 1) if (s & 2) else x
        sy = (win - y - 1) if (s & 4) else y
        out[s] = sx * win + sy if (s & 1) else sy * win + sx
    return out


@functools.lru_cache(maxsize=None)
def _tables(win: int, device: str):
    t = _tables_np(win)
    r = win // 2
    dy, dx = np.meshgrid(np.arange(-r, r + 1), np.arange(-r, r + 1),
                         indexing="ij")
    conv = lambda a: torch.from_numpy(  # noqa: E731
        np.asarray(a).astype(np.int64)).to(device)
    return (conv(t["pattern"]), conv(t["pla"]), conv(t["atari"]),
            conv(dy.reshape(-1)), conv(dx.reshape(-1)),
            conv(sym_cell_perm(win)))


def host_pattern_hash(stones: np.ndarray, loc: int, pla: int, size: int,
                      win: int, atari: np.ndarray | None = None,
                      symmetry: int = 0,
                      flip_colors: bool = False) -> np.ndarray:
    """getHash / getHashWithSym of one move in numpy: uint32[2]."""
    t = _tables_np(win)
    nn = size * size
    pla_eff = (3 - pla) if flip_colors else pla
    h = t["pla"][pla_eff - 1].copy()
    if not (0 <= loc < nn):
        return h
    perm = sym_cell_perm(win)[symmetry]
    r = win // 2
    y, x = loc // size, loc % size
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            ty, tx = y + dy, x + dx
            if not (0 <= ty < size and 0 <= tx < size):
                continue
            cell = perm[(dy + r) * win + (dx + r)]
            s = int(stones[ty * size + tx])
            if flip_colors and s > 0:
                s = 3 - s
            h = h ^ t["pattern"][s, cell]
            if atari is not None and s > 0 and atari[ty * size + tx]:
                h = h ^ t["atari"][cell]
    return h


def local_pattern_hash(stones, loc, pla, size: int, win: int, atari=None,
                       symmetry=None, flip_colors=None):
    """[G, 2] hash of the win x win window at loc[G] played by pla[G] on
    stones[G, NN] (the board before the move); an off-board loc hashes to
    the pla key alone. atari: optional bool[G, NN], stones of 1-liberty
    chains (None skips the atari keys). symmetry int[G] / flip_colors
    bool[G]: optional image of the 16 (getHashWithSym); None is the
    identity."""
    nn = size * size
    pattern, pla_t, atari_t, dy, dx, perm = _tables(win, str(stones.device))
    loc = loc.long()
    pla = pla.long()
    if flip_colors is not None:
        pla = torch.where(flip_colors, 3 - pla, pla)
    h = pla_t[(pla - 1).clamp(0, 1)]
    y = torch.div(loc, size, rounding_mode="floor").unsqueeze(-1)
    x = torch.remainder(loc, size).unsqueeze(-1)
    ty, tx = y + dy, x + dx
    valid = (ty >= 0) & (ty < size) & (tx >= 0) & (tx < size)
    loc2 = (ty * size + tx).clamp(0, nn - 1)
    state = stones.gather(1, loc2).long()
    if flip_colors is not None:
        state = torch.where(flip_colors.unsqueeze(-1) & (state > 0),
                            3 - state, state)
    # a WALL cell (rectangular boards) reads the last state's keys, as
    # the JAX gather clamps its out-of-range index
    state = state.clamp(max=pattern.shape[0] - 1)
    if symmetry is None:
        cell = torch.arange(dy.shape[0], device=stones.device).expand(
            state.shape)
    else:
        cell = perm[symmetry.long()]
    vals = torch.where(valid.unsqueeze(-1), pattern[state, cell], 0)
    if atari is not None:
        at_on = valid & (state > 0) & atari.gather(1, loc2)
        vals = vals ^ torch.where(at_on.unsqueeze(-1), atari_t[cell], 0)
    body = zobrist.xor_reduce(vals, dim=-2)
    on_board = ((loc >= 0) & (loc < nn)).unsqueeze(-1)
    return h ^ torch.where(on_board, body, 0)
