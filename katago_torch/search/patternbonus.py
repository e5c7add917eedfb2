"""Pattern bonus / avoid-repeated-shapes — port of
katago_tpu/search/patternbonus.py (the reference's
cpp/search/patternbonustable.{h,cpp} and searchparams.h
avoidRepeatedPatternUtility).

The reference keeps a table of 9x9 local-pattern hashes -> white-utility
bonuses. Before every search with avoidRepeatedPatternUtility != 0, the
current game's own past moves (of the player the search is for) are
inserted with a penalty, in all 16 symmetry images, so the engine avoids
replaying its own shapes (search.cpp:715-727).

The table is built on the host between searches (numpy hashing,
PatternBonusTable) and moved to the device as two small tensors (keys,
bonus). In the tree, a freshly inserted node hashes its move's 9x9
window (search/localpattern.py) and takes the bonus of the matching key,
if any: a [G, P] compare. The bonus enters the node's recomputed utility
where the reference adds it (search.cpp:1073; search/mcts.py
C_PATTERN_BONUS).

As in the JAX package, the atari keys of the reference's hash are left
out on both the build and the probe side (in-tree atari status would
cost a liberty pass per playout), so patterns that differ only in atari
status share a key.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from katago_torch.game import board as B
from katago_torch.search import localpattern as LP

PATTERN_WIN = 9  # the reference's patternHasher.init(9,9) window


@dataclasses.dataclass
class PatternBonusArrs:
    """Device form of the table, shared by the [G] batch."""
    keys: torch.Tensor    # int64[P, 2] uint32 lanes; all-ones rows empty
    bonus: torch.Tensor   # float32[P] white-utility bonus per key


class PatternBonusTable:
    """Host-side hash -> bonus map (PatternBonusTable, minus file IO)."""

    def __init__(self):
        self.entries: dict[tuple[int, int], float] = {}

    def add_bonus(self, stones: np.ndarray, move_loc: int, pla: int,
                  size: int, bonus: float, seen: set | None = None) -> None:
        """Add `bonus` for this move's pattern in all 16 symmetry images
        (addBonus, patternbonustable.cpp:58-100). `seen` dedups within one
        game, so a shape repeated in the game is penalized once."""
        for sym in range(8):
            for flip in (False, True):
                h = LP.host_pattern_hash(stones, move_loc, pla, size,
                                         PATTERN_WIN, symmetry=sym,
                                         flip_colors=flip)
                key = (int(h[0]), int(h[1]))
                if seen is not None:
                    if key in seen:
                        continue
                    seen.add(key)
                self.entries[key] = self.entries.get(key, 0.0) + bonus

    def add_game_moves(self, boards_before: list[np.ndarray],
                       moves: list[int], plas: list[int], size: int,
                       bonus: float, only_pla: int | None = None) -> None:
        """addBonusForGameMoves: one entry per (board before, move) of
        only_pla (of both players when None)."""
        seen: set = set()
        for stones, mv, pla in zip(boards_before, moves, plas):
            if only_pla is not None and pla != only_pla:
                continue
            if not (0 <= mv < size * size):
                continue
            self.add_bonus(np.asarray(stones), mv, pla, size, bonus, seen)

    def to_arrays(self, device) -> PatternBonusArrs:
        """Pack into device tensors, padded to the next power of two
        above the entry count (at least 16)."""
        n = len(self.entries)
        p = max(16, 1 << int(np.ceil(np.log2(max(n, 1) + 1))))
        keys = np.full((p, 2), 0xFFFFFFFF, np.uint32)
        bonus = np.zeros((p,), np.float32)
        for i, ((k0, k1), b) in enumerate(self.entries.items()):
            keys[i] = (k0, k1)
            bonus[i] = b
        return PatternBonusArrs(
            keys=torch.from_numpy(keys.astype(np.int64)).to(device),
            bonus=torch.from_numpy(bonus).to(device))


def lookup(arrs: PatternBonusArrs, stones, move_loc, pla, size: int):
    """float32[G]: the white-utility bonus for each game's move_loc played
    by pla on stones[G, NN] (0 where the pattern is unknown)."""
    h = LP.local_pattern_hash(stones, move_loc, pla, size, PATTERN_WIN)
    hit = (arrs.keys[None, :, 0] == h[:, None, 0]) & \
        (arrs.keys[None, :, 1] == h[:, None, 1])
    return torch.sum(torch.where(hit, arrs.bonus, 0.0), dim=-1)


def build_avoid_repeat_table(boards_before, moves, plas, size: int,
                             pla_for: int, avoid_utility: float, device
                             ) -> PatternBonusArrs | None:
    """The per-search avoidRepeatedPatternUtility table
    (search.cpp:719-725): penalize pla_for's own past shapes. The bonus
    is to WHITE's utility: white searching gets -u, black +u. None when
    there is nothing to avoid (the search then runs none of the code)."""
    if avoid_utility == 0.0 or not moves:
        return None
    t = PatternBonusTable()
    bonus = -avoid_utility if pla_for == B.WHITE else avoid_utility
    t.add_game_moves(boards_before, moves, plas, size, bonus,
                     only_pla=pla_for)
    if not t.entries:
        return None
    return t.to_arrays(device)
