"""In-search chase ladder solver — port of the chase half of
katago_tpu/game/ladder.py (`_stone_labels`, `_chain_lib_points`,
`_lowest_k`, `_chase_setup`, `_chase_finish`, `ladder_map_chase`,
`ladder_map_chase_batch`), batched over boards.

The per-lane solve (`_chase_one` / `_chase_apply` /
`_would_be_ko_capture_at`) lives in ops/chase.py beside its CUDA kernel
(K1): `ladder_map_chase_batch` builds 2 * max_chains query lanes per
board and solves all of them in one `chase_lanes` call, as the JAX
package's TPU path does. The backtracking `ladder_map` is not ported yet.
"""

from __future__ import annotations

import dataclasses

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


def _chain_lib_points(stones, labels, rep, size):
    """bool[G, K, NN]: empty points adjacent to the chain containing
    rep[G, K]."""
    lrep = labels.gather(1, rep)                              # [G, K]
    chain = (labels.unsqueeze(1) == lrep.unsqueeze(-1)) & \
        (stones != B.EMPTY).unsqueeze(1)
    dil = (B.shift4(chain.to(torch.int8), size, 0) > 0).any(dim=-2)
    return (stones == B.EMPTY).unsqueeze(1) & dil


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
    labels = _stone_labels(stones, size)
    libs = B.chain_liberties(stones, labels, size)
    occupied = (stones == B.BLACK) | (stones == B.WHITE)
    idx = torch.arange(nn, device=stones.device)
    is_head = occupied & (labels == idx) & (libs >= 1) & (libs <= 2)
    heads = _lowest_k(is_head, max_chains)                    # [G, K]
    head_ok = heads < nn
    h = heads.clamp(max=nn - 1)
    hdef = stones.gather(1, h).long()
    hlibcnt = libs.gather(1, h)
    libpts = _lowest_k(_chain_lib_points(stones, labels, h, size), 2)
    ko = ko.long().unsqueeze(-1)
    reps = torch.cat([h, h], 1)
    defenders = torch.cat([hdef, hdef], 1)
    pre_a = torch.where((hlibcnt == 2) & (libpts[..., 0] < nn),
                        libpts[..., 0], -1)
    pre_b = torch.where(libpts[..., 1] < nn, libpts[..., 1], -1)
    act_a = head_ok & ((hlibcnt == 1)
                       | ((hlibcnt == 2) & (libpts[..., 0] < nn)
                          & (libpts[..., 0] != ko)))
    act_b = head_ok & (hlibcnt == 2) & (libpts[..., 1] < nn) & \
        (libpts[..., 1] != ko)
    return dict(labels=labels, libs=libs, occupied=occupied, h=h,
                head_ok=head_ok, hdef=hdef, hlibcnt=hlibcnt, libpts=libpts,
                reps=reps, defenders=defenders,
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
