"""Plain Go board helpers on [G, NN] int boards (0 empty, 1 black,
2 white, 3 off-board pad), batched over boards in plain torch.

Connected labels: each point gets the smallest flat index reachable
through 4-connected points of equal value (neighbour-min propagation to
a fixpoint). Chain liberties: the number of distinct empty points
adjacent to each point's chain (0 on empty points).
"""

from __future__ import annotations

import torch

EMPTY, BLACK, WHITE, WALL = 0, 1, 2, 3
_BIG = 2 ** 31 - 1


def opponent(player):
    return 3 - player


def shift4(x: torch.Tensor, size: int, pad_val) -> torch.Tensor:
    """[..., 4, NN]: the neighbour at p+size, p-size, p+1, p-1 of each
    point, pad_val off the board."""
    lead = x.shape[:-1]
    x2 = x.reshape(lead + (size, size))
    row = torch.full(lead + (1, size), pad_val, dtype=x.dtype,
                     device=x.device)
    col = torch.full(lead + (size, 1), pad_val, dtype=x.dtype,
                     device=x.device)
    return torch.stack([torch.cat([x2[..., 1:, :], row], dim=-2),
                        torch.cat([row, x2[..., :-1, :]], dim=-2),
                        torch.cat([x2[..., :, 1:], col], dim=-1),
                        torch.cat([col, x2[..., :, :-1]], dim=-1)],
                       dim=-3).reshape(lead + (4, size * size))


def first_true(mask: torch.Tensor) -> torch.Tensor:
    """The lowest set index of each row, 0 when none is set."""
    n = mask.shape[-1]
    m = torch.where(mask, torch.arange(n, device=mask.device), n).amin(-1)
    return torch.where(m == n, 0, m)


def bincount_rows(idx: torch.Tensor, num_bins: int) -> torch.Tensor:
    """Per-row counts of idx [G, K] in [0, num_bins) (others dropped)."""
    g = idx.shape[0]
    flat = idx.reshape(g, -1).long()
    inb = (flat >= 0) & (flat < num_bins)
    out = torch.zeros((g, num_bins + 1), dtype=torch.int64,
                      device=idx.device)
    out.scatter_add_(1, torch.where(inb, flat, num_bins), inb.long())
    return out[:, :num_bins]


def labels(values: torch.Tensor, size: int) -> torch.Tensor:
    """int64[G, NN] min-index labels of equal-value components."""
    v = values.long()
    same = shift4(v, size, -1) == v.unsqueeze(-2)
    nn = size * size
    lab = torch.arange(nn, device=v.device).expand(v.shape).clone()
    while True:
        nb = torch.where(same, shift4(lab, size, _BIG), _BIG).amin(-2)
        new = torch.minimum(lab, nb)
        if torch.equal(new, lab):
            return lab
        lab = new


def stone_labels(stones, size):
    """Labels of stone chains; empty points keep their own index."""
    idx = torch.arange(size * size, device=stones.device)
    occ = (stones == BLACK) | (stones == WHITE)
    return torch.where(occ, labels(stones, size), idx)


def chain_liberties(stones, lab, size: int) -> torch.Tensor:
    nn = size * size
    s = stones.long()
    nbr_s = shift4(s, size, WALL)
    nbr_l = shift4(lab, size, nn)
    occ_n = (nbr_s == BLACK) | (nbr_s == WHITE)
    cand = torch.where((s == EMPTY).unsqueeze(-2) & occ_n, nbr_l, nn)
    rows = [cand[..., 0, :]]
    for k in range(1, 4):
        dup = torch.zeros_like(rows[0], dtype=torch.bool)
        for j in range(k):
            dup |= cand[..., k, :] == cand[..., j, :]
        rows.append(torch.where(dup, nn, cand[..., k, :]))
    counts = bincount_rows(torch.stack(rows, -2), nn)
    occ = (s == BLACK) | (s == WHITE)
    return torch.where(occ, counts.gather(1, lab.long()), 0)
