"""Seeded inputs for the two kernels, shared by chip_smoke.py (which
holds each kernel equal to its plain version on them) and the CPU tests
(which hold the plain versions equal to the JAX package on them).

K2 cases (`label_cases`) are shapes that make component labelling hard:
long winding components (a spiral, a serpentine), 361 singletons (a
checkerboard), one component covering the board, plus seeded random
mid-game boards. K1 boards: `chase_boards` are the main path's random
mid-game boards with ko and atari shapes; `chase_cases` adds positions
that drive lanes through every branch in chase.EVENTS: dense random
boards (suicide extensions, ko bans, captures of more than four stones,
double-ko shapes) and a ladder that runs the whole diagonal of the
board, once to its end and once cut by max_steps.

Boards are made on the CPU from a seed and returned there; the caller
moves them to its device.
"""

from __future__ import annotations

import torch

from katago_torch.ops import labels as K2

EMPTY, BLACK, WHITE = 0, 1, 2


def _nbr_any(mask: torch.Tensor, size: int) -> torch.Tensor:
    """bool[G, NN]: points with a 4-neighbour in mask."""
    m = mask.reshape(-1, size, size)
    out = torch.zeros_like(m)
    out[:, 1:, :] |= m[:, :-1, :]
    out[:, :-1, :] |= m[:, 1:, :]
    out[:, :, 1:] |= m[:, :, :-1]
    out[:, :, :-1] |= m[:, :, 1:]
    return out.reshape(mask.shape)


def remove_dead(stones: torch.Tensor, size: int) -> torch.Tensor:
    """Empty every chain without a liberty, so the board is a position
    that play can reach. int32[G, NN] -> int32[G, NN]."""
    lab = K2.connected_labels_plain(stones.to(torch.int32).cpu(), size).long()
    st = stones.cpu()
    touches = (st != EMPTY) & _nbr_any(st == EMPTY, size)
    alive = torch.zeros_like(lab).scatter_reduce(
        1, lab, touches.long(), "amax").gather(1, lab) > 0
    return torch.where((st != EMPTY) & ~alive, EMPTY, st).to(torch.int32)


def random_boards(g: int, size: int, seed: int, density=(0.15, 0.6)):
    """Seeded random boards with a share of occupied points drawn from
    `density` (mid-game by default), dead chains removed: int32[g, NN] on
    the CPU."""
    gen = torch.Generator().manual_seed(seed)
    nn = size * size
    lo, hi = density
    dens = torch.rand((g, 1), generator=gen) * (hi - lo) + lo
    u = torch.rand((g, nn), generator=gen)
    st = torch.where(u < dens / 2, BLACK, torch.where(u < dens, WHITE, EMPTY))
    return remove_dead(st, size)


def spiral(size: int) -> torch.Tensor:
    """A one-point-wide stone spiral walking inward from the corner with
    one empty point between its turns: two components (the spiral and the
    empty corridor), each as long and winding as the board allows."""
    b = [[EMPTY] * size for _ in range(size)]
    dirs = ((0, 1), (1, 0), (0, -1), (-1, 0))
    y = x = d = 0
    b[0][0] = BLACK
    turns = 0
    while turns < 2:
        dy, dx = dirs[d]
        ny, nx, fy, fx = y + dy, x + dx, y + 2 * dy, x + 2 * dx
        if (0 <= ny < size and 0 <= nx < size and b[ny][nx] == EMPTY
                and not (0 <= fy < size and 0 <= fx < size
                         and b[fy][fx] == BLACK)):
            y, x = ny, nx
            b[y][x] = BLACK
            turns = 0
        else:
            d = (d + 1) % 4
            turns += 1
    return torch.tensor(b, dtype=torch.int32).reshape(-1)


def serpentine(size: int) -> torch.Tensor:
    """Even rows full of stones, joined at alternate ends: one chain
    that runs the whole board back and forth."""
    b = torch.zeros((size, size), dtype=torch.int32)
    b[::2, :] = BLACK
    for r in range(1, size, 2):
        b[r, size - 1 if r % 4 == 1 else 0] = BLACK
    return b.reshape(-1)


def checkerboard(size: int) -> torch.Tensor:
    """Black and white alternating: every point its own component."""
    y, x = torch.meshgrid(torch.arange(size), torch.arange(size),
                          indexing="ij")
    return (BLACK + (y + x) % 2).to(torch.int32).reshape(-1)


def label_cases(size: int, g_random: int, seed: int) -> dict:
    """name -> int32[k, NN] boards for K2 (on the CPU)."""
    nn = size * size
    return {
        "spiral": spiral(size)[None],
        "serpentine": serpentine(size)[None],
        "checkerboard": checkerboard(size)[None],
        "full": torch.full((1, nn), BLACK, dtype=torch.int32),
        "empty": torch.zeros((1, nn), dtype=torch.int32),
        "random": random_boards(g_random, size, seed),
    }


def chase_boards(g: int, size: int, seed: int):
    """The main path's K1 boards: g seeded random mid-game boards, the
    first 8 with a lone white stone in atari inside a ko mouth and the
    next 8 with a ko point set. Returns (int32[g, NN] stones, int64[g] ko)
    on the CPU."""
    st = random_boards(g, size, seed)
    for i in range(min(8, g, (size - 4) // 2)):
        b = st[i].reshape(size, size)
        y, x = 3 + 2 * i, 3 + i
        b[y - 1:y + 2, x - 1:x + 2] = EMPTY
        b[y, x] = WHITE
        b[y - 1, x] = b[y, x - 1] = b[y, x + 1] = BLACK
    st = remove_dead(st, size)
    ko = torch.full((g,), -1, dtype=torch.int64)
    n = ko[8:16].numel()
    ko[8:16] = torch.arange(8, 8 + n) * 7
    return st, ko


DENSE = (0.6, 0.9)     # occupied share of the dense K1 boards


def ladder(size: int) -> torch.Tensor:
    """A white stone at (1, 1) against black at (0, 1), (1, 0) and (2, 0):
    once black ataris from the right, white runs a ladder down the whole
    diagonal of the board to the far edge (66 plies at 19x19)."""
    b = torch.zeros((size, size), dtype=torch.int32)
    b[1, 1] = WHITE
    b[0, 1] = b[1, 0] = b[2, 0] = BLACK
    return b.reshape(-1)


def chase_cases(size: int, g: int, seed: int, max_steps: int) -> dict:
    """name -> (int32[k, NN] stones, int64[k] ko, max_steps) for K1, on the
    CPU: g dense random boards, and the ladder with its transpose (the
    same ladder running the other way), to its end and cut at half of
    max_steps."""
    lad = ladder(size)
    lad = torch.stack([lad, lad.reshape(size, size).T.reshape(-1)])
    no_ko = torch.full((2,), -1, dtype=torch.int64)
    return {
        "dense": (random_boards(g, size, seed, DENSE),
                  torch.full((g,), -1, dtype=torch.int64), max_steps),
        "ladder": (lad, no_ko, max_steps),
        "ladder_cut": (lad, no_ko, max_steps // 2),
    }
