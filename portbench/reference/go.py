"""Plain Go for the selfplay cell, in numpy and plain torch: seeded
random games (uniform among legal moves that neither fill an own eye,
nor retake a simple ko, nor commit suicide), KataGo's Board::
calculateArea (Benson pass-alive analysis, then territories), and the V7
input planes and globals of KataGo's NNInputs::fillRowV7 under
Tromp-Taylor-like rules (area scoring, positional superko, suicide
legal, komi 7.5, no encore, no button).

Boards are flat [NN] / [G, NN] arrays: 0 empty, 1 black, 2 white.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import board as RB
from portbench.reference import chase as RC

EMPTY, BLACK, WHITE = 0, 1, 2
KOMI = 7.5


def neighbours(size: int) -> list[list[int]]:
    out = []
    for p in range(size * size):
        y, x = divmod(p, size)
        out.append([q for q, ok in ((p - size, y > 0),
                                    (p + size, y < size - 1),
                                    (p - 1, x > 0), (p + 1, x < size - 1))
                    if ok])
    return out


def _chain(board, p, nbrs):
    """(points of p's chain, its liberties)."""
    color = board[p]
    seen, libs, stack = {p}, set(), [p]
    while stack:
        q = stack.pop()
        for r in nbrs[q]:
            if board[r] == EMPTY:
                libs.add(r)
            elif board[r] == color and r not in seen:
                seen.add(r)
                stack.append(r)
    return seen, libs


def play(board, p, color, nbrs):
    """Play color at p in place; returns (captured points, legal). An
    illegal move (suicide) leaves the board as it was."""
    opp = 3 - color
    board[p] = color
    captured = []
    for r in nbrs[p]:
        if board[r] == opp:
            pts, libs = _chain(board, r, nbrs)
            if not libs:
                captured.extend(pts)
                for q in pts:
                    board[q] = EMPTY
    if not captured and not _chain(board, p, nbrs)[1]:
        board[p] = EMPTY
        return [], False
    return captured, True


def play_tt(board, p, color, nbrs):
    """Play color at p in place under Tromp-Taylor-like rules (multi-stone
    suicide legal, single-stone suicide not): (legal, simple-ko point or
    -1). An illegal move leaves the board as it was."""
    if board[p] != EMPTY:
        return False, -1
    opp = 3 - color
    board[p] = color
    captured = []
    for r in nbrs[p]:
        if board[r] == opp:
            pts, libs = _chain(board, r, nbrs)
            if not libs:
                captured.extend(pts)
                for q in pts:
                    board[q] = EMPTY
    own, libs = _chain(board, p, nbrs)
    if not libs:
        if len(own) == 1:
            board[p] = EMPTY
            return False, -1
        for q in own:
            board[q] = EMPTY
        return True, -1
    single = len(captured) == 1 and len(own) == 1 and len(libs) == 1
    return True, captured[0] if single else -1


class Game:
    """A game replayed from the empty board by these rules (black first;
    a move is a point, or size * size for a pass): the board, its
    simple-ko point and the two boards before it with theirs, the mover,
    the moves and the passes in a row."""

    def __init__(self, size: int):
        self.size, self.nn = size, size * size
        self.nbrs = neighbours(size)
        self.board, self.ko = [EMPTY] * self.nn, -1
        self.back = [(tuple(self.board), -1)] * 2   # one, two moves ago
        self.color, self.moves, self.passes = BLACK, [], 0

    def copy(self) -> "Game":
        g = Game.__new__(Game)
        g.__dict__.update(self.__dict__)
        g.board, g.back, g.moves = list(self.board), list(self.back), \
            list(self.moves)
        return g

    def play(self, m: int) -> bool:
        """Play the mover's move m; False (and the game unchanged) if it is
        illegal here."""
        before = (tuple(self.board), self.ko)
        if m == self.nn:
            ko = -1
            self.passes += 1
        else:
            legal, ko = play_tt(self.board, m, self.color, self.nbrs)
            if not legal or m == self.ko:
                self.board = list(before[0])
                return False
            self.passes = 0
        self.back = [before, self.back[0]]
        self.ko = ko
        self.moves.append(m)
        self.color = 3 - self.color
        return True


def leaf_inputs(games: list, device) -> dict:
    """features_v7's inputs for replayed games: their boards, movers,
    recent moves (most recent first, -1 before the game's start), move
    numbers, turns, passes in a row, game-over flags, simple-ko points and
    the boards one and two moves back with their simple-ko points."""
    def t(x, dt=torch.int64):
        return torch.tensor(x, dtype=dt, device=device)
    recent = [(g.moves[::-1] + [-1] * 8)[:8] for g in games]
    n = [len(g.moves) for g in games]
    return dict(stones=t([g.board for g in games]),
                to_move=t([g.color for g in games]), recent_moves=t(recent),
                move_num=t(n), turns_this_phase=t(n),
                consec_passes=t([g.passes for g in games]),
                game_over=t([g.passes >= 2 for g in games], torch.bool),
                simple_ko_loc=t([g.ko for g in games]),
                prev=(t([g.back[0][0] for g in games]),
                      t([g.back[0][1] for g in games]),
                      t([g.back[1][0] for g in games]),
                      t([g.back[1][1] for g in games])))


def random_games(g: int, size: int, seed: int, max_plies: int):
    """g games of lengths spread evenly over [0, max_plies], the same set
    for every seed, in a seeded order: (moves per game, final boards
    int8[g, NN]). Black moves first."""
    rng = np.random.default_rng(seed)
    nbrs = neighbours(size)
    lengths = rng.permutation(np.rint(np.linspace(0, max_plies, g))
                              .astype(int))
    games, boards = [], np.zeros((g, size * size), np.int8)
    for i in range(g):
        board, ko, color, moves = [EMPTY] * (size * size), -1, BLACK, []
        while len(moves) < lengths[i]:
            order = rng.permutation(size * size)
            for p in order:
                p = int(p)
                if board[p] != EMPTY or p == ko:
                    continue
                if all(board[r] == color for r in nbrs[p]):
                    continue           # an own eye
                captured, legal = play(board, p, color, nbrs)
                if not legal:
                    continue
                single = len(captured) == 1 and \
                    len(_chain(board, p, nbrs)[0]) == 1 and \
                    len(_chain(board, p, nbrs)[1]) == 1
                ko = captured[0] if single else -1
                moves.append(p)
                color = 3 - color
                break
            else:
                raise RuntimeError("no move left to play")
        games.append(moves)
        boards[i] = board
    return games, boards


def _regions(mask, nbrs):
    """Component id of every point of `mask` (-1 elsewhere)."""
    comp = np.full(len(mask), -1)
    n = 0
    for p in range(len(mask)):
        if mask[p] and comp[p] < 0:
            comp[p] = n
            stack = [p]
            while stack:
                q = stack.pop()
                for r in nbrs[q]:
                    if mask[r] and comp[r] < 0:
                        comp[r] = n
                        stack.append(r)
            n += 1
    return comp, n


def _area_for(board, pla, nbrs):
    """One player's (pass-alive or owned region points, unsafe big
    territory points) under multi-stone-suicide-legal rules."""
    nn = len(board)
    opp = 3 - pla
    is_pla = board == pla
    region_mask = board != pla
    chains, n_chains = _regions(is_pla, nbrs)
    # chains of one colour only: split the stone mask by colour
    regions, n_reg = _regions(region_mask, nbrs)
    adj = [set() for _ in range(n_reg)]          # region -> adjacent chains
    vital_ok = [dict() for _ in range(n_reg)]    # chain -> all counted adj
    counting = [[] for _ in range(n_reg)]
    for p in range(nn):
        if regions[p] >= 0:
            counting[regions[p]].append(p)
            for r in nbrs[p]:
                if chains[r] >= 0:
                    adj[regions[p]].add(chains[r])
    for k in range(n_reg):
        for c in adj[k]:
            vital_ok[k][c] = all(any(chains[r] == c for r in nbrs[p])
                                 for p in counting[k])
    alive = np.ones(n_chains, bool)
    while True:
        valid = [all(alive[c] for c in adj[k]) for k in range(n_reg)]
        vital_ct = np.zeros(n_chains, int)
        for k in range(n_reg):
            if valid[k]:
                for c, ok in vital_ok[k].items():
                    vital_ct[c] += ok
        new = alive & (vital_ct >= 2)
        if (new == alive).all():
            break
        alive = new
    valid = [all(alive[c] for c in adj[k]) for k in range(n_reg)]
    mark = np.array([is_pla[p] and alive[chains[p]] for p in range(nn)])
    unsafe = np.zeros(nn, bool)
    if not is_pla.any():
        return mark, unsafe
    for k in range(n_reg):
        pts = counting[k]
        internal = sum(1 for p in pts
                       if not any(board[r] == pla for r in nbrs[p]))
        has_opp = any(board[p] == opp for p in pts)
        if valid[k] and (internal <= 1 or not has_opp):
            mark[pts] = True
        elif not has_opp:
            for p in pts:
                unsafe[p] = board[p] == EMPTY
    return mark, unsafe


def area(board, nbrs) -> np.ndarray:
    """Board::calculateArea(nonPassAliveStones, safeBigTerritories,
    unsafeBigTerritories all true, multi-stone suicide legal)."""
    board = np.asarray(board)
    b_all, b_unsafe = _area_for(board, BLACK, nbrs)
    w_all, w_unsafe = _area_for(board, WHITE, nbrs)
    res = np.zeros(len(board), np.int64)
    res[b_all] = BLACK
    res[b_unsafe & (res == 0)] = BLACK
    res[w_all] = WHITE
    res[w_unsafe & (res == 0)] = WHITE
    rest = res == 0
    res[rest] = board[rest]
    return res


def features_v7(stones, to_move, recent_moves, move_num, turns_this_phase,
                consec_passes, game_over, simple_ko_loc, size: int,
                prev=None):
    """V7 planes float32[G, NN, 22] and globals float32[G, 19] of leaves,
    from their boards, movers and recent moves. prev: (stones, ko) of the
    boards one and two moves back, flattened to four tensors, for planes
    15 and 16 (the laddered stones of those boards, as far back as the
    turns reach); without it they are NaN. Plane 6 (ko-ban: needs the
    game's hash history) is NaN; `check_features` holds the NaN planes
    otherwise."""
    dev = stones.device
    g = stones.shape[0]
    nn = size * size
    nbrs = neighbours(size)
    s = stones.long()
    pla = to_move.long().unsqueeze(-1)
    opp = 3 - pla
    f = torch.zeros((g, nn, 22), device=dev)
    gl = torch.zeros((g, 19), device=dev)
    f[..., 0] = 1.0
    f[..., 1] = (s == pla).float()
    f[..., 2] = (s == opp).float()
    libs = RB.chain_liberties(s, RB.stone_labels(s, size), size)
    occ = s != EMPTY
    for i, n in enumerate((1, 2, 3)):
        f[..., 3 + i] = (occ & (libs == n)).float()
    f[..., 6] = float("nan")
    max_turns = torch.where(game_over, 1, 5)
    amount = torch.minimum(max_turns, turns_this_phase)
    gi = torch.arange(g, device=dev)
    for k in range(5):
        mv = recent_moves[:, k]
        have = (amount > k) & (move_num > k)
        on = have & (mv >= 0) & (mv < nn)
        plane = torch.zeros((g, nn + 1), device=dev)
        plane[gi, mv.clamp(0, nn)] = on.float()
        f[..., 9 + k] = plane[:, :nn]
        gl[:, k] = (have & (mv >= nn)).float()
    lad, w_black, w_white = RC.ladder_map(s, size, simple_ko_loc.long())
    f[..., 14] = lad.float()
    if prev is None:
        f[..., 15] = float("nan")
        f[..., 16] = float("nan")
    else:
        s1, ko1, s2, ko2 = prev
        lad1 = RC.ladder_map(s1.long(), size, ko1.long())[0]
        lad2 = RC.ladder_map(s2.long(), size, ko2.long())[0]
        lad15 = torch.where((amount >= 1).unsqueeze(-1), lad1, lad)
        f[..., 15] = lad15.float()
        f[..., 16] = torch.where((amount >= 2).unsqueeze(-1), lad2,
                                 lad15).float()
    f[..., 17] = torch.where(opp == BLACK, w_black, w_white).float()
    own = torch.from_numpy(np.stack([area(b, nbrs) for b in
                                     s.cpu().numpy()])).to(dev)
    f[..., 18] = (own == pla).float()
    f[..., 19] = (own == opp).float()
    sk = torch.where(to_move == WHITE, KOMI, -KOMI).float()
    gl[:, 5] = sk * 0.05
    gl[:, 6] = 1.0            # positional superko
    gl[:, 7] = 0.5
    gl[:, 8] = 1.0            # multi-stone suicide legal
    gl[:, 14] = ((consec_passes >= 1) & ~game_over).float()
    odd = nn % 2 == 1
    floor = torch.floor((sk - 1.0) / 2.0) * 2.0 + 1.0 if odd else \
        torch.floor(sk / 2.0) * 2.0
    delta = torch.clamp(sk - floor, 0.0, 2.0)
    gl[:, 18] = torch.where(delta < 0.5, delta,
                            torch.where(delta < 1.5, 1.0 - delta,
                                        delta - 2.0))
    return f, gl


def check_features(got_sp, got_gl, ref_sp, ref_gl, stones, simple_ko_loc,
                   game_over) -> int:
    """Entries that differ: every plane the reference computes exactly,
    the globals, and plane 6 held to what can be checked without the hash
    history (only empty points are banned, and the simple-ko point is);
    planes 15 and 16, where the reference left them NaN, only to be 0 or
    1."""
    exact = ~torch.isnan(ref_sp)
    bad = int((got_sp[exact] != ref_sp[exact]).sum())
    bad += int((got_gl != ref_gl).sum())
    g, nn = stones.shape
    ko = got_sp[..., 6]
    bad += int(((ko != 0) & (stones != EMPTY)).sum())
    has_ko = (simple_ko_loc >= 0) & ~game_over
    gi = torch.arange(g, device=stones.device)
    bad += int((has_ko & (ko[gi, simple_ko_loc.clamp(0, nn - 1)] != 1)).sum())
    for k in (15, 16):
        p = got_sp[..., k][torch.isnan(ref_sp[..., k])]
        bad += int(((p != 0) & (p != 1)).sum())
    return bad
