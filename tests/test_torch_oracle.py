"""The port's rules engine and the plain versions of its two kernels
against the pure-Python oracles tests/oracle.py (board rules, Tromp-Taylor
score) and tests/oracle_ladder.py (the reference's ladder search) — exact,
on boards of every shape the engine takes (2x2 to 19x19). No JAX: these
hold the port to the rules themselves, where tests/test_torch_board.py and
tests/test_torch_ladder.py hold it to the JAX package."""

import numpy as np
import pytest
import torch

from katago_torch.game import board as TB
from katago_torch.game import ladder as TL
from katago_torch.ops import cases as CASES
from katago_torch.ops import labels as K2

from tests.oracle import OracleBoard
from tests.oracle_ladder import ladder_map_oracle

SIZES = (2, 3, 5, 7, 9, 13, 19)


def _components(values, size):
    """Flood-fill oracle for K2: each point's smallest flat index among
    the 4-connected points of equal value."""
    nn = size * size
    out = [-1] * nn
    for p in range(nn):
        if out[p] >= 0:
            continue
        comp, stack = [], [p]
        out[p] = p
        while stack:
            q = stack.pop()
            comp.append(q)
            y, x = divmod(q, size)
            for r, ok in ((q - size, y > 0), (q + size, y < size - 1),
                          (q - 1, x > 0), (q + 1, x < size - 1)):
                if ok and out[r] < 0 and values[r] == values[p]:
                    out[r] = p
                    stack.append(r)
        low = min(comp)
        for q in comp:
            out[q] = low
    return out


def _label_inputs(size, kind, seed):
    nn = size * size
    gen = torch.Generator().manual_seed(seed)
    if kind == "stones":
        return CASES.random_boards(6, size, seed)
    if kind == "values":            # any int32 values, negatives included
        return torch.randint(-2, 2, (6, nn), dtype=torch.int32,
                             generator=gen)
    return torch.cat(list(CASES.label_cases(size, 1, seed).values()))


@pytest.mark.parametrize("kind", ["stones", "values", "cases"])
@pytest.mark.parametrize("size", SIZES)
def test_connected_labels_match_flood_fill_oracle(size, kind):
    vals = _label_inputs(size, kind, size)
    before = K2.launches
    got = K2.connected_labels(vals, size)
    assert K2.launches == before        # CPU tensors take the plain version
    assert got.dtype == torch.int32 and got.shape == vals.shape
    ref = [_components(v, size) for v in vals.tolist()]
    assert got.tolist() == ref


def _oracle(stones, size, multi_suicide_legal=True):
    ob = OracleBoard(size, multi_suicide_legal)
    ob.stones = list(stones)
    return ob


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("size", [5, 9, 13, 19])
def test_chain_liberties_match_oracle(size, seed):
    st = CASES.random_boards(4, size, seed, density=(0.3, 0.8))
    libs = TB.chain_liberties(st, TB.connected_labels(st, size), size)
    for b, row in zip(st.tolist(), libs.tolist()):
        ob = _oracle(b, size)
        want = [len(ob.chain_and_libs(p)[1]) if b[p] else 0
                for p in range(size * size)]
        assert row == want


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("size", [2, 5, 9, 19])
def test_area_score_matches_oracle(size, seed):
    st = CASES.random_boards(4, size, seed, density=(0.2, 0.9))
    own, score = TB.area_score_tromp_taylor(st, size)
    for b, o, s in zip(st.tolist(), own.tolist(), score.tolist()):
        want_own, want_score = _oracle(b, size).area_score()
        assert o == want_own and s == want_score


@pytest.mark.parametrize("density", [(0.15, 0.6), CASES.DENSE])
@pytest.mark.parametrize("size", [5, 9, 19])
def test_random_boards_hold_only_chains_with_liberties(size, density):
    st = CASES.random_boards(8, size, size, density)
    assert st.dtype == torch.int32 and st.shape == (8, size * size)
    assert int(st.min()) >= 0 and int(st.max()) <= 2
    for b in st.tolist():
        ob = _oracle(b, size)
        assert all(ob.chain_and_libs(p)[1] for p in range(size * size)
                   if b[p])
    again = CASES.random_boards(8, size, size, density)
    assert torch.equal(st, again)        # made from the seed alone
    assert torch.equal(CASES.remove_dead(st, size), st)


@pytest.mark.parametrize("multi_suicide", [True, False])
@pytest.mark.parametrize("size", [2, 3, 5, 7])
def test_random_games_match_oracle_move_by_move(size, multi_suicide):
    """Legality of every point, stones, ko point and captures after each
    of 2 * NN random moves, in 4 games at once, on the small boards that
    the JAX comparisons (9x9 games) do not play."""
    g, nn = 4, size * size
    rng = np.random.default_rng(size * 10 + multi_suicide)
    obs = [OracleBoard(size, multi_suicide) for _ in range(g)]
    board = TB.empty_board(size, g, "cpu")
    ms = torch.full((g,), multi_suicide)
    player = 1
    for _ in range(2 * nn):
        legal = TB.legal_moves_basic(board, torch.full((g,), player), ms,
                                     size)
        moves = []
        for i, ob in enumerate(obs):
            want = [ob.is_legal(p, player) for p in range(nn)]
            assert legal[i].tolist() == want
            cand = [p for p in range(nn) if want[p]]
            pas = not cand or rng.random() < 0.05
            moves.append(nn if pas else int(rng.choice(cand)))
        board, info = TB.play_move(board, torch.tensor(moves),
                                   torch.full((g,), player), size)
        for i, ob in enumerate(obs):
            ncap = ob.play(moves[i], player)
            assert board.stones[i].tolist() == ob.stones
            assert int(board.ko_loc[i]) == ob.ko_loc
            assert int(info.num_captured[i]) == ncap
            assert bool(info.is_pass[i]) == (moves[i] == nn)
        player = 3 - player


def _pt(x, y, size):
    return y * size + x


def _ladder_cases(size):
    """The canonical ladders of tests/test_ladder_chase.py: a clean one
    across the board, breakers on and near its diagonal, attacker
    support, a corner breaker."""
    base = [0] * (size * size)
    base[_pt(2, 2, size)] = 2
    base[_pt(1, 2, size)] = base[_pt(2, 1, size)] = 1
    base[_pt(3, 1, size)] = 1
    extra = {"clean": {}, "breaker_on_diag": {(10, 10): 2},
             "breaker_near_diag": {(9, 10): 2},
             "attacker_support": {(10, 10): 1},
             "corner_breaker": {(18, 18): 2, (17, 18): 2}}
    out = {}
    for name, pts in extra.items():
        b = list(base)
        for (x, y), c in pts.items():
            b[_pt(x, y, size)] = c
        out[name] = b
    return out


LADDERS = ("clean", "breaker_on_diag", "breaker_near_diag",
           "attacker_support", "corner_breaker")


@pytest.fixture(scope="module")
def port_ladders():
    """The port's chase on all canonical ladders in one batch."""
    boards = _ladder_cases(19)
    st = torch.tensor([boards[n] for n in LADDERS], dtype=torch.int32)
    got = TL.ladder_map_chase_batch(st, 19)
    return boards, {n: (got.laddered[i].tolist(),
                        got.working_vs_black[i].tolist(),
                        got.working_vs_white[i].tolist())
                    for i, n in enumerate(LADDERS)}


@pytest.mark.parametrize("name", LADDERS)
def test_chase_matches_ladder_oracle_on_canonical_ladders(name,
                                                          port_ladders):
    size = 19
    boards, got = port_ladders
    assert got[name] == tuple(ladder_map_oracle(boards[name], size))
    if name == "clean":
        assert got[name][0][_pt(2, 2, size)]
