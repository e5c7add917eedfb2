"""The port's rules engine (katago_torch.game) vs katago_tpu.game: labels
(K2's plain version and its contract), liberties, legality, stepping,
zobrist hashes, scoring and graph hashing — all exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from katago_tpu.game import board as JB
from katago_tpu.game import graphhash as JGH
from katago_tpu.game import history as JH
from katago_tpu.game import zobrist as JZ
from katago_tpu.ops.labels_pallas import connected_labels_batch
from katago_torch.game import board as TB
from katago_torch.game import graphhash as TGH
from katago_torch.game import history as TH
from katago_torch.game import zobrist as TZ
from katago_torch.ops import cases as CASES
from katago_torch.ops import labels as K2

from tests import test_torch_common as C


@pytest.mark.parametrize("size,g", [(5, 3), (9, 8), (19, 4)])
def test_connected_labels_match_jax_and_pallas_contract(size, g):
    """Random values plus the adversarial K2 cases of ops/cases.py (a
    spiral, a serpentine, a checkerboard, a full and an empty board)."""
    rng = np.random.default_rng(size * 100 + g)
    nn = size * size
    shapes = [v.numpy() for k, v in CASES.label_cases(size, 0, 0).items()
              if k != "random"]
    vals = np.concatenate(shapes + [rng.integers(0, 3, (g, nn))]
                          ).astype(np.int32)
    ref = np.asarray(jax.jit(jax.vmap(
        lambda v: JB.connected_labels(v, size)))(jnp.asarray(vals)))
    pallas = np.asarray(connected_labels_batch(jnp.asarray(vals), size))
    ours = C.to_np(K2.connected_labels(torch.from_numpy(vals), size))
    np.testing.assert_array_equal(ours, ref)
    # The Pallas kernel runs a fixed 2 * ceil(log2 NN) + 4 rounds, too few
    # for the 19x19 spiral (ROADMAP Queue 3): there it is the JAX side that
    # is wrong, so its contract is held on the other boards.
    keep = np.ones(len(vals), bool)
    keep[0] = size < 19
    np.testing.assert_array_equal(ours[keep], pallas[keep])


@pytest.mark.parametrize("size", [5, 9, 19])
def test_label_cases_have_the_components_they_claim(size):
    cases = CASES.label_cases(size, 2, 1)
    ncomp = {k: len(np.unique(C.to_np(K2.connected_labels(v, size))))
             for k, v in cases.items() if k != "random"}
    assert ncomp == {"spiral": 2, "serpentine": 1 + size // 2,
                     "checkerboard": size * size, "full": 1, "empty": 1}
    spiral = C.to_np(cases["spiral"][0])
    # one stone chain holding about half of the board
    assert spiral.sum() > size * size // 2 - size
    rnd = C.to_np(cases["random"])
    assert rnd.shape == (2, size * size) and (rnd > 0).any()


def test_serpentine_chain_labels():
    size = 9
    stones = np.zeros((size, size), np.int32)
    stones[::2, :] = JB.BLACK
    for r in range(1, size, 2):           # connect rows alternately
        stones[r, size - 1 if r % 4 == 1 else 0] = JB.BLACK
    flat = stones.reshape(1, -1)
    ours = C.to_np(K2.connected_labels(torch.from_numpy(flat), size))
    ref = np.asarray(JB.connected_labels(jnp.asarray(flat[0]), size))
    np.testing.assert_array_equal(ours[0], ref)
    assert (ours[0][flat[0] == JB.BLACK] == 0).all()


def test_liberties_and_basic_legality_on_random_boards():
    size, g = 9, 6
    boards = C.random_boards(size, g, 11)
    st = torch.from_numpy(boards)
    lab = TB.connected_labels(st, size)
    libs = TB.chain_liberties(st, lab, size)
    jl = jax.jit(jax.vmap(lambda s: JB.chain_liberties(
        s, JB.connected_labels(s, size), size)))(jnp.asarray(boards))
    np.testing.assert_array_equal(C.to_np(libs), np.asarray(jl))
    for player in (JB.BLACK, JB.WHITE):
        board = TB.BoardState(st, torch.full((g,), -1),
                              torch.zeros((g, 2), dtype=torch.int64))
        ours = TB.legal_moves_basic(board, torch.full((g,), player),
                                    torch.tensor([True, False] * (g // 2)),
                                    size)
        ref = jax.jit(jax.vmap(lambda s, ms: JB.legal_moves_basic(
            JB.BoardState(s, jnp.int32(-1), jnp.zeros((2,), jnp.uint32)),
            jnp.int32(player), ms, size)))(
            jnp.asarray(boards), jnp.asarray([True, False] * (g // 2)))
        np.testing.assert_array_equal(C.to_np(ours), np.asarray(ref))
    own, score = TB.area_score_tromp_taylor(st, size)
    jown, jscore = jax.jit(jax.vmap(
        lambda s: JB.area_score_tromp_taylor(s, size)))(
        jnp.asarray(boards))
    np.testing.assert_array_equal(C.to_np(own), np.asarray(jown))
    np.testing.assert_array_equal(C.to_np(score), np.asarray(jscore))


def test_zobrist_tables_bit_exact():
    for size in (9, 19):
        np.testing.assert_array_equal(
            C.to_np(TZ.stone_table(size, "cpu")),
            JZ.stone_table(size).astype(np.int64))
        np.testing.assert_array_equal(
            C.to_np(TZ.ko_mark_table(size, "cpu")),
            JZ.ko_mark_table(size).astype(np.int64))
    np.testing.assert_array_equal(C.to_np(TZ.player_table("cpu")),
                                  JZ.player_table().astype(np.int64))
    np.testing.assert_array_equal(C.to_np(TZ.encore_table("cpu")),
                                  JZ.encore_table().astype(np.int64))


@pytest.mark.parametrize("rules_name,seed", [("tromp_taylor", 0),
                                             ("japanese", 1)])
def test_random_games_step_legality_hashes_and_score(rules_name, seed):
    size = 9

    def check(j_gs, t_gs):
        C.assert_tree_equal(j_gs, t_gs, skip=("rules",))

    j_gs, t_gs = C.random_games(size, 4, 36, rules_name, seed, pass_prob=0.05,
                                check=check)
    # end every game with passes so territory games walk the encore too
    nn = size * size
    for _ in range(6):
        passes = np.full((4,), nn, np.int32)
        j_gs = C.jax_fns(size)["step"](j_gs, jnp.asarray(passes))
        t_gs, _ = TH.step(t_gs, torch.from_numpy(passes.astype(np.int64)),
                          size)
        check(j_gs, t_gs)
    assert C.to_np(t_gs.pos.game_over).all()
    j_own, j_score = C.jax_fns(size)["score"](j_gs)
    t_own, t_score = TH.final_score(t_gs, size)
    np.testing.assert_array_equal(C.to_np(t_own), np.asarray(j_own))
    np.testing.assert_array_equal(C.to_np(t_score), np.asarray(j_score))


def test_graph_hash_functions_bit_exact():
    size, g = 9, 8
    rng = np.random.default_rng(5)
    boards = C.random_boards(size, g, 6)
    kh = rng.integers(0, 2**32, (g, 2), dtype=np.uint32)
    prev = rng.integers(0, 2**32, (g, 2), dtype=np.uint32)
    over = rng.random(g) < 0.3
    consec = rng.integers(0, 3, g).astype(np.int32)
    loc = rng.integers(-1, size * size + 1, g).astype(np.int32)
    reset = rng.random(g) < 0.5
    j_state = jax.jit(jax.vmap(JGH.state_hash))(jnp.asarray(kh), jnp.asarray(over),
                                       jnp.asarray(consec))
    t_state = TGH.state_hash(torch.from_numpy(kh.astype(np.int64)),
                             torch.from_numpy(over),
                             torch.from_numpy(consec.astype(np.int64)))
    np.testing.assert_array_equal(C.to_np(t_state),
                                  np.asarray(j_state).astype(np.int64))
    j_step = jax.jit(jax.vmap(JGH.graph_hash_step))(jnp.asarray(prev), j_state,
                                           jnp.asarray(reset))
    t_step = TGH.graph_hash_step(torch.from_numpy(prev.astype(np.int64)),
                                 t_state, torch.from_numpy(reset))
    np.testing.assert_array_equal(C.to_np(t_step),
                                  np.asarray(j_step).astype(np.int64))
    j_rep = jax.jit(jax.vmap(lambda s, l_: JGH.simple_repetition_bound_gt(
        s, size, l_, 11)))(jnp.asarray(boards), jnp.asarray(loc))
    t_rep = TGH.simple_repetition_bound_gt(
        torch.from_numpy(boards), size, torch.from_numpy(loc.astype(np.int64)),
        11)
    np.testing.assert_array_equal(C.to_np(t_rep), np.asarray(j_rep))


def test_history_ko_hash_matches_for_situational_rules():
    size = 5
    jr, tr = C.RULESETS["tromp_taylor"]
    import dataclasses
    jr = dataclasses.replace(jr, ko_rule=2)
    tr = dataclasses.replace(tr, ko_rule=2)
    j_gs = JH.new_game(size, JH.RulesArr.from_rules(jr), 16)
    t_gs = TH.new_game(size, tr, 16, g=1, device="cpu")
    np.testing.assert_array_equal(
        C.to_np(t_gs.ko_hash_hist[0]),
        np.asarray(j_gs.ko_hash_hist).astype(np.int64))
