"""The port's SearchDriver.search vs katago_tpu's SearchDriver at 5x5 with
b1c6 in float32, the same seeded weights, selfplay params with root noise
off and no random symmetry, ladder planes on (the main path: per-node
ladder masks, the pre-root board's mask, the grandparent fallback): root
and child visit counts exact, root values within 1e-4.

The JAX side is the reference fixture tests/data/torch_ref/search.npz
(tools/make_torch_fixtures.py), made from the same roots and weights."""

import dataclasses

import numpy as np
import pytest
import torch

from katago_torch.game import history as TH
from katago_torch.game import ladder as TL
from katago_torch.search import mcts
from katago_torch.search.driver import SearchDriver as TDriver
from katago_torch.search.params import SearchParams as TParams

from tests import test_torch_common as C

REF, META = C.load_ref("search")
SIZE = META["size"]
VISITS = META["visits"]


def ref_roots(moves=None):
    """The fixture's roots played on the port."""
    moves = moves or META["moves"]
    t_roots = TH.new_game(SIZE, C.RULESETS["tromp_taylor"][1],
                          META["max_hist"], g=len(moves), device="cpu")
    for k in range(len(moves[0])):
        mv = np.array([m[k] for m in moves], np.int64)
        t_roots, _ = TH.step(t_roots, torch.from_numpy(mv), SIZE)
    return t_roots


def ref_params():
    return dataclasses.replace(TParams.for_selfplay(),
                               root_noise_enabled=False).to_arr("cpu")


def ref_driver(tm, tsp):
    return TDriver(tm, tsp, size=SIZE, max_nodes=META["max_nodes"],
                   chunk_size=META["chunk_size"], with_ladders=True,
                   device="cpu")


def check_result(t_res, prefix):
    """Visits, node counts and ladder masks exact; values within 1e-4."""
    for name in ("root_visits", "child_visits"):
        np.testing.assert_array_equal(C.to_np(getattr(t_res, name)),
                                      REF[prefix + name], err_msg=name)
    np.testing.assert_array_equal(C.to_np(t_res.ss.tree.num_nodes),
                                  REF[prefix + "num_nodes"])
    np.testing.assert_array_equal(C.to_np(t_res.ss.tree.laddered),
                                  REF[prefix + "laddered"])
    np.testing.assert_array_equal(C.to_np(t_res.ss.root_prev_laddered),
                                  REF[prefix + "root_prev_laddered"])
    for name in ("root_winloss", "root_score_mean", "root_lead",
                 "root_utility", "root_score_stdev", "child_winloss",
                 "child_score_mean", "root_ownership"):
        np.testing.assert_allclose(C.to_np(getattr(t_res, name)),
                                   REF[prefix + name], atol=1e-4, rtol=0,
                                   err_msg=name)
    np.testing.assert_array_equal(C.to_np(t_res.root_policy_prior),
                                  REF[prefix + "root_policy_prior"])


@pytest.fixture(scope="module")
def searches():
    tm = C.ref_model(SIZE)
    tsp = ref_params()
    t_roots = ref_roots()
    t_res = ref_driver(tm, tsp).search(
        t_roots, torch.Generator().manual_seed(0), max_visits=VISITS + 1)
    return t_res, tsp, t_roots, tm


def test_root_and_child_visits_exact(searches):
    t_res = searches[0]
    np.testing.assert_array_equal(C.to_np(t_res.root_visits),
                                  REF["s1/root_visits"])
    assert (C.to_np(t_res.root_visits) == VISITS + 1).all()
    np.testing.assert_array_equal(C.to_np(t_res.child_visits),
                                  REF["s1/child_visits"])
    np.testing.assert_array_equal(C.to_np(t_res.ss.tree.num_nodes),
                                  REF["s1/num_nodes"])
    # the ladder masks that reached the features: per node, pre-root
    np.testing.assert_array_equal(C.to_np(t_res.ss.tree.laddered),
                                  REF["s1/laddered"])
    np.testing.assert_array_equal(C.to_np(t_res.ss.root_prev_laddered),
                                  REF["s1/root_prev_laddered"])
    assert C.to_np(t_res.ss.root_prev_laddered).any(1).all()
    assert C.to_np(t_res.ss.tree.laddered).any(-1).sum(1).min() > 1


def test_root_values_within_tolerance(searches):
    check_result(searches[0], "s1/")


def test_choose_moves_greedy_and_step(searches):
    t_res, tsp, t_roots, _ = searches
    tsp = dataclasses.replace(tsp, chosen_move_temperature=torch.tensor(0.0),
                              chosen_move_temperature_early=torch.tensor(0.0))
    moves = mcts.choose_moves(t_res, tsp, t_roots.pos.move_num,
                              torch.Generator().manual_seed(1))
    best = torch.argmax(t_res.child_visits, dim=1)
    np.testing.assert_array_equal(
        C.to_np(t_res.child_visits.gather(1, moves[:, None]))[:, 0],
        C.to_np(t_res.child_visits.gather(1, best[:, None]))[:, 0])
    legal = TH.legal_moves(t_roots, SIZE)
    assert C.to_np(legal.gather(1, moves[:, None])).all()
    nxt, _ = TH.step(t_roots, moves, SIZE)
    assert (C.to_np(nxt.pos.move_num) == C.to_np(t_roots.pos.move_num) + 1).all()


def test_ladders_on_search_with_noise(searches):
    _, tsp, t_roots, tm = searches
    tsp = dataclasses.replace(tsp, root_noise_enabled=torch.tensor(True),
                              nn_random_symmetry=torch.tensor(True))
    td = TDriver(tm, tsp, size=SIZE, max_nodes=VISITS + 3,
                 chunk_size=VISITS // 2, device="cpu")
    res = td.search(t_roots, torch.Generator().manual_seed(4),
                    max_visits=VISITS + 1)
    assert (C.to_np(res.root_visits) == VISITS + 1).all()
    assert (C.to_np(res.child_visits).sum(1) == VISITS).all()
    prior = C.to_np(res.root_policy_prior)
    legal = prior >= 0
    np.testing.assert_allclose((prior * legal).sum(1), 1.0, atol=2e-3)
    assert np.isfinite(C.to_np(res.root_utility)).all()


def test_exact_ladder_mode_search_caches_exact_masks(searches):
    """With ladder_mode "exact" the search's per-node ladder masks are
    the exact solver's on each node's board, and the pre-root mask the
    solver's on the board before the root."""
    _, tsp, t_roots, tm = searches
    td = TDriver(tm, tsp, size=SIZE, max_nodes=META["max_nodes"],
                 chunk_size=META["chunk_size"], ladder_mode="exact",
                 device="cpu")
    res = td.search(t_roots, torch.Generator().manual_seed(0),
                    max_visits=VISITS + 1)
    assert (C.to_np(res.root_visits) == VISITS + 1).all()
    tree = res.ss.tree
    for g in range(tree.num_nodes.shape[0]):
        n = int(tree.num_nodes[g])
        want = TL.ladder_map_batch(tree.pos.board.stones[g, :n], SIZE,
                                   ko_loc=tree.pos.simple_ko_loc[g, :n])
        np.testing.assert_array_equal(C.to_np(tree.laddered[g, :n]),
                                      C.to_np(want.laddered))
    prev = TL.ladder_map_batch(t_roots.pos.prev_stones.to(torch.int32), SIZE,
                               ko_loc=t_roots.pos.prev_ko_loc)
    np.testing.assert_array_equal(C.to_np(res.ss.root_prev_laddered),
                                  C.to_np(prev.laddered))
    assert C.to_np(tree.laddered).any()
