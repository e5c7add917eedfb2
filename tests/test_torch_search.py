"""The port's SearchDriver.search vs katago_tpu.search.driver.SearchDriver
at 5x5 with b1c6 in float32, the same carried weights, selfplay params
with root noise off and no random symmetry, ladder planes on (the main
path: per-node ladder masks, the pre-root board's mask, the grandparent
fallback): root and child visit counts exact, root values within 1e-4.

The roots are played on the port and handed to JAX as the same
GameState; the JAX search is the module's one compile."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from katago_tpu.models import config as JC
from katago_tpu.models.model import KataGoModel as JModel
from katago_tpu.search.driver import SearchDriver as JDriver
from katago_tpu.search.params import SearchParams as JParams
from katago_torch.game import history as TH
from katago_torch.models import config as TC
from katago_torch.models import model as TM
from katago_torch.models import weights as TW
from katago_torch.search import mcts
from katago_torch.search.driver import SearchDriver as TDriver
from katago_torch.search.params import SearchParams as TParams

from tests import test_torch_common as C

SIZE = 5
VISITS = 24
# both roots hold laddered stones, and so do the boards before them
MOVES = [[20, 6, 2, 8, 11], [20, 2, 5, 7, 4]]


@pytest.fixture(scope="module")
def searches():
    g = len(MOVES)
    jm = JModel(JC.get_config("b1c6"), pos_len=SIZE, dtype=jnp.float32)
    params = C.flax_params(jm, SIZE, seed=3)
    tm = TM.KataGoModel(TC.get_config("b1c6"), pos_len=SIZE,
                        dtype=torch.float32)
    tm.load_state_dict(TW.from_flax_params(
        jax.tree.map(np.asarray, params["params"])))
    t_roots = TH.new_game(SIZE, C.RULESETS["tromp_taylor"][1], 64, g=g,
                          device="cpu")
    for k in range(len(MOVES[0])):
        mv = np.array([m[k] for m in MOVES], np.int64)
        t_roots, _ = TH.step(t_roots, torch.from_numpy(mv), SIZE)
    j_roots = C.jax_games_like(t_roots, SIZE)
    jsp = dataclasses.replace(JParams.for_selfplay(),
                              root_noise_enabled=False).to_arr()
    tsp = dataclasses.replace(TParams.for_selfplay(),
                              root_noise_enabled=False).to_arr("cpu")
    jd = JDriver(jm.apply, params, jsp, size=SIZE, max_nodes=VISITS + 3,
                 chunk_size=VISITS // 2, with_ladders=True)
    j_res = jd.search(j_roots, jax.random.PRNGKey(0), max_visits=VISITS + 1)
    td = TDriver(tm, tsp, size=SIZE, max_nodes=VISITS + 3,
                 chunk_size=VISITS // 2, with_ladders=True, device="cpu")
    t_res = td.search(t_roots, torch.Generator().manual_seed(0),
                      max_visits=VISITS + 1)
    return j_res, t_res, tsp, t_roots, tm


def test_root_and_child_visits_exact(searches):
    j_res, t_res = searches[:2]
    np.testing.assert_array_equal(C.to_np(t_res.root_visits),
                                  np.asarray(j_res.root_visits))
    assert (C.to_np(t_res.root_visits) == VISITS + 1).all()
    np.testing.assert_array_equal(C.to_np(t_res.child_visits),
                                  np.asarray(j_res.child_visits))
    np.testing.assert_array_equal(C.to_np(t_res.ss.tree.num_nodes),
                                  np.asarray(j_res.ss.tree.num_nodes))
    # the ladder masks that reached the features: per node, pre-root
    np.testing.assert_array_equal(C.to_np(t_res.ss.tree.laddered),
                                  np.asarray(j_res.ss.tree.laddered))
    np.testing.assert_array_equal(C.to_np(t_res.ss.root_prev_laddered),
                                  np.asarray(j_res.ss.root_prev_laddered))
    assert C.to_np(t_res.ss.root_prev_laddered).any(1).all()
    assert C.to_np(t_res.ss.tree.laddered).any(-1).sum(1).min() > 1


def test_root_values_within_tolerance(searches):
    j_res, t_res = searches[:2]
    for name in ("root_winloss", "root_score_mean", "root_lead",
                 "root_utility", "root_score_stdev", "child_winloss",
                 "child_score_mean", "root_ownership"):
        np.testing.assert_allclose(C.to_np(getattr(t_res, name)),
                                   np.asarray(getattr(j_res, name)),
                                   atol=1e-4, rtol=0, err_msg=name)
    np.testing.assert_array_equal(C.to_np(t_res.root_policy_prior),
                                  np.asarray(j_res.root_policy_prior))


def test_choose_moves_greedy_and_step(searches):
    _, t_res, tsp, t_roots, _ = searches
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
    _, _, tsp, t_roots, tm = searches
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
