"""Tree reuse in the port (mcts.extract_subtree, init_search /
run_search / SearchDriver.search with prev_tree and prev_actions) vs
katago_tpu at 5x5 with b1c6 in float32.

extract_subtree is held exactly, field by field, against the JAX
function (one small jit) on the port's own search trees, for every
action of both games: expanded, unexpanded and pass children. The reused
search is held against the fixture tests/data/torch_ref/search.npz:
visits and node counts exact, values within 1e-4."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from katago_tpu.search import mcts as JM
from katago_torch import _tensortree as T
from katago_torch.game import history as TH
from katago_torch.search import mcts

from tests import test_torch_common as C
from tests import test_torch_search as S

SIZE = S.SIZE
NODES = S.META["max_nodes"]


@pytest.fixture(scope="module")
def first():
    """The port's first search of the fixture (equal to JAX's: see
    test_torch_search) and its model and params."""
    tm = C.ref_model(SIZE)
    tsp = S.ref_params()
    roots = S.ref_roots()
    res = S.ref_driver(tm, tsp).search(
        roots, torch.Generator().manual_seed(0), max_visits=S.VISITS + 1)
    return res, tm, tsp, roots


def _jax_tree_like(t_tree):
    g = t_tree.num_nodes.shape[0]
    struct = jax.eval_shape(lambda: jax.vmap(
        lambda _: JM.empty_tree(SIZE, NODES))(jnp.arange(g)))
    return C.to_jax_like(struct, t_tree)


@pytest.fixture(scope="module")
def dense_tree():
    """A search tree from two dense seeded boards: with few legal moves
    the pass child of game 1's root is expanded."""
    roots = TH.new_game(SIZE, C.RULESETS["tromp_taylor"][1], 64, g=2,
                        device="cpu")
    roots = TH.setup_board(roots, torch.from_numpy(
        C.random_boards(SIZE, 2, 0, 0.5, 0.7)), SIZE)
    res = S.ref_driver(C.ref_model(SIZE), S.ref_params()).search(
        roots, torch.Generator().manual_seed(0), max_visits=S.VISITS + 1)
    return res.ss.tree


def test_extract_subtree_matches_jax_for_every_action(first, dense_tree):
    tree = C.tree_cat(first[0].ss.tree, dense_tree)
    g, a = tree.num_nodes.shape[0], SIZE * SIZE + 1
    children = C.to_np(tree.children[:, 0])
    # the trees hold expanded, unexpanded and pass children
    assert (children >= 0).any() and (children < 0).any()
    assert (children[:, a - 1] >= 0).any()
    actions = np.tile(np.arange(-1, a), g)                   # -1: no move
    reps = a + 1
    t_rep = T.tree_map(lambda x: x.repeat_interleave(reps, dim=0), tree)
    got = mcts.extract_subtree(t_rep, torch.from_numpy(actions))
    ref = jax.jit(jax.vmap(jax.vmap(JM.extract_subtree, in_axes=(None, 0)),
                           in_axes=(0, None)))(
        _jax_tree_like(tree), jnp.arange(-1, a, dtype=jnp.int32))
    ref = jax.tree.map(lambda x: x.reshape((g * reps,) + x.shape[2:]), ref)
    C.assert_tree_equal(ref, got)
    assert got.children.dtype == torch.int16
    nodes = C.to_np(got.num_nodes).reshape(g, reps)
    assert (nodes[:, 0] == 0).all()                          # action -1
    np.testing.assert_array_equal(nodes[:, 1:] == 0, children < 0)


def test_reused_search_matches_jax(first):
    res, tm, tsp, roots = first
    actions = torch.from_numpy(S.REF["actions"].astype(np.int64))
    roots2, _ = TH.step(roots, actions, SIZE)
    res2 = S.ref_driver(tm, tsp).search(
        roots2, torch.Generator().manual_seed(1), max_visits=S.VISITS + 1,
        prev_tree=res.ss.tree, prev_actions=actions)
    S.check_result(res2, "s2/")
    # the played children's subtrees were kept, not rebuilt
    kept = C.to_np(res.child_visits)[np.arange(2), C.to_np(actions)]
    assert (kept > 1).all()


@pytest.mark.parametrize("case", ["padded", "fresh_fallback",
                                  "already_rooted", "larger_pool_raises"])
def test_init_search_reuse_paths(first, case):
    res, tm, tsp, roots = first
    prev = res.ss.tree
    children = C.to_np(prev.children[:, 0])
    acts = C.to_np(res.child_visits).argmax(1)
    if case == "fresh_fallback":
        # game 0 plays a move whose child was never expanded
        acts[0] = int(np.flatnonzero(children[0] < 0)[0])
    actions = torch.from_numpy(acts.astype(np.int64))
    roots2, _ = TH.step(roots, actions, SIZE)
    gen = torch.Generator().manual_seed(2)
    kw = dict(size=SIZE, with_ladders=True)
    if case == "larger_pool_raises":
        with pytest.raises(ValueError):
            mcts.init_search(tm, roots2, tsp, gen, max_nodes=NODES - 1,
                             prev_tree=prev, prev_actions=actions, **kw)
        return
    if case == "already_rooted":
        sub = mcts.extract_subtree(prev, actions)
        ss = mcts.init_search(tm, roots2, tsp, gen, max_nodes=NODES,
                              prev_tree=sub, prev_actions=None, **kw)
        np.testing.assert_array_equal(C.to_np(ss.tree.visits),
                                      C.to_np(sub.visits))
        return
    big = NODES + 9
    ss = mcts.init_search(tm, roots2, tsp, gen, max_nodes=big,
                          prev_tree=prev, prev_actions=actions, **kw)
    sub = mcts.extract_subtree(prev, actions)
    tree = ss.tree
    assert tree.visits.shape == (2, big)
    assert tree.children.dtype == torch.int16
    fresh = mcts.empty_tree(SIZE, big, 2, "cpu")
    for g in range(2):
        reused = case == "padded" or g == 1
        n = int(sub.num_nodes[g]) if reused else 1
        assert int(tree.num_nodes[g]) == n
        # past the carried nodes the pool is the empty tree's
        np.testing.assert_array_equal(C.to_np(tree.children[g, NODES:]),
                                      C.to_np(fresh.children[g, NODES:]))
        if reused:
            np.testing.assert_array_equal(C.to_np(tree.visits[g, :NODES]),
                                          C.to_np(sub.visits[g]))
            np.testing.assert_array_equal(
                C.to_np(tree.children[g, :NODES]), C.to_np(sub.children[g]))
        else:
            assert int(tree.visits[g, 0]) == 1
            assert (C.to_np(tree.children[g]) == -1).all()
    # the root's position is the live game's, and its prior a distribution
    np.testing.assert_array_equal(C.to_np(tree.pos.board.stones[:, 0]),
                                  C.to_np(roots2.pos.board.stones))
    pol = C.to_np(tree.policy[:, 0]).astype(np.float32)
    np.testing.assert_allclose(np.where(pol >= 0, pol, 0).sum(1), 1.0,
                               atol=3e-3)
    assert (C.to_np(tree.stats[:, 0, mcts.C_PATTERN_BONUS]) == 0).all()


def test_run_search_runs_exactly_num_sims(first):
    res, tm, tsp, roots = first
    actions = torch.from_numpy(S.REF["actions"].astype(np.int64))
    roots2, _ = TH.step(roots, actions, SIZE)
    kept = C.to_np(res.child_visits)[np.arange(2), C.to_np(actions)]
    cap = int(kept.max()) + 2
    out = mcts.run_search(tm, roots2, tsp, torch.Generator().manual_seed(3),
                          size=SIZE, num_sims=3, max_nodes=NODES,
                          prev_tree=res.ss.tree, prev_actions=actions,
                          max_visits=cap)
    # each game runs 3 playouts or stops at the cap, whichever is first
    np.testing.assert_array_equal(C.to_np(out.root_visits),
                                  np.minimum(kept + 3, cap))
    fresh = mcts.run_search(tm, roots2, tsp, torch.Generator().manual_seed(3),
                            size=SIZE, num_sims=4, max_nodes=NODES)
    assert (C.to_np(fresh.root_visits) == 5).all()
    assert dataclasses.is_dataclass(fresh.ss)
