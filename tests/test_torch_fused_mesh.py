"""The port's fused actor-learner across ranks (katago_torch/selfplay/
fused.py with a parallel.mesh.Mesh) against the JAX package's sharded
fused step and against itself at one rank, on the CPU with gloo.

The JAX side is the saved `fused_mesh` reference (tools/
make_torch_fixtures.py): the fused step jitted with the games and the
ring sharded over a 2-device CPU mesh and the parameters replicated, on
the `fused` fixture's arguments (tests.test_torch_common.FUSED_ARGS: 5x5,
b1c6 of weights seed 3, 4 games with game 1 over at the start, a ring of
capacity 8 that wraps, 3 moves at temperature 0 with no root noise), and
the learner's indices its key drew.

Two CPU processes at world size 2 (each 2 of the 4 games, a replica of
the ring) must give:
  * the ring of fused_mesh: policy, spatial, glob, cursor and filled and
    the final boards exactly, the other rows within 1e-5; the learner on
    the JAX indices its metrics and parameters within 1e-5;
  * one whole fused step (drawn indices) equal to the one-rank step on
    the same inputs: ring, boards, cursor and filled exactly, metrics
    and parameters within 1e-6, and equal on both ranks.
A game count or a learner batch that does not divide by the ranks
raises ValueError. The sharded JAX step computes the unsharded JAX ring
(the `fused` fixture), as its global compaction implies.
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp

import numpy as np
import pytest
import torch

from katago_torch.game import history as TH
from katago_torch.models import weights as TW
from katago_torch.parallel import mesh as PM
from katago_torch.search.params import SearchParams
from katago_torch.selfplay import fused as TFU

from tests import test_torch_common as C

REF, META = C.load_ref("fused_mesh")
FUSED, _ = C.load_ref("fused")
A = META["args"]
SIZE = 5
EXACT = ("policy", "spatial", "glob")
# one whole fused step: games, ring, visits, moves, batch
STEP = dict(games=4, capacity=8, visits=4, moves=2, batch=4)


def _params():
    return dataclasses.replace(SearchParams.for_selfplay(),
                               root_noise_enabled=False,
                               **C.TEMPERATURE_ZERO)


def _model_opt():
    model = C.ref_model(SIZE)
    return model, torch.optim.SGD(model.parameters(), lr=A["lr"],
                                  momentum=0.9)


def _gathered(games, ring, mesh, metrics, model) -> dict:
    """What a rank ends with, as numpy: the ring, every rank's games, the
    metrics and the parameters."""
    stones, move_num, komi = PM.all_gather(
        [games.pos.board.stones, games.pos.move_num, games.rules.komi],
        mesh)
    return {"ring": {k: ring.rows(k).numpy() for k in TFU.RING_FIELDS},
            "cursor": int(ring.cursor), "filled": int(ring.filled),
            "stones": stones.numpy(), "move_num": move_num.numpy(),
            "komi": komi.numpy(),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "params": {k: v.detach().numpy().copy()
                       for k, v in model.state_dict().items()}}


def _jax_case(mesh) -> dict:
    """The fused_mesh chunk, then the learner on the JAX indices."""
    model, opt = _model_opt()
    games = TFU.new_games(SIZE, A["games"], max_moves=A["max_moves"],
                          komi_stdev=A["komi_stdev"], device="cpu",
                          normals=torch.from_numpy(FUSED["normals"]),
                          mesh=mesh)
    over = torch.zeros(A["games"], dtype=torch.bool)
    over[A["over"]] = True
    row0, rows = PM.process_batch_slice(A["games"], mesh)
    games = TH.replace_pos(games, game_over=over[row0:row0 + rows])
    ring = TFU.ReplayRing.create(A["capacity"], SIZE, "cpu", mesh)
    actor = TFU.make_actor_chunk(model, size=SIZE, visits=A["visits"],
                                 search_params=_params(),
                                 moves_per_chunk=A["moves"], mesh=mesh)
    games = actor(games, ring, torch.Generator().manual_seed(5))
    learner = TFU.make_learner_step(model, opt, A["batch"], SIZE, mesh)
    metrics = learner(ring, None,
                      idx=torch.from_numpy(REF["learner/idx"]).long())
    return _gathered(games, ring, mesh, metrics, model)


def _fused_case(mesh) -> dict:
    """One whole fused step with its own draws."""
    model, opt = _model_opt()
    games = TFU.new_games(SIZE, STEP["games"], max_moves=24, komi_stdev=1.0,
                          gen=torch.Generator().manual_seed(3),
                          device="cpu", mesh=mesh)
    ring = TFU.ReplayRing.create(STEP["capacity"], SIZE, "cpu", mesh)
    step = TFU.make_fused_step(model, opt, size=SIZE, visits=STEP["visits"],
                               batch_size=STEP["batch"],
                               moves_per_chunk=STEP["moves"],
                               search_params=_params(), mesh=mesh)
    games, metrics = step(games, ring, torch.Generator().manual_seed(9))
    return _gathered(games, ring, mesh, metrics, model)


def _rank_main(rank, url, queue):
    mesh = PM.initialize_multihost(url, 2, rank, "cpu")
    try:
        out = {"jax": _jax_case(mesh), "fused": _fused_case(mesh)}
    finally:
        PM.shutdown()
    queue.put((rank, out))


@pytest.fixture(scope="module")
def world2():
    """Both ranks' results: {rank: {"jax": ..., "fused": ...}}."""
    url = f"tcp://127.0.0.1:{PM.free_port()}"
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(r, url, queue))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        results = dict(queue.get(timeout=300) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    assert [p.exitcode for p in procs] == [0, 0]
    return results


def _ring_equal(got: dict, ring: dict, cursor, filled, atol: float):
    assert got["cursor"] == int(cursor) and got["filled"] == int(filled)
    for name in TFU.RING_FIELDS:
        g, w = got["ring"][name], ring[name]
        assert g.shape == w.shape, name
        if name in EXACT:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=atol,
                                       err_msg=name)


@pytest.mark.parametrize("rank", [0, 1])
def test_ring_and_games_equal_the_sharded_jax_step(world2, rank):
    got = world2[rank]["jax"]
    ring = {k: REF[f"ring/{k}"] for k in TFU.RING_FIELDS}
    _ring_equal(got, ring, REF["ring/cursor"], REF["ring/filled"], 1e-5)
    np.testing.assert_array_equal(got["stones"], REF["final_stones"])
    np.testing.assert_array_equal(got["move_num"], REF["final_move_num"])
    np.testing.assert_array_equal(got["komi"], REF["final_komi"])


@pytest.mark.parametrize("rank", [0, 1])
def test_learner_on_the_jax_indices_equals_jax(world2, rank):
    got = world2[rank]["jax"]
    for k, v in got["metrics"].items():
        assert abs(v - float(REF[f"learner/{k}"])) <= 1e-5, k
    want = TW.from_flax_params(C.flax_tree(REF, "after"))
    for k, v in got["params"].items():
        np.testing.assert_allclose(v, want[k].numpy(), rtol=0, atol=1e-5,
                                   err_msg=k)


def test_two_ranks_equal_one_rank(world2):
    one = _fused_case(None)
    for rank in (0, 1):
        got = world2[rank]["fused"]
        _ring_equal(got, one["ring"], one["cursor"], one["filled"], 0.0)
        for k in ("stones", "move_num", "komi"):
            np.testing.assert_array_equal(got[k], one[k], err_msg=k)
        for k, v in one["metrics"].items():
            assert abs(got["metrics"][k] - v) <= 1e-6 * max(1.0, abs(v)), k
        for k, v in one["params"].items():
            np.testing.assert_allclose(got["params"][k], v, rtol=0,
                                       atol=1e-6, err_msg=k)
    assert one["filled"] == STEP["games"] * STEP["moves"]
    for k, v in world2[0]["fused"]["params"].items():
        np.testing.assert_array_equal(world2[1]["fused"]["params"][k], v)


def test_the_sharded_jax_step_computes_the_unsharded_ring():
    assert int(REF["ring/cursor"]) == int(FUSED["ring/cursor"])
    assert int(REF["ring/filled"]) == int(FUSED["ring/filled"])
    for name in TFU.RING_FIELDS:
        np.testing.assert_allclose(REF[f"ring/{name}"],
                                   FUSED[f"ring/{name}"], rtol=0, atol=1e-6,
                                   err_msg=name)
    np.testing.assert_array_equal(REF["final_stones"], FUSED["final_stones"])


def test_a_count_that_does_not_divide_raises():
    mesh = PM.Mesh(rank=0, world_size=2, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="not divisible"):
        TFU.new_games(SIZE, 3, device="cpu", mesh=mesh)
    model, opt = _model_opt()
    with pytest.raises(ValueError, match="not divisible"):
        TFU.make_learner_step(model, opt, 7, SIZE, mesh)
    with pytest.raises(ValueError, match="not divisible"):
        TFU.make_fused_step(model, opt, size=SIZE, visits=4, batch_size=7,
                            mesh=mesh)
