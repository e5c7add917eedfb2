"""The port's fused actor-learner (katago_torch/selfplay/fused.py)
against the JAX package's, on the CPU.

The JAX side is the saved `fused` reference (tools/make_torch_fixtures.py):
one actor chunk of 3 moves at 5x5 on the b1c6 net of weights seed 3,
temperature 0 and no root noise (FUSED_ARGS), 4 games with game 1 over
at the start (its row is skipped, then it restarts), komi jittered by
the saved normal draws, a ring of capacity 8 that wraps; then one
learner step (SGD with momentum) on the indices its key drew.

Exact: the policy targets, the spatial and global rows, the cursor and
`filled`, the final boards and komi. Within 1e-5: the value, score,
lead, score-stdev and ownership rows, the learner's loss terms on the
given indices and the parameters after its update.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from katago_torch.game import history as TH
from katago_torch.models import weights as TW
from katago_torch.search.params import SearchParams
from katago_torch.selfplay import fused as TFU

from tests import test_torch_common as C

REF, META = C.load_ref("fused")
A = META["args"]
SIZE = 5
EXACT = ("policy", "spatial", "glob")


def _params():
    return dataclasses.replace(SearchParams.for_selfplay(),
                               root_noise_enabled=False,
                               **C.TEMPERATURE_ZERO)


def _games():
    games = TFU.new_games(SIZE, A["games"], max_moves=A["max_moves"],
                          komi_stdev=A["komi_stdev"], device="cpu",
                          normals=torch.from_numpy(REF["normals"]))
    over = torch.zeros(A["games"], dtype=torch.bool)
    over[A["over"]] = True
    return TH.replace_pos(games, game_over=over)


@pytest.fixture(scope="module")
def chunk():
    model = C.ref_model(SIZE)
    games = _games()
    ring = TFU.ReplayRing.create(A["capacity"], SIZE, "cpu")
    actor = TFU.make_actor_chunk(model, size=SIZE, visits=A["visits"],
                                 search_params=_params(),
                                 moves_per_chunk=A["moves"])
    games2 = actor(games, ring, torch.Generator().manual_seed(5))
    return model, games, games2, ring


def test_new_games_komi_from_the_jax_draws():
    np.testing.assert_array_equal(_games().rules.komi.numpy(), REF["komi"])


def test_ring_rows_equal_jax(chunk):
    _, _, _, ring = chunk
    assert int(ring.cursor) == int(REF["ring/cursor"])
    assert int(ring.filled) == int(REF["ring/filled"])
    for name in TFU.RING_FIELDS:
        got, want = ring.rows(name).numpy(), REF[f"ring/{name}"]
        assert got.shape == want.shape, name
        if name in EXACT:
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5,
                                       err_msg=name)


def test_games_after_the_chunk_equal_jax(chunk):
    _, games, games2, _ = chunk
    np.testing.assert_array_equal(games2.pos.board.stones.numpy(),
                                  REF["final_stones"])
    np.testing.assert_array_equal(games2.pos.move_num.numpy(),
                                  REF["final_move_num"])
    # restarted games keep their jittered komi
    np.testing.assert_array_equal(games2.rules.komi.numpy(),
                                  REF["final_komi"])
    np.testing.assert_array_equal(games2.rules.komi.numpy(),
                                  games.rules.komi.numpy())


def test_learner_step_on_the_jax_indices(chunk):
    _, _, _, ring = chunk
    model = C.ref_model(SIZE)
    opt = torch.optim.SGD(model.parameters(), lr=A["lr"], momentum=0.9)
    learner = TFU.make_learner_step(model, opt, A["batch"], SIZE)
    metrics = learner(ring, None,
                      idx=torch.from_numpy(REF["learner/idx"]).long())
    for k, v in metrics.items():
        assert abs(float(v) - float(REF[f"learner/{k}"])) <= 1e-5, k
    want = TW.from_flax_params(C.flax_tree(REF, "after"))
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)


def test_fused_steps_fill_the_ring_and_train():
    model = C.ref_model(SIZE)
    opt = torch.optim.SGD(model.parameters(), lr=1e-3, momentum=0.9)
    gen = torch.Generator().manual_seed(1)
    games = TFU.new_games(SIZE, 2, max_moves=24, device="cpu")
    ring = TFU.ReplayRing.create(64, SIZE, "cpu")
    step = TFU.make_fused_step(model, opt, size=SIZE, visits=4,
                               batch_size=4, moves_per_chunk=2)
    before = next(iter(model.parameters())).detach().clone()
    for _ in range(2):
        games, metrics = step(games, ring, gen)
        assert torch.isfinite(metrics["loss"])
    assert int(ring.filled) == 2 * 2 * 2 and int(ring.cursor) == 8
    pol = ring.rows("policy")[:8]
    np.testing.assert_allclose(pol.sum(1).numpy(), 1.0, atol=1e-5)
    np.testing.assert_allclose(ring.rows("spatial")[:8, :, 0].numpy(), 1.0)
    after = next(iter(model.parameters())).detach()
    assert not torch.equal(before, after)
