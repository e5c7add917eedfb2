"""The port's chase ladder solver (K1's plain version `chase_lanes_plain`
through `ladder_map_chase_batch`) vs the JAX package's own off-TPU path,
jax.vmap(ladder.ladder_map_chase): the random-board and ko/atari cases of
tests/test_chase_pallas.py — exact."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from katago_tpu.game import ladder as JL
from katago_torch.game import ladder as TL
from katago_torch.ops import chase as K1

from tests import test_torch_common as C

FIELDS = ("laddered", "working_vs_black", "working_vs_white")


def _compare(stones, ko, size):
    ref = jax.vmap(lambda s, k: JL.ladder_map_chase(s, size, ko_loc=k))(
        jnp.asarray(stones), jnp.asarray(ko))
    got = TL.ladder_map_chase_batch(torch.from_numpy(stones), size,
                                    ko_loc=torch.from_numpy(ko.astype(np.int64)))
    for name in FIELDS:
        a = np.asarray(getattr(ref, name))
        b = C.to_np(getattr(got, name))
        assert (a == b).all(), f"{name} mismatch at {np.argwhere(a != b)[:5]}"
    return np.asarray(ref.laddered)


def test_chase_9x9_random_ko_and_atari_boards():
    size = 9
    boards = C.random_boards(size, 12, 0)
    atari = np.zeros((size, size), np.int32)
    atari[1, 1] = 2
    atari[0, 1] = 1
    atari[1, 0] = 1
    atari[1, 2] = 1          # atari: lone liberty at (2,1)
    ko_board = C.random_boards(size, 1, 5)[0]
    stones = np.concatenate([boards, atari.reshape(1, -1), ko_board[None]])
    ko = np.full((stones.shape[0],), -1, np.int32)
    ko[-1] = 4               # a ko point set: exercises the lane masking
    laddered = _compare(stones, ko, size)
    assert laddered.any()    # the boards do hold captured ladders


def test_chase_19x19_random_boards():
    size = 19
    stones = C.random_boards(size, 2, 1)
    _compare(stones, np.full((2,), -1, np.int32), size)


def test_chase_lanes_wrapper_takes_plain_version_on_cpu():
    size = 9
    stones = torch.from_numpy(C.random_boards(size, 4, 3))
    ctx = TL._chase_setup(stones, size, 16, torch.full((4,), -1))
    i32 = torch.int32
    args = (stones.repeat_interleave(32, 0),
            ctx["labels"].to(i32).repeat_interleave(32, 0),
            ctx["libs"].to(i32).repeat_interleave(32, 0),
            ctx["reps"].reshape(-1).to(i32),
            ctx["defenders"].reshape(-1).to(i32),
            ctx["premoves"].reshape(-1).to(i32), ctx["active"].reshape(-1))
    before = K1.launches
    got = K1.chase_lanes(*args, size=size, max_steps=TL.default_max_steps(size))
    plain = K1.chase_lanes_plain(*args, size=size,
                                 max_steps=TL.default_max_steps(size))
    assert K1.launches == before
    assert torch.equal(got, plain)
    assert got.dtype == torch.bool and got.shape == (128,)
