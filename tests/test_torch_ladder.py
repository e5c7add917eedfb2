"""The port's chase ladder solver (K1's plain version `chase_lanes_plain`
through `ladder_map_chase_batch`) vs the JAX package's own off-TPU path,
jax.vmap(ladder.ladder_map_chase): the random-board and ko/atari cases of
tests/test_chase_pallas.py and the K1 cases of ops/cases.py — exact.
The JAX results are the reference fixture tests/data/torch_ref/chase.npz
(tools/make_torch_fixtures.py); each test rebuilds its boards and checks
them against the fixture's inputs first."""

import numpy as np
import pytest
import torch

from katago_torch.game import ladder as TL
from katago_torch.ops import cases as CASES
from katago_torch.ops import chase as K1

from tests import test_torch_common as C

FIELDS = ("laddered", "working_vs_black", "working_vs_white")
REF, _ = C.load_ref("chase")


def _compare(name, stones, ko, size):
    """The port on stones/ko (which must be the fixture set's inputs)
    against the fixture's JAX masks; returns the laddered masks."""
    np.testing.assert_array_equal(stones, REF[f"{name}/stones"])
    np.testing.assert_array_equal(ko, REF[f"{name}/ko"])
    got = TL.ladder_map_chase_batch(
        torch.from_numpy(stones.astype(np.int32)), size,
        ko_loc=torch.from_numpy(ko.astype(np.int64)))
    for field in FIELDS:
        a = REF[f"{name}/{field}"]
        b = C.to_np(getattr(got, field))
        assert (a == b).all(), f"{field} mismatch at {np.argwhere(a != b)[:5]}"
    return REF[f"{name}/laddered"]


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
    laddered = _compare("random9", stones, ko, size)
    assert laddered.any()    # the boards do hold captured ladders


def test_chase_19x19_random_boards():
    size = 19
    stones = C.random_boards(size, 2, 1)
    _compare("random19", stones, np.full((2,), -1, np.int32), size)


@pytest.mark.parametrize("size,kind", [(9, "random"), (7, "chase_boards"),
                                       (9, "chase_boards"), (7, "dense"),
                                       (9, "dense")])
def test_chase_lanes_wrapper_takes_plain_version_on_cpu(size, kind):
    """On CPU tensors chase_lanes is chase_lanes_plain and launches nothing:
    random boards, the ko and atari boards of ops/cases.py and its dense
    quirk boards."""
    steps = TL.default_max_steps(size)
    if kind == "random":
        stones = torch.from_numpy(C.random_boards(size, 4, 3))
        ko = torch.full((4,), -1)
    elif kind == "dense":
        stones, ko, _ = CASES.chase_cases(size, 4, size, steps)["dense"]
    else:
        stones, ko = CASES.chase_boards(4, size, size)
    ctx = TL._chase_setup(stones, size, 16, ko)
    args = TL.chase_lane_inputs(stones, ctx, 16)
    assert [a.dtype for a in args] == [torch.int32] * 6 + [torch.bool]
    before = K1.launches
    got = K1.chase_lanes(*args, size=size, max_steps=steps)
    plain = K1.chase_lanes_plain(*args, size=size, max_steps=steps)
    assert K1.launches == before
    assert torch.equal(got, plain)
    assert got.dtype == torch.bool and got.shape == (128,)
    assert not bool((got & ~args[-1]).any())   # inactive lanes stay false


def _plain_stats(stones, ko, size, max_steps):
    """chase_lanes_plain's stats over the lanes of the boards."""
    ctx = TL._chase_setup(stones, size, 16, ko)
    stats = {}
    K1.chase_lanes_plain(*TL.chase_lane_inputs(stones, ctx, 16), size=size,
                         max_steps=max_steps, stats=stats)
    return stats


def test_chase_dense_boards_reach_every_branch():
    size = 9
    steps = TL.default_max_steps(size)
    stones, ko, mx = CASES.chase_cases(size, 14, 6, steps)["dense"]
    _compare("dense9", C.to_np(stones), C.to_np(ko).astype(np.int32), size)
    events = _plain_stats(stones, ko, size, mx)["events"]
    for name in ("suicide_extension", "ko_ban", "overflow",
                 "double_ko_shape"):
        assert events[name] > 0, (name, events)


def test_chase_full_board_ladder_and_max_steps():
    size = 19
    steps = TL.default_max_steps(size)
    cases = CASES.chase_cases(size, 1, 0, steps)
    stones, ko, _ = cases["ladder"]
    laddered = _compare("ladder19", C.to_np(stones),
                        C.to_np(ko).astype(np.int32), size)
    assert laddered[0].reshape(size, size)[1, 1]   # the runner is captured
    stats = _plain_stats(stones, ko, size, steps)
    assert stats["max_lane_plies"] == 66 and stats["events"]["max_steps"] == 0
    stones, ko, cut = cases["ladder_cut"]
    stats = _plain_stats(stones, ko, size, cut)
    assert cut == steps // 2 and stats["max_lane_plies"] == cut
    assert stats["events"]["max_steps"] == 2      # both runners, uncaught
