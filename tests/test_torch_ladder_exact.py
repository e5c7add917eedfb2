"""The port's exact ladder solver (`ladder_map_batch` / `ladder_map`,
the backtracking search of katago_tpu/game/ladder.py::ladder_map) vs the
JAX function, bit for bit, on the seeded boards of the reference fixture
tests/data/torch_ref/ladder_exact.npz (tools/make_torch_fixtures.py):
random and dense 9x9 and 19x19 boards, some with a ko point, boards
solved with reduced node budget, stack depth, iteration cap and chain
count so that every cap is reached, and the board whose lane ran longest
(1918 iterations) in chip_smoke.py's selfplay on an H100. Also vs the
pure-Python reference search tests/oracle_ladder.py on the canonical
19x19 ladders."""

import numpy as np
import pytest
import torch

from katago_torch.game import ladder as TL

from tests import test_torch_common as C
from tests.oracle_ladder import ladder_map_oracle
from tests.test_torch_oracle import LADDERS, _ladder_cases

FIELDS = ("laddered", "working_vs_black", "working_vs_white")
REF, META = C.load_ref("ladder_exact")
SETS = sorted(META["sets"])


def _inputs(name):
    """The set's boards and ko points, rebuilt from its seeds (or from
    the stones listed in its meta)."""
    m = META["sets"][name]
    if "stones" in m:
        stones = np.zeros((1, m["size"] ** 2), np.int32)
        for point, color in m["stones"]:
            stones[0, point] = color
        return stones, np.full((1,), m["ko"], np.int32)
    stones = C.random_boards(m["size"], m["boards"], m["seed"], *m["density"])
    rng = np.random.default_rng(m["ko_seed"])
    ko = np.full((m["boards"],), -1, np.int32)
    for i in range(0, m["boards"], 2):
        ko[i] = rng.choice(np.flatnonzero(stones[i] == 0))
    return stones, ko


@pytest.mark.parametrize("name", SETS)
def test_ladder_map_batch_matches_jax(name):
    m = META["sets"][name]
    stones, ko = _inputs(name)
    np.testing.assert_array_equal(stones, REF[f"{name}/stones"])
    np.testing.assert_array_equal(ko, REF[f"{name}/ko"])
    stats = {}
    got = TL.ladder_map_batch(torch.from_numpy(stones), m["size"],
                              ko_loc=torch.from_numpy(ko.astype(np.int64)),
                              stats=stats, **m["ladder_map_kwargs"])
    for f in FIELDS:
        np.testing.assert_array_equal(C.to_np(getattr(got, f)),
                                      REF[f"{name}/{f}"], err_msg=f)
    # the random sets hold captured ladders (the long edge ladder escapes)
    assert REF[f"{name}/laddered"].any() or name == "longtail19"
    kw = m["ladder_map_kwargs"]
    if "budget" in kw:
        # the reduced caps are reached: lanes out of budget and depth hits
        assert stats["unfinished_lanes"] > 0 and stats["depth_hits"] > 0
    elif "max_iters" in kw:
        assert stats["max_lane_iters"] == kw["max_iters"]
        assert stats["unfinished_lanes"] > 0
    else:
        assert stats["unfinished_lanes"] == 0
    if name == "longtail19":
        # the lane that took 1918 iterations on the card takes as many here
        assert stats["max_lane_iters"] == 1918
        assert stats["longest_lane"]["rep"] == 189
    if name == "random9":
        # one board alone gives its row of the batch
        one = TL.ladder_map(torch.from_numpy(stones[0]), m["size"],
                            ko_loc=int(ko[0]))
        for f in FIELDS:
            np.testing.assert_array_equal(C.to_np(getattr(one, f)),
                                          REF[f"{name}/{f}"][0])


@pytest.fixture(scope="module")
def canonical():
    boards = _ladder_cases(19)
    st = torch.tensor([boards[n] for n in LADDERS], dtype=torch.int32)
    stats = {}
    got = TL.ladder_map_batch(st, 19, stats=stats)
    return boards, got, stats


@pytest.mark.parametrize("name", LADDERS)
def test_ladder_map_matches_oracle_on_canonical_ladders(name, canonical):
    boards, got, stats = canonical
    i = LADDERS.index(name)
    mine = tuple(getattr(got, f)[i].tolist() for f in FIELDS)
    assert mine == tuple(ladder_map_oracle(boards[name], 19))
    # the clean ladder runs the whole diagonal
    assert stats["max_lane_iters"] > 60
