"""The port's Elo, match and gatekeeper (katago_torch/utils/elo.py,
cli/match_cmd.py, cli/gatekeeper_cmd.py) against the JAX package's, on
the CPU.

Elo runs live on both sides (katago_tpu/utils/elo.py is pure Python and
numpy): equal within 1e-12. The JAX side of the matches and the
gatekeeper is a saved reference (tests/data/torch_ref/{match,
gatekeeper}.npz, tools/make_torch_fixtures.py) made with the match
module's SearchParams at temperature 0 (tests.test_torch_common.
temperature_zero), which the tests patch the same way: both engines then
take each game's most visited move, so the records, "finished" and the
accept/reject decisions are exact, Elo differences and stdevs within
1e-6 and round-robin Elos within 1e-6. The matches are cut by max_moves
(MATCH_ARGS, run_gatekeeper's max_moves; play_round_robin has none, so
it is bound into the module's play_match, as the fixtures did for both)
to keep the CPU time small.
"""

from __future__ import annotations

import functools
import os
import time

import numpy as np
import pytest
import torch

from katago_torch.cli import gatekeeper_cmd as TG
from katago_torch.cli import match_cmd as TM
from katago_torch.game import board as TB
from katago_torch.game import history as TH
from katago_torch.game import rules as TR
from katago_torch.models import config as TC
from katago_torch.models import model as TMOD
from katago_torch.models import weights as TW
from katago_torch.train import checkpoint as TCK
from katago_torch.utils import elo as TE
from katago_tpu.utils import elo as JE

from tests import test_torch_common as C

RECORDS = [(7, 3, 0), (0, 5, 1), (12, 12, 4), (1, 0, 0), (0, 0, 0),
           (30.5, 2, 3)]
# round-robin win matrices: [a][b] = (a-first wins, b wins in those games)
WIN_MATRICES = [
    [[[0, 0], [3, 1]], [[2, 2], [0, 0]]],
    [[[0, 0], [5, 0], [1, 1]], [[2, 3], [0, 0], [4, 0]],
     [[0.5, 1.5], [1, 3], [0, 0]]],
]


@pytest.mark.parametrize("record", RECORDS)
def test_estimate_elo_and_likelihood_match_jax(record):
    got, want = TE.estimate_elo(*record), JE.estimate_elo(*record)
    if np.isinf(want[1]):
        assert got == want
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    for diff in (-250.0, 0.0, 80.0):
        assert abs(TE.log_likelihood_of_record(diff, *record)
                   - JE.log_likelihood_of_record(diff, *record)) <= 1e-12
    p = TE.win_prob_of_elo_diff(123.0)
    assert p == JE.win_prob_of_elo_diff(123.0)
    assert TE.elo_diff_of_win_prob(p) == JE.elo_diff_of_win_prob(p)


@pytest.mark.parametrize("wm", WIN_MATRICES, ids=["2bots", "3bots"])
def test_compute_elos_and_stdevs_match_jax(wm):
    got, want = TE.compute_elos(wm), JE.compute_elos(wm)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(TE.compute_approx_elo_stdevs(got, wm),
                               JE.compute_approx_elo_stdevs(want, wm),
                               rtol=0, atol=1e-12)


REF, META = C.load_ref("match")
SIZE = C.MATCH_ARGS["size"]


@functools.lru_cache(maxsize=None)
def bot(seed: int):
    """The b1c6 net with the flax_params weights of seed (3 and 4 from
    their fixtures, 5 from match.npz)."""
    if seed != 5:
        return C.ref_model(SIZE, seed)
    model = TMOD.KataGoModel(TC.get_config("b1c6"), SIZE, torch.float32)
    model.load_state_dict(TW.from_flax_params(C.flax_tree(REF, "w5")))
    return model.eval()


@pytest.fixture
def temperature_zero(monkeypatch):
    monkeypatch.setattr(TM, "SearchParams",
                        C.temperature_zero(TM.SearchParams))


def assert_record_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, float):
            assert abs(got[k] - v) <= 1e-6, (k, got[k], v)
        else:
            assert got[k] == v, (k, got[k], v)


def test_play_match_cut_by_max_moves_equals_jax(temperature_zero):
    got = TM.play_match(bot(3), bot(4), device="cpu", log=lambda s: None,
                        **C.MATCH_ARGS)
    assert_record_equal(got, META["match"])
    assert got["finished"] is False


def test_play_round_robin_equals_jax(temperature_zero, monkeypatch):
    monkeypatch.setattr(TM, "play_match", functools.partial(
        TM.play_match, max_moves=C.ROUND_ROBIN_MAX_MOVES))
    bots = [(f"s{s}", bot(s)) for s in C.MATCH_SEEDS]
    got = TM.play_round_robin(bots, device="cpu", log=lambda s: None,
                              **C.ROUND_ROBIN_ARGS)
    want = META["round_robin"]
    assert got["pair_records"] == want["pair_records"]
    for key in ("elos", "elo_stdevs"):
        assert list(got[key]) == list(want[key])   # the ranking's order
        for name, v in want[key].items():
            assert abs(got[key][name] - v) <= 1e-6, (key, name)


def test_step_leaves_finished_games_unchanged():
    """play_match steps every game each move, finished or not."""
    size = 5
    gs = TH.new_game(size, TR.Rules.tromp_taylorish(), 16, g=3,
                     device="cpu")
    gs, _ = TH.step(gs, torch.tensor([12, 12, 12]), size)
    gs, _ = TH.step(gs, torch.tensor([25, 6, 25]), size)
    gs, _ = TH.step(gs, torch.tensor([25, 25, 7]), size)  # game 0: 2 passes
    assert gs.pos.game_over.tolist() == [True, False, False]
    for loc in (25, 0, 13):
        after, _ = TH.step(gs, torch.tensor([loc, 18, 18]), size)
        assert after.pos.board.stones[1, 18] == TB.WHITE

        def game0(tree):
            return {f: getattr(tree, f)[0] for f in tree.__dataclass_fields__
                    if isinstance(getattr(tree, f), torch.Tensor)}
        for part in ("pos", "board"):
            a = game0(gs.pos if part == "pos" else gs.pos.board)
            b = game0(after.pos if part == "pos" else after.pos.board)
            for f in a:
                assert torch.equal(a[f], b[f]), (loc, part, f)
        for f in ("ko_hash_hist", "hist_len", "pass_hash_black",
                  "pass_hash_black_n", "pass_hash_white",
                  "pass_hash_white_n"):
            assert torch.equal(getattr(gs, f)[0], getattr(after, f)[0]), f


def test_load_bot_specs(tmp_path):
    net = TM._load_bot("random:b1c6:7", 5, device="cpu")
    want = TW.init_weights(TMOD.KataGoModel(TC.get_config("b1c6"), 5,
                                            torch.float32), seed=7)
    for k, v in want.state_dict().items():
        assert torch.equal(net.state_dict()[k], v), k
    desc = TM._load_bot(str(C.REF_DIR / "b1c6_s3.bin.gz"), 5, device="cpu")
    assert desc.desc.name == "b1c6-s3"


GREF, GMETA = C.load_ref("gatekeeper")


def test_run_gatekeeper_equals_jax(tmp_path, temperature_zero):
    """cand-a meets an empty models dir (accepted as the first model),
    then cand-b and cand-c each play the newest champion (GATE_CALLS):
    the results and the final directories equal JAX's."""
    dirs = {n: str(tmp_path / n) for n in
            ("test-models", "models", "rejected-models")}
    t0 = time.time() - 1000.0
    calls = []
    for names, threshold in C.GATE_CALLS:
        for name in names:
            seed = C.GATE_CANDIDATES[name]
            path = TCK.export_params(dirs["test-models"], name,
                                     bot(seed).state_dict())
            t = t0 + 10.0 * seed
            os.utime(path, (t, t))
        calls.append(TG.run_gatekeeper(
            dirs["test-models"], dirs["models"], dirs["rejected-models"],
            win_threshold=threshold, max_moves=C.GATE_MAX_MOVES,
            device="cpu", log=lambda s: None, **C.GATE_ARGS))
    layout = {n: sorted(os.listdir(d)) for n, d in dirs.items()}
    assert layout == GMETA["layout"]
    assert len(calls) == len(GMETA["calls"])
    for got, want in zip(calls, GMETA["calls"]):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_record_equal(g, w)
    decisions = [r["accepted"] for call in calls for r in call]
    assert decisions[0] and "reason" in calls[0][0]
    assert True in decisions[1:] and False in decisions[1:], decisions
    # an accepted candidate's export loads as the champion
    champ = TCK.find_latest_model(dirs["models"])
    net = TG._bot_from_export(champ, 5, "b1c6", device="cpu")
    seed = C.GATE_CANDIDATES[os.path.basename(champ)]
    for k, v in bot(seed).state_dict().items():
        assert torch.equal(net.state_dict()[k], v), k


def test_match_and_gatekeeper_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.play_match(bot(3), bot(4), size=5, num_games=2, visits=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TG._bot_from_export("unused", 5, "b1c6")
