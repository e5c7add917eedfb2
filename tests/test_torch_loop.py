"""The port's shuffler, logger and training loop (katago_torch/train/
shuffle.py, utils/logger.py, cli/loop_cmd.py), on the CPU.

The shuffler and the logger run live on both sides (the JAX package's
modules are numpy and plain Python): shuffle_npz_files writes the same
file names holding equal arrays on its single-bucket, spill and
keep_prob < 1 paths (arrays compared, not zip bytes, which carry
timestamps), and the loggers write the same lines, timestamps aside.

The loop runs one cycle of each mode at 5x5 with the b1c6 net and a
seeded champion in models/, so every stage runs: selfplay from the
champion, shuffle, training, and a gatekeeper match that moves the
candidate. The selfplay games and the gate match are cut at LOOP_MOVES
moves (the loop's max_moves) to keep the CPU time small. Both modes restore the
SIGINT/SIGTERM handlers after a run and after a stage that raises, and an
empty shuffle window raises a ValueError that names it.
"""

from __future__ import annotations

import io
import os
import re
import signal

import numpy as np
import pytest

from katago_torch.cli import loop_cmd as TL
from katago_torch.cli.train_cmd import make_model
from katago_torch.train import checkpoint as TCK
from katago_torch.train import shuffle as TS
from katago_torch.utils import logger as TLOG
from katago_tpu.train import shuffle as JS
from katago_tpu.utils import logger as JLOG

from tests import test_torch_common as C

SHUFFLE_CASES = {
    "one_bucket": dict(rows_per_shard=7),
    "spill": dict(rows_per_shard=9, window_rows=40, rows_per_bucket=10),
    "keep_prob": dict(rows_per_shard=6, keep_prob=0.6, seed=5),
}


@pytest.mark.parametrize("case", sorted(SHUFFLE_CASES))
def test_shuffle_writes_the_jax_shards(tmp_path, case):
    files = C.write_shards(tmp_path / "in", 5, [13, 4, 21, 9], seed=2)
    files.insert(2, str(tmp_path / "in" / "truncated.npz"))
    (tmp_path / "in" / "truncated.npz").write_bytes(b"PK\x03\x04")
    kw = SHUFFLE_CASES[case]
    got = TS.shuffle_npz_files(files, str(tmp_path / "t"), **kw)
    want = JS.shuffle_npz_files(files, str(tmp_path / "j"), **kw)
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want]
    assert sorted(os.listdir(tmp_path / "t")) == \
        sorted(os.listdir(tmp_path / "j"))   # spilled buckets removed
    assert len(got) > 1
    for g, w in zip(got, want):
        with np.load(g) as zg, np.load(w) as zw:
            assert zg.files == zw.files
            for k in zw.files:
                np.testing.assert_array_equal(zg[k], zw[k], err_msg=k)


@pytest.mark.parametrize("total", [0, 1000, 250_000, 2_000_000, 10**8])
def test_window_size_matches_jax(total):
    for kw in ({}, dict(min_rows=100, keep_prop=0.5, taper_scale=50.0,
                        max_rows=1_000_000)):
        assert TS.compute_window_size(total, **kw) == \
            JS.compute_window_size(total, **kw)


STAMP = re.compile(r"^\d{4}-\d\d-\d\d \d\d:\d\d:\d\d[+-]\d{4}: ", re.M)


def test_logger_lines_match_jax(tmp_path, capsys):
    outs = {}
    for name, mod in (("torch", TLOG), ("jax", JLOG)):
        stream = io.StringIO()
        cfg = {"logFile": str(tmp_path / name / "a.log"),
               "logToStdout": "true", "logToStderr": "false"}
        lg = mod.Logger.from_config(cfg)
        lg.add_stream(stream)
        lg("first line\n")
        lg.write("second")
        lg.set_disabled(True)
        lg("dropped")
        lg.set_disabled(False)
        lg(3.5)
        lg.close()
        plain = io.StringIO()
        p = mod.Logger(log_time=False, header="header")
        p.add_stream(plain)
        p("x")
        outs[name] = (stream.getvalue(),
                      (tmp_path / name / "a.log").read_text(),
                      capsys.readouterr().out, plain.getvalue())
    for got, want in zip(outs["torch"], outs["jax"]):
        assert STAMP.sub("", got) == STAMP.sub("", want)
    assert len(STAMP.findall(outs["torch"][0])) == 3
    assert outs["torch"][3] == outs["jax"][3] == "x\n"


LOOP_MOVES = 6
LOOP_ARGS = dict(cycles=1, size=5, config_name="b1c6", games_per_cycle=2,
                 visits=2, train_steps=2, batch_size=8, lr=1e-3,
                 gate_games=2, seed=0, max_moves=LOOP_MOVES, device="cpu")


def handlers():
    return (signal.getsignal(signal.SIGINT), signal.getsignal(signal.SIGTERM))


def seed_champion(base) -> str:
    """models/ holds an export of the seeded initial net."""
    sd = make_model(5, "b1c6", "cpu").state_dict()
    return TCK.export_params(os.path.join(str(base), "models"), "champion",
                             sd)


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_one_cycle_gates_a_candidate(tmp_path, mode):
    seed_champion(tmp_path)
    before = handlers()
    fn = TL.run_loop if mode == "sync" else TL.run_loop_async
    lines = []
    summary = fn(str(tmp_path), log=lines.append, **LOOP_ARGS)
    assert handlers() == before
    assert sorted(os.listdir(tmp_path)) == sorted(TL.DIRS)
    cycle = summary[0]
    keys = {"cycle", "train", "gatekeeper"} | (
        {"selfplay"} if mode == "sync" else set())
    assert set(cycle) == keys
    if mode == "sync":
        assert len(summary) == 1
        assert cycle["selfplay"]["games"] == 2 and \
            cycle["selfplay"]["rows"] > 0
    else:
        assert set(summary[-1]) == {"selfplay_totals"}
        assert summary[-1]["selfplay_totals"]["games"] >= 2
    # the champion's data, shuffled, trained on, and the candidate gated
    # (async: a producer batch that starts after the gate may already
    # play the new champion)
    assert "champion" in os.listdir(tmp_path / "selfplay")
    assert os.listdir(tmp_path / "shuffleddata" / "c0000")
    assert cycle["train"]["steps"] == 2
    assert TCK.latest_checkpoint(str(tmp_path / "ckpts"))
    (gk,) = cycle["gatekeeper"]
    assert gk["candidate"] == "b1c6-s2" and gk["games"] == 2
    dest = "models" if gk["accepted"] else "rejected-models"
    assert sorted(os.listdir(tmp_path / dest)) == (
        ["b1c6-s2", "champion"] if gk["accepted"] else ["b1c6-s2"])
    assert os.listdir(tmp_path / "test-models") == []


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_handlers_restored_when_a_stage_raises(tmp_path, monkeypatch,
                                               mode):
    during = []

    def broken(*a, **kw):
        during.append(handlers())
        raise RuntimeError("stage failed")
    monkeypatch.setattr(TL, "run_training", broken)
    before = handlers()
    fn = TL.run_loop if mode == "sync" else TL.run_loop_async
    with pytest.raises(RuntimeError, match="stage failed"):
        fn(str(tmp_path), log=lambda s: None, **LOOP_ARGS)
    # the loop's drain handlers were installed while the stage ran
    assert during and during[0][0] != before[0] and \
        during[0][1] != before[1]
    assert handlers() == before


def test_empty_shuffle_raises_value_error(tmp_path, monkeypatch):
    monkeypatch.setattr(TL, "run_selfplay", lambda *a, **kw: {})
    before = handlers()
    with pytest.raises(ValueError, match="shuffle window"):
        TL.run_loop(str(tmp_path), log=lambda s: None, **LOOP_ARGS)
    assert handlers() == before
