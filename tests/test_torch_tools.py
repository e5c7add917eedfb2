"""The port's tools (katago_torch/cli/{forward_cmd,sgf_cmds,play_cmd,
genconfig_cmd,benchmark_cmd,checkpoint_tools_cmd}.py) against the JAX
package's, on the CPU.

The JAX side of forward_cmd, evalsgf, play_cmd and checkpoint clean is a
saved reference (tests/data/torch_ref/{forward,evalsgf,play,ckpt_clean}.
npz, tools/make_torch_fixtures.py) on the b1c6 .bin.gz of the fixtures;
genconfig's text runs live (katago_tpu/cli/genconfig_cmd.py writes it
with no JAX), its -benchmark path with run_benchmark patched to a fixed
playouts/s on both sides.

Tolerances: forward_cmd's numbers within 1e-5 (topPolicy's moves may
differ only between probabilities within 1e-5 of each other); in the
evalsgf and play transcripts every token equal but decimals, which may
differ by one unit of their last printed digit (the searches' visits are
exact); the cleaned .bin.gz byte-equal to the JAX exporter's,
uncompressed (the gzip header carries a timestamp).
"""

from __future__ import annotations

import contextlib
import gzip
import io
import json
import math
import re

import numpy as np
import pytest
import torch

from katago_torch.cli import benchmark_cmd as TBEN
from katago_torch.cli import checkpoint_tools_cmd as TCT
from katago_torch.cli import forward_cmd as TFWD
from katago_torch.cli import genconfig_cmd as TGEN
from katago_torch.cli import gtp as TGTP
from katago_torch.cli import play_cmd as TPLAY
from katago_torch.cli import sgf_cmds as TSGF
from katago_torch.cli.train_cmd import make_model
from katago_torch.models import weights as TW
from katago_torch.train import checkpoint as TCK
from katago_torch.train import train_step as TSTEP
from katago_tpu.cli import genconfig_cmd as JGEN

from tests import test_torch_common as C

MODEL = str(C.REF_DIR / "b1c6_s3.bin.gz")
DECIMAL = re.compile(r"[+-]?\d+\.\d+")


def stdout_of(fn, *args) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue()


def assert_text_matches(got: str, want: str):
    """Every token equal but decimals, within one unit of their last
    printed digit."""
    gl, wl = got.splitlines(), want.splitlines()
    assert len(gl) == len(wl), (got, want)
    for i, (g, w) in enumerate(zip(gl, wl)):
        assert DECIMAL.sub("#", g) == DECIMAL.sub("#", w), (i, g, w)
        for a, b in zip(DECIMAL.findall(g), DECIMAL.findall(w)):
            quantum = 10.0 ** -len(b.split(".")[1])
            assert abs(float(a) - float(b)) <= 1.01 * quantum, (i, g, w)


@pytest.fixture
def sgf_file(tmp_path):
    path = tmp_path / "game.sgf"
    path.write_text(C.TOOLS_SGF)
    return path


FWD, _ = C.load_ref("forward")


@pytest.mark.parametrize("case", sorted(C.FORWARD_CASES))
def test_forward_json_equals_jax(case, sgf_file):
    argv = ["-model", MODEL, "-device", "cpu"] + [
        a.format(sgf=sgf_file) for a in C.FORWARD_CASES[case]]
    got = json.loads(stdout_of(TFWD.main, argv))
    want = json.loads(str(FWD[case]))
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, float):
            assert abs(got[k] - v) <= 1e-5, k
        elif k in ("policy", "ownership"):
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-5)
        elif k == "topPolicy":
            assert len(got[k]) == len(v)
            for g, w in zip(got[k], v):
                assert abs(g["prob"] - w["prob"]) <= 1e-5
                loc = TPLAY.parse_vertex(g["move"], 9)
                assert abs(want["policy"][loc] - g["prob"]) <= 1e-5
        else:
            assert got[k] == v, k


EVAL, EVAL_META = C.load_ref("evalsgf")


@pytest.mark.parametrize("case", sorted(C.EVALSGF_CASES))
def test_evalsgf_text_equals_jax(case, sgf_file):
    argv = ["evalsgf", str(sgf_file), "-model", MODEL, "-visits",
            str(EVAL_META["visits"]), "-device", "cpu"]
    got = stdout_of(TSGF.main, argv + C.EVALSGF_CASES[case])
    assert_text_matches(got, str(EVAL[case]))


# the subcommands that raised NotImplementedError naming M12 before they
# were ported; each now parses its own arguments (their runs against the
# JAX package: tests/test_torch_sgftools.py)
M12_SUBCOMMANDS = ("writetrainingdata", "startposes", "samplesgfs",
                   "dataminesgfs", "viewstartposes", "checksgfhintpolicy")


@pytest.mark.parametrize("name", M12_SUBCOMMANDS)
def test_unported_sgf_subcommands_name_m12(name, capsys):
    with pytest.raises(SystemExit) as e:
        TSGF.main([name, "-anything", "x"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "unrecognized arguments" in err or "required" in err


def test_replay_reaches_the_sgf_position():
    from katago_torch.dataio import sgf as S
    game = S.parse_sgf(C.TOOLS_SGF)[0]
    size, rules, states, moves = TSGF._replay(game, 4, device="cpu")
    assert (size, rules.komi, len(states), len(moves)) == (9, 6.5, 5, 4)
    stones = states[-1].pos.board.stones[0]
    assert int((stones != 0).sum()) == 5          # the setup stone + 4
    _, _, states2, _ = TSGF._replay_moves(game, game.moves()[:4], "cpu")
    assert torch.equal(states2[-1].pos.board.stones, stones[None])


PLAY, PLAY_META = C.load_ref("play")


def test_play_transcript_equals_jax(monkeypatch):
    monkeypatch.setattr(TPLAY, "input", C.scripted_input(C.PLAY_INPUTS),
                        raising=False)
    got = stdout_of(TPLAY.main, ["-model", MODEL, "-device", "cpu"]
                    + C.PLAY_ARGS)
    assert_text_matches(got, str(PLAY["transcript"]))


def test_play_vertex_helpers():
    assert TPLAY.parse_vertex("c3", 5) == 12
    assert TPLAY.parse_vertex("pass", 5) == 25
    assert TPLAY.parse_vertex("Z1", 5) is None
    assert TPLAY.parse_vertex("A6", 5) is None
    assert TPLAY.loc_str(12, 5) == "C3" and TPLAY.loc_str(None, 5) == \
        "resign"
    stones = np.zeros(25, np.int64)
    stones[12] = 1
    assert "(X)" in TPLAY.board_str(stones, 5, 12)


@pytest.mark.parametrize("kw", [
    {}, {"rules": "japanese", "komi": 6.5, "boardsize": 9,
         "lag_buffer": 0.5}])
def test_genconfig_text_equals_jax(tmp_path, kw):
    got = TGEN.generate(str(tmp_path / "t.cfg"), log=lambda s: None, **kw)
    want = JGEN.generate(str(tmp_path / "j.cfg"), log=lambda s: None, **kw)
    assert got["max_visits"] == want["max_visits"]
    assert (tmp_path / "t.cfg").read_text() == \
        (tmp_path / "j.cfg").read_text()


@pytest.mark.parametrize("pps", [5.0, 333.3, 2.5e4])
def test_genconfig_benchmark_visits_equal_jax(tmp_path, monkeypatch, pps):
    from katago_tpu.cli import benchmark_cmd as JBEN
    calls = []

    def fake(**kw):
        calls.append(kw)
        return {"results": [{"playouts_per_s": pps}]}
    monkeypatch.setattr(TBEN, "run_benchmark", fake)
    monkeypatch.setattr(JBEN, "run_benchmark", fake)
    got = TGEN.generate(str(tmp_path / "t.cfg"), run_benchmark=True,
                        target_s_per_move=2.0, device="cpu",
                        log=lambda s: None)
    want = JGEN.generate(str(tmp_path / "j.cfg"), run_benchmark=True,
                         target_s_per_move=2.0, log=lambda s: None)
    assert got["max_visits"] == want["max_visits"]
    assert (tmp_path / "t.cfg").read_text() == \
        (tmp_path / "j.cfg").read_text()
    assert calls[0]["device"] == "cpu"


def test_generated_config_loads_in_gtp(tmp_path):
    cfg = tmp_path / "gtp.cfg"
    TGEN.generate(str(cfg), boardsize=5, log=lambda s: None)
    out = io.StringIO()
    eng = TGTP.main(["-model", MODEL, "-config", str(cfg), "-boardsize",
                     "5", "-visits", "4", "-device", "cpu", "-seed", "0"],
                    io.StringIO("genmove b\nquit\n"), out)
    assert out.getvalue().startswith("= ")
    assert eng.search_params.use_lcb_for_selection
    assert eng.lag_buffer == 1.0


def test_benchmark_search_output(capsys):
    out = TBEN.main(["-config", "b1c6", "-size", "5", "-visits", "2",
                     "-batches", "1,2", "-iters", "1", "-device", "cpu"])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == \
        json.loads(json.dumps(out))
    assert set(out) == {"results", "recommended", "device"}
    assert out["device"] == "cpu"
    rows = out["results"]
    assert [r["games_per_batch"] for r in rows] == [1, 2]
    for r in rows:
        assert set(r) == {"games_per_batch", "playouts_per_s",
                          "s_per_search", "compile_s",
                          "elo_effect_vs_first"}
        assert r["playouts_per_s"] == pytest.approx(
            r["games_per_batch"] * 2 / r["s_per_search"])
        assert r["elo_effect_vs_first"] == pytest.approx(120.0 * math.log2(
            r["playouts_per_s"] / rows[0]["playouts_per_s"]))
    assert rows[0]["elo_effect_vs_first"] == 0.0
    assert out["recommended"] == max(
        rows, key=lambda r: r["playouts_per_s"])["games_per_batch"]


def test_benchmark_train_output():
    out = TBEN.main(["-train", "-config", "b1c6", "-size", "5", "-batches",
                     "4", "-steps", "1", "-device", "cpu"])
    assert set(out) == {"train_results", "device"}
    (r,) = out["train_results"]
    assert set(r) == {"batch_size", "steps_per_s", "rows_per_s"}
    assert r["batch_size"] == 4
    assert r["rows_per_s"] == pytest.approx(4 * r["steps_per_s"], rel=0.01)


def b1c6_state(seed: int) -> TSTEP.TrainState:
    """A port TrainState whose params, EMA and SWA are the flax_params
    weights of seed (what init_train_state gives on the JAX side)."""
    arrays, _ = C.load_ref(f"weights_b1c6_s{seed}")
    params = TW.from_flax_params(C.flax_tree(arrays, "w"))
    return TSTEP.init_train_state(params, TSTEP.make_optimizer())


CLEAN, CLEAN_META = C.load_ref("ckpt_clean")


@pytest.mark.parametrize("use_swa", [False, True])
def test_clean_bin_gz_equals_jax_exporter(tmp_path, use_swa):
    path = TCK.save_checkpoint(str(tmp_path / "ckpt"), b1c6_state(4), 0)
    argv = ["clean", "-ckpt", path, "-out", str(tmp_path / "out"),
            "-name", CLEAN_META["name"], "-config", "b1c6", "-size", "5",
            "-bin-gz"] + (["-use-swa"] if use_swa else [])
    got = json.loads(stdout_of(TCT.main, argv))
    want = CLEAN_META["printed"]
    assert got["params"] == want["params"]
    assert got["source_step"] == want["source_step"] == 0
    with gzip.open(got["bin_gz"]) as f:
        assert f.read() == CLEAN["bin"].tobytes()
    exported = TCK.load_params(got["export"])
    for k, v in b1c6_state(4).ema_params.items():
        assert torch.equal(exported[k], v), k


def test_show_and_edit(tmp_path):
    state = b1c6_state(3)
    state.step = 7
    path = TCK.save_checkpoint(str(tmp_path), state, 7,
                               metadata={"global_step": 7})
    shown = json.loads(stdout_of(TCT.main, ["show", "-ckpt", path]))
    n = sum(v.numel() for v in state.params.values())
    assert shown == {"metadata": {"global_step": 7}, "step": 7,
                     "params_count": n, "ema_params_count": n,
                     "swa_params_count": n, "opt_state_count": n + 1}
    out = json.loads(stdout_of(TCT.main, [
        "edit", "-ckpt", path, "-set", "global_step=9", "-set",
        "note=hello", "-set", 'val={"a": [1, 2]}']))
    want = {"global_step": 9, "note": "hello", "val": {"a": [1, 2]}}
    assert out["metadata"] == want == TCK.load_metadata(path)


def test_migrate_fills_swa_and_seki_ema(tmp_path):
    state = b1c6_state(3)
    path = TCK.save_checkpoint(str(tmp_path), state, 0,
                               metadata={"global_step": 0})
    tree = TCK.load_state_tree(path)
    del tree["swa_params"], tree["seki_ema"]
    tree["ema_params"] = {k: v + 1.0 for k, v in tree["ema_params"].items()}
    torch.save(tree, f"{path}/{TCK.STATE_FILE}")
    argv = ["migrate", "-ckpt", path, "-config", "b1c6", "-size", "5"]
    out = json.loads(stdout_of(TCT.main, argv))
    assert out == {"migrated": ["swa_params", "seki_ema"],
                   "rewritten": path}
    template = TSTEP.init_train_state(
        dict(make_model(5, "b1c6", "cpu").named_parameters()),
        TSTEP.make_optimizer())
    back = TCK.restore_checkpoint(path, template)
    for k, v in back.swa_params.items():
        assert torch.equal(v, tree["ema_params"][k]), k
    assert float(back.seki_ema.weight) == pytest.approx(0.001)
    assert float(back.seki_ema.sum) == 0.0
    assert TCK.load_metadata(path) == {"global_step": 0}
    again = json.loads(stdout_of(TCT.main, argv))
    assert again == {"migrated": [], "note": "already current"}


def test_tools_raise_without_cuda(monkeypatch, sgf_file):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TFWD.main(["-model", MODEL, "-size", "5"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSGF.main(["evalsgf", str(sgf_file), "-model", MODEL])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TBEN.main(["-config", "b1c6", "-size", "5", "-batches", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TPLAY.main(["-size", "5"])
