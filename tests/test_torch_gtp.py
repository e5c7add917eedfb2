"""The port's GTP engine against the JAX engine's saved transcripts
(tests/data/torch_ref/gtp.npz): the scripted 9x9 session of
tests.test_torch_common.GTP_SCRIPT on the b1c6 .bin.gz (visit-bounded
searches, clocks only through kata-debug-print-tc) and a session through
gtp.main with a config file. Status, moves and every other token exact;
tokens that are decimals within 1e-4. Then what the transcripts cannot
show: the device rule, the default net, pondering, loadsgf/printsgf and
the humanSL profile's need of a metadata-encoder net."""

import io

import pytest
import torch

from katago_torch.cli import gtp as G
from katago_torch.game import board as B

from tests import test_torch_common as C

REF, META = C.load_ref("gtp")
MODEL = str(C.REF_DIR / META["model"])


def _is_decimal(tok):
    try:
        float(tok)
    except ValueError:
        return False
    return "." in tok or "e" in tok.lower()


def assert_transcripts_match(got: str, want: str):
    gl, wl = got.splitlines(), want.splitlines()
    assert len(gl) == len(wl), (len(gl), len(wl))
    for i, (g, w) in enumerate(zip(gl, wl)):
        gt, wt = g.split(), w.split()
        assert len(gt) == len(wt), f"line {i}: {g!r} != {w!r}"
        for a, b in zip(gt, wt):
            if _is_decimal(b) and _is_decimal(a):
                assert abs(float(a) - float(b)) <= 1e-4, \
                    f"line {i}: {a} vs {b}"
            else:
                assert a == b, f"line {i}: {g!r} != {w!r}"


def test_scripted_session_matches_jax_transcript():
    eng = G.GTPEngine(model_path=MODEL, size=META["size"],
                      visits=META["visits"], device="cpu", seed=0)
    out = io.StringIO()
    G.run_gtp(eng, io.StringIO(C.GTP_SCRIPT), out)
    assert_transcripts_match(out.getvalue(), str(REF["transcript"]))


def test_main_with_config_matches_jax_transcript(tmp_path):
    cfg = tmp_path / "gtp.cfg"
    cfg.write_text(C.GTP_CONFIG)
    out = io.StringIO()
    eng = G.main(["-model", MODEL, "-config", str(cfg), "-boardsize", "9",
                  "-device", "cpu"], io.StringIO(C.GTP_MAIN_SCRIPT), out)
    assert_transcripts_match(out.getvalue(), str(REF["main_transcript"]))
    assert eng.lag_buffer == 0.5 and eng.allow_resignation


def test_entry_points_run_on_cuda_unless_told_otherwise():
    if torch.cuda.is_available():
        assert G.GTPEngine(size=5).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        G.GTPEngine(size=5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        G.main(["-boardsize", "5"], io.StringIO("quit\n"), io.StringIO())


def session(eng, script):
    out = io.StringIO()
    G.run_gtp(eng, io.StringIO(script), out)
    return [b.strip() for b in out.getvalue().split("\n\n") if b.strip()]


def test_default_net_and_benchmark():
    eng = G.GTPEngine(size=5, visits=8, device="cpu", seed=1)
    out = session(eng, "version\ngenmove b\nkata-benchmark 6\n"
                       "kata-get-models\nquit\n")
    assert out[0] == "= 0.1.0 (random-init-b2c16)"
    loc = G.gtp_to_loc(out[1][2:], 5)
    assert eng.stones_np()[loc] == B.BLACK or loc == 25
    assert out[2].startswith("= visits 6 time ") and "visits/s" in out[2]
    assert '"maxBatchSize": 1' in out[3]


def test_pondering_searches_between_moves():
    eng = G.GTPEngine(model_path=MODEL, size=9, visits=8, device="cpu",
                      seed=2)
    out = session(eng, "kata-set-param ponderingEnabled true\nplay b E5\n"
                       "genmove w\nquit\n")
    assert all(o.startswith("=") for o in out)
    assert eng._ponder is None           # quit stopped it
    eng.maybe_start_ponder()
    assert eng._ponder is not None
    import time
    time.sleep(0.5)
    eng.stop_ponder()
    assert int(eng._reuse_tree.visits[0, 0]) > 1
    # the next genmove searches on from the ponder's tree
    before = int(eng._reuse_tree.visits[0, 0])
    eng.ponder_enabled = False
    eng.genmove(B.BLACK)
    assert int(eng.last_search_result.root_visits[0]) >= min(before, 8)


def test_printsgf_then_loadsgf_round_trip(tmp_path):
    eng = G.GTPEngine(model_path=MODEL, size=9, visits=4, device="cpu",
                      seed=3)
    path = tmp_path / "g.sgf"
    out = session(eng, f"komi 5.5\nplay b C3\nplay w D4\nplay b pass\n"
                       f"play w E5\nprintsgf {path}\nshowboard\nquit\n")
    board = out[-2]
    eng2 = G.GTPEngine(model_path=MODEL, size=9, visits=4, device="cpu",
                       seed=3)
    out2 = session(eng2, f"loadsgf {path}\nshowboard\nget_komi\n"
                         f"loadsgf {path} 3\nshowboard\nquit\n")
    assert out2[1] == board and out2[2] == "= 5.5"
    assert out2[4].count("X") == 1 and out2[4].count("O") == 1


def test_human_sl_profile_is_refused():
    """humanSLProfile needs a metadata-encoder net, as in the JAX engine
    (tests/test_torch_humansl.py serves one); unknown profiles raise."""
    with pytest.raises(ValueError, match="metadata-encoder net"):
        G.GTPEngine(model_path=MODEL, size=9, device="cpu",
                    human_sl_profile="rank_9d")
    with pytest.raises(ValueError, match="unknown humanSL profile"):
        G.GTPEngine(model_path=MODEL, size=9, device="cpu",
                    human_sl_profile="rank_10d")
    eng = G.GTPEngine(model_path=MODEL, size=9, device="cpu")
    out = session(eng, "kata-raw-human-nn\nquit\n")
    assert out[0].startswith("? ") and "humanSLProfile" in out[0]
