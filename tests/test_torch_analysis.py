"""The port's JSON analysis engine against the JAX engine's saved
output (tests/data/torch_ref/analysis.npz) on the scripted 5x5 queries
of tests.test_torch_common.ANALYSIS_SCRIPTS (the b1c6 .bin.gz): every
response in order with the same JSON keys, visit counts, moves, PVs and
strings exact, floats within 1e-4. The script covers analyzeTurns,
avoidMoves / allowMoves, includeOwnership / MovesOwnership / PVVisits /
Policy, reportDuringSearchEvery, the tree cache, priorities, terminate,
warnings and errors."""

import io
import json

import pytest
import torch

from katago_torch.cli import analysis as A

from tests import test_torch_common as C

REF, META = C.load_ref("analysis")
MODEL = str(C.REF_DIR / META["model"])


def assert_json_match(got, want, path="$"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            assert_json_match(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            assert_json_match(a, b, f"{path}[{i}]")
    elif isinstance(want, float):
        assert isinstance(got, (int, float)), path
        assert abs(got - want) <= 1e-4, f"{path}: {got} vs {want}"
    else:
        assert type(got) is type(want) and got == want, \
            f"{path}: {got!r} vs {want!r}"


@pytest.mark.parametrize("name", sorted(C.ANALYSIS_SCRIPTS))
def test_scripted_queries_match_jax(name, capsys):
    eng = A.AnalysisEngine(MODEL, device="cpu")
    out = io.StringIO()
    A.run_protocol(eng, io.StringIO(C.ANALYSIS_SCRIPTS[name]), out)
    got = [json.loads(x) for x in out.getvalue().splitlines()]
    want = [json.loads(x) for x in str(REF[name]).splitlines()]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_json_match(g, w, f"response {i}")
    # the repeated query hit the tree cache for each of its turns
    assert eng._tree_cache_hits == 3
    assert "evalcache hit" in capsys.readouterr().err
    final = [r for r in got if "rootInfo" in r and not r.get(
        "isDuringSearch")]
    assert all(r["moveInfos"] for r in final)
    assert any(r.get("isDuringSearch") for r in got)


def test_cache_hit_runs_no_new_playouts():
    eng = A.AnalysisEngine(MODEL, device="cpu")
    q = {"id": "a", "moves": [["B", "C3"]], "boardXSize": 5,
         "maxVisits": 9}
    first = eng.handle(q)[0]
    tree = next(iter(eng._tree_cache.values()))
    nodes = int(tree.num_nodes[0])
    again = eng.handle(dict(q, id="b"))[0]
    assert eng._tree_cache_hits == 1
    assert again["rootInfo"]["visits"] == first["rootInfo"]["visits"] == 9
    assert int(next(iter(eng._tree_cache.values())).num_nodes[0]) == nodes
    assert [m["visits"] for m in again["moveInfos"]] == \
        [m["visits"] for m in first["moveInfos"]]


def test_report_perspective_and_refusals():
    q = {"id": "p", "moves": [["B", "C3"]], "boardXSize": 5,
         "maxVisits": 6}
    side = A.AnalysisEngine(MODEL, device="cpu").handle(q)[0]
    black = A.AnalysisEngine(MODEL, device="cpu",
                             report_winrates_as="BLACK").handle(q)[0]
    # white to move: the black perspective flips the winrate
    assert abs(side["rootInfo"]["winrate"] + black["rootInfo"]["winrate"]
               - 1.0) < 1e-6
    eng = A.AnalysisEngine(MODEL, device="cpu")
    r = eng.handle(dict(q, overrideSettings={"humanSLProfile": "rank_1d"}))
    assert "metadata-encoder net" in r[-1]["error"]
    r = A.AnalysisEngine(None, device="cpu").handle(q)
    assert r[-1]["error"].startswith("no model loaded")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            A.AnalysisEngine(MODEL)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            A.main(["-model", MODEL], io.StringIO(""), io.StringIO())
