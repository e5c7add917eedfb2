"""The port's C++ host libraries (katago_torch/dataio/csrc/sgfscan.cpp and
dataprep.cpp, built at first use by katago_torch/ops/_hostbuild.py)
against their plain versions, on the CPU.

The scanner (dataio/sgfscan.py::scan_sgf) against the parser
(scan_sgf_plain) on every record of the sgftools fixture's corpus, line by
line as summarize_sgfs reads them, on games drawn by hypothesis
(derandomized) through the port's SGF writer, and on text drawn from the
SGF grammar's characters: the same summary, the same refusal (None) or
an error of the same type, exactly. Malformed lines are refused. The 8
dihedral transforms of the planes and the policy rows (dataio/native.py)
equal numpy's exactly, on square and rectangular boards and several
dtypes. A build whose compiler cannot be run, or fails, raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from katago_torch.dataio import native as TN
from katago_torch.dataio import sgf as TS
from katago_torch.dataio import sgfscan as TSCAN
from katago_torch.ops import _hostbuild

from tests import test_torch_common as C

SETTINGS = settings(max_examples=150, derandomize=True, deadline=None)
MALFORMED = [C.SGF_BROKEN, "", "no game here", "(", "()", "(;", "(;B[aa]",
             "(;B[aa)", "(x;B[aa])", "(;b[aa])", "(;Bb[aa])", "(;B)",
             "((;B[aa]))", "(;B[aa]);(;W[", "(;SZ[5](;B[aa])x)",
             "(;C[unterminated\\])"]


def outcome(fn, text: str):
    """("summary", fields) / ("none",) / ("raises", type name)."""
    try:
        got = fn(text)
    except ValueError as e:
        return ("raises", type(e).__name__)
    if got is None:
        return ("none",)
    return ("summary", dataclasses.asdict(got))


def same(text: str) -> None:
    assert outcome(TSCAN.scan_sgf, text) == \
        outcome(TSCAN.scan_sgf_plain, text), text


def test_scanner_equals_the_parser_on_every_fixture_record():
    corpus = C.sgf_corpus()
    for text in corpus.values():
        same(text)
        for line in text.split("\n"):
            same(line.strip())
    assert all(TSCAN.scan_sgf(t) is not None for t in corpus.values())


@pytest.mark.parametrize("text", MALFORMED)
def test_malformed_lines_are_refused(text):
    assert TSCAN.scan_sgf(text) is None
    assert TSCAN.scan_sgf_plain(text) is None


@pytest.mark.parametrize("text", [
    "(;SZ[abc])", "(;SZ[5:x])", "(;KM[seven])", "(;HA[1.5])",
    "(;SZ[5];B[zz])", "(;SZ[5];B[AA])", "(;SZ[5];B[abc])",
    "(;SZ[5]AB[ff])", "(;SZ[19];B[éa])"])
def test_fields_that_raise_raise_the_same_error(text):
    kind = outcome(TSCAN.scan_sgf_plain, text)
    assert kind[0] == "raises"
    assert outcome(TSCAN.scan_sgf, text) == kind


@pytest.mark.parametrize("text", [
    "(;SZ[ 7 ]KM[ +1_0.5e0 ]HA[007]RE[b+R]PB[a\\]b\\\\c]PW[李昌镐])",
    "(;SZ[5:7]KM[-inf]RE[w+0.5];B[tt];W[];B[ea])",
    "(;SZ[21];B[tt])", "(;SZ[5]　; B[aa] )",
    "(;SZ[5]\x1c;B[aa])", "(;KM[1e400]RE[DRAW])", "(;KM[]HA[]SZ[])",
    "(;SZ[5]B[aa]W[bb]B[cc];AB[dd][ee]AW[aa]AB[tt])",
    "(;SZ[5];B[aa](;W[bb];B[cc])(;W[dd]);B[ee])",
    "(;SZ[5]Ü[x];B[aa])", "(;SZ[5]KM[٣])", "(;RE[B+٣])",
    "junk(;SZ[5];B[aa])more(;SZ[9])"])
def test_edge_records_equal_the_parser(text):
    same(text)


def _games():
    loc = st.integers(0, 24)
    names = st.text(max_size=6)
    return st.builds(
        lambda xs, ys, moves, setup, komi, result, pb, pw, ha: TS.write_sgf(
            [(1 + i % 2, m % (xs * ys + 1)) for i, m in enumerate(moves)],
            xs, ys, komi=komi, result=result, handicap=ha,
            setup=[(c, s % (xs * ys)) for c, s in setup], black_name=pb,
            white_name=pw),
        st.integers(2, 19), st.integers(2, 19),
        st.lists(st.integers(0, 400), max_size=30),
        st.lists(st.tuples(st.sampled_from([1, 2]), loc), max_size=4),
        st.floats(-50, 50, allow_nan=False).map(lambda k: round(k * 2) / 2),
        st.sampled_from([None, "B+R", "W+3.5", "0", "Draw", "B+", "W+x",
                         "b+12"]),
        names, names, st.integers(0, 4))


@SETTINGS
@given(_games())
def test_scanner_equals_the_parser_on_drawn_games(text):
    same(text)
    assert TSCAN.scan_sgf(text) is not None


@SETTINGS
@given(st.text(alphabet="()[];\\ \n\tABWKMSZHREPabcdt019:+.-_é　",
               max_size=40))
def test_scanner_equals_the_parser_on_drawn_text(text):
    same(text)
    same("(;" + text)


@pytest.mark.parametrize("shape", [(3, 4, 5, 5), (2, 3, 5, 7), (1, 1, 19, 19)])
@pytest.mark.parametrize("dtype", [np.float32, np.int64, np.uint8])
def test_plane_symmetries_equal_numpy(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * 100).astype(dtype)
    for sym in range(8):
        got = TN.apply_symmetry_planes(x, sym)
        want = TN.apply_symmetry_planes_plain(x, sym)
        assert got.shape == want.shape and got.dtype == want.dtype, sym
        np.testing.assert_array_equal(got, want, err_msg=str(sym))
    assert TN.apply_symmetry_planes(x, 0) is x


@pytest.mark.parametrize("x_size,y_size", [(5, None), (19, None), (5, 7)])
def test_policy_symmetries_equal_numpy(x_size, y_size):
    rows = x_size * (y_size or x_size) + 1
    p = np.random.default_rng(rows).random((6, rows), np.float32)
    for sym in range(8):
        got = TN.apply_symmetry_policy(p, x_size, sym, y_size)
        want = TN.apply_symmetry_policy_plain(p, x_size, sym, y_size)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=str(sym))
    with pytest.raises(ValueError):
        TN.apply_symmetry_policy(p[:, 1:], x_size, 1, y_size)


def test_a_build_whose_compiler_fails_raises(tmp_path):
    with pytest.raises(RuntimeError, match="cannot run"):
        _hostbuild.build("dataprep", cxx=str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="failed"):
        _hostbuild.build("sgfscan", cxx="false")
    assert _hostbuild.build("dataprep").exists()
