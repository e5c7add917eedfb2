"""The port's SGF tools (katago_torch/dataio/sgfscan.py,
cli/summarize_sgfs_cmd.py, the six data subcommands of cli/sgf_cmds.py,
cli/npz_tools_cmd.py) against the JAX package's, on the CPU.

The JAX side is the saved `sgftools` reference (tests/data/torch_ref/
sgftools.npz, tools/make_torch_fixtures.py): its outputs on
tests.test_torch_common.sgf_corpus (7x7 games with names, results,
comments, a pass, variations, handicap stones and a 9x9 game) for the
argument lists of SGF_TOOL_CASES / SGF_VIEW_CASES, and npz_tools on
seeded shards.

Exact: scan summaries, summarize_sgfs, writetrainingdata arrays, the
startposes / samplesgfs / viewstartposes outputs, npz_tools counts and
metadata rows. dataminesgfs: hint locations, positions and contexts
exact, weights within 1e-5; checksgfhintpolicy: every token equal but
decimals, which may differ by one unit of their last printed digit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import re
import shutil

import numpy as np
import pytest

from katago_torch.cli import npz_tools_cmd as TNPZ
from katago_torch.cli import sgf_cmds as TSGF
from katago_torch.cli import summarize_sgfs_cmd as TSUM
from katago_torch.dataio import sgfscan as TSCAN

from tests import test_torch_common as C

REF, META = C.load_ref("sgftools")
OUT = META["outputs"]
MODEL = str(C.REF_DIR / "b1c6_s3.bin.gz")
DECIMAL = re.compile(r"[+-]?\d+\.\d+")
# JSON keys whose values are paths of the run's own directories
PATH_KEYS = ("output", "outdir", "out_dir", "out")


def stdout_of(fn, *args) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue()


def json_without_paths(line: str) -> dict:
    return {k: v for k, v in json.loads(line).items() if k not in PATH_KEYS}


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The corpus written out, and a cache of each case's run."""
    root = tmp_path_factory.mktemp("sgftools")
    corpus = C.sgf_corpus()
    (root / "sgf").mkdir()
    for name, text in corpus.items():
        (root / "sgf" / name).write_text(text)
    (root / "sgf" / "more.sgfs").write_text(
        "\n".join([corpus["g0.sgf"], corpus["g3.sgf"]]) + "\n")
    return {"root": root, "runs": {}}


def run_case(work, name: str):
    """The port's run of SGF_TOOL_CASES[name] (once per module):
    (stdout, output directory)."""
    if name not in work["runs"]:
        out = work["root"] / name
        out.mkdir()
        argv = [a.format(sgf=work["root"] / "sgf", out=out, model=MODEL)
                for a in C.SGF_TOOL_CASES[name]]
        flag = "-device" if argv[0] in ("writetrainingdata",
                                        "startposes") else "--device"
        work["runs"][name] = (stdout_of(TSGF.main, argv + [flag, "cpu"]),
                              out)
    return work["runs"][name]


def texts(d) -> dict:
    return {p.name: p.read_text() for p in sorted(d.iterdir())
            if p.suffix != ".npz"}


def test_corpus_is_the_fixtures():
    assert C.sgf_corpus() == META["corpus"]


@pytest.mark.parametrize("name", sorted(C.sgf_corpus()))
def test_scan_summary_equals_jax(name):
    got = dataclasses.asdict(TSCAN.scan_sgf(C.sgf_corpus()[name]))
    assert json.loads(json.dumps(got)) == OUT["scan"][name]
    assert TSCAN.scan_sgf_or_parse is TSCAN.scan_sgf


def test_scan_refuses_a_malformed_line_as_the_jax_parser_does():
    # the JAX package's native scanner returns a summary of this line;
    # its own parser (the fallback) and the port's refuse it
    assert OUT["broken"]["native"] is not None
    assert OUT["broken"]["parser"] is False
    assert TSCAN.scan_sgf(C.SGF_BROKEN) is None


@pytest.mark.parametrize("kind", ["json", "text"])
def test_summarize_sgfs_equals_jax(kind, work):
    extra = ["-json"] if kind == "json" else []
    got = stdout_of(TSUM.main, [str(work["root"] / "sgf")] + extra)
    assert got == OUT["summarize"][kind]


NPZ_CASES = [n for n in C.SGF_TOOL_CASES if n.startswith("write")]
POSE_CASES = [n for n in C.SGF_TOOL_CASES
              if n.startswith(("startposes", "samplesgfs"))]
MINE_CASES = [n for n in C.SGF_TOOL_CASES if n.startswith("datamine")]


@pytest.mark.parametrize("name", NPZ_CASES)
def test_writetrainingdata_arrays_equal_jax(name, work):
    printed, out = run_case(work, name)
    assert json_without_paths(printed.splitlines()[-1]) == \
        json_without_paths(OUT[name]["stdout"].splitlines()[-1])
    with np.load(out / "rows.npz") as z:
        got = {k: z[k] for k in z.files}
    want = {k.split("/", 1)[1]: v for k, v in REF.items()
            if k.startswith(name + "/")}
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


@pytest.mark.parametrize("name", POSE_CASES)
def test_pose_files_equal_jax(name, work):
    printed, out = run_case(work, name)
    assert json_without_paths(printed.splitlines()[-1]) == \
        json_without_paths(OUT[name]["stdout"].splitlines()[-1])
    assert texts(out) == OUT[name]["files"]


def _poses(text: str) -> list:
    return [json.loads(line) for line in text.splitlines() if line]


@pytest.mark.parametrize("name", MINE_CASES)
def test_dataminesgfs_hints_equal_jax(name, work):
    printed, out = run_case(work, name)
    assert json_without_paths(printed.splitlines()[-1]) == \
        json_without_paths(OUT[name]["stdout"].splitlines()[-1])
    got, want = texts(out), OUT[name]["files"]
    assert set(got) == set(want)
    for fname, text in want.items():
        gp, wp = _poses(got[fname]), _poses(text)
        assert len(gp) == len(wp)
        for g, w in zip(gp, wp):
            assert abs(g.pop("weight") - w.pop("weight")) <= 1e-5
            assert g == w


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


VIEW_CASES = [(src, v) for src, views in C.SGF_VIEW_CASES.items()
              for v in views]


@pytest.mark.parametrize("src,view", VIEW_CASES,
                         ids=[v for _, v in VIEW_CASES])
def test_pose_views_equal_jax(src, view, work):
    _, out = run_case(work, src)
    files = sorted(out.glob("*.txt")) + sorted(out.glob("*.jsonl"))
    argv = C.SGF_VIEW_CASES[src][view]
    argv = [argv[0]] + [a for f in files if "hashes" not in f.name
                        for a in ("--start-poses-file", str(f))] + [
        a.format(model=MODEL) for a in argv[1:]]
    if argv[0] == "checksgfhintpolicy" or "--check-legality" in argv:
        argv += ["--device", "cpu"]
    got = stdout_of(TSGF.main, argv)
    assert_text_matches(got, OUT[view]["stdout"])


def test_viewstartposes_flags_an_illegal_pose(tmp_path):
    from katago_torch.dataio.poses import PositionSample
    stones = np.zeros(25, np.int8)
    stones[12] = 1
    bad = PositionSample(x_size=5, y_size=5, stones=stones, next_pla=2,
                         moves=[(2, 12)], hint_loc=-1)
    path = tmp_path / "bad.txt"
    path.write_text(bad.to_json_line() + "\n")
    got = stdout_of(TSGF.main, ["viewstartposes", "--start-poses-file",
                                str(path), "--check-legality", "--device",
                                "cpu"])
    assert "[illegal context move 12]" in got
    assert json.loads(got.splitlines()[-1]) == {"poses": 1, "shown": 1,
                                                "illegal": 1}


@pytest.fixture
def npz_dir(tmp_path):
    d = tmp_path / "npz"
    C.write_shards(d / "a", C.SGF_SIZE, [5, 7], 1)
    C.write_shards(d / "b", C.SGF_SIZE, [3], 2)
    return d


def test_npz_summarize_equals_jax(npz_dir):
    (npz_dir / "b" / "bad.npz").write_bytes(b"not a zip")
    got = stdout_of(TNPZ.main, ["summarize", str(npz_dir / "a"),
                                str(npz_dir / "b")])
    assert got.replace(str(npz_dir), "{dir}") == OUT["npz_summarize"]


@pytest.mark.parametrize("prof", C.NPZ_PROFILES)
def test_npz_add_meta_rows_equal_jax(prof, npz_dir):
    name = prof or "selfplay"
    argv = ["add-meta", "-dir", str(npz_dir), "-profile", prof,
            "-board-area", str(C.SGF_SIZE ** 2)]
    assert stdout_of(TNPZ.main, argv + ["-force"]) == \
        OUT[f"add_meta_{name}"]
    for f in sorted(npz_dir.rglob("*.npz")):
        with np.load(f) as z:
            got = z["metadataInputNC"]
        want = REF[f"meta_{name}/{f.parent.name}/{f.name}"]
        assert got.dtype == want.dtype and np.array_equal(got, want)
    # without -force the stamped files are skipped
    again = json.loads(stdout_of(TNPZ.main, argv))
    assert (again["stamped"], again["skipped"]) == (0, 3)


def test_sgf_tools_raise_without_cuda(monkeypatch, work):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = work["root"] / "nocuda"
    with pytest.raises(RuntimeError, match="no CUDA"):
        TSGF.main(["startposes", "-sgf-dir", str(work["root"] / "sgf"),
                   "-output", str(out)])
    shutil.rmtree(out, ignore_errors=True)
