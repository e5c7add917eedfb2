"""humanSL nets, V3-V6 nets and the pattern bonus in the port's search and
front-ends, against the JAX package, on the CPU.

- models/sgfmetadata.py: metadata rows and profiles equal to the JAX
  package's (pure numpy, run live).
- The GTP engine (gtp.main with a humanSLProfile and
  avoidRepeatedPatternUtility config: searches conditioned on the
  profile and penalizing the mover's own shapes, kata-raw-human-nn,
  kata-raw-nn), the analysis engine (overrideSettings humanSLProfile)
  and humanslnet_server on a seeded b1c6 humanSL net
  (tests/data/torch_ref/humansl_b1c6.bin.gz), and both engines on tiny
  nets of model versions 3, 5, 6 and 7 (input features V3-V6), against
  the JAX sessions' saved text (humansl.npz, vnets.npz): tokens exact,
  visits exact, decimals within 1e-4.
- The pattern bonus: the avoid-repeated-shapes table of a 5x5 game's
  moves and of moves made before from its root equal to the JAX
  package's, and a search with it (and without) giving the JAX visits
  exactly (pattern_search.npz).
"""

from __future__ import annotations

import dataclasses
import io
import json

import numpy as np
import pytest
import torch

from katago_tpu.models import sgfmetadata as JMETA
from katago_tpu.search import patternbonus as JPB
from katago_torch.cli import analysis as A
from katago_torch.cli import gtp as G
from katago_torch.cli import humanslnet_server as SRV
from katago_torch.game import history as TH
from katago_torch.models import sgfmetadata as TMETA
from katago_torch.search import patternbonus as TPB
from katago_torch.search.driver import SearchDriver
from katago_torch.search.params import SearchParams

from tests import test_torch_common as C
from tests.test_torch_analysis import assert_json_match
from tests.test_torch_gtp import assert_transcripts_match

HUMANSL, HUMANSL_META = C.load_ref("humansl")
MODEL = str(C.REF_DIR / HUMANSL_META["model"])
VNETS, VNETS_META = C.load_ref("vnets")
PATTERN, PATTERN_META = C.load_ref("pattern_search")

PROFILES = ["rank_5d", "rank_3d_2k", "preaz_9d", "proyear_1990",
            "proyear_2022", "rank_20k", ""]


@pytest.mark.parametrize("name", PROFILES)
def test_metadata_rows_and_profiles_match_jax(name):
    t, j = TMETA.get_profile(name), JMETA.get_profile(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    if not t.initialized:
        for mod, meta in ((TMETA, t), (JMETA, j)):
            with pytest.raises(ValueError, match="uninitialized"):
                mod.fill_metadata_row(meta, False, 361)
        return
    for white in (False, True):
        for area in (81, 361):
            np.testing.assert_array_equal(
                TMETA.fill_metadata_row(t, white, area),
                JMETA.fill_metadata_row(j, white, area))


def test_metadata_wire_format_and_bad_profiles_match_jax():
    wire = json.loads(C.HUMANSL_SERVER_SCRIPT.splitlines()[3])["sgfmeta"]
    t, j = TMETA.SGFMetadata.of_dict(wire), JMETA.SGFMetadata.of_dict(wire)
    assert t.to_dict() == j.to_dict()
    np.testing.assert_array_equal(TMETA.fill_metadata_row(t, True, 81),
                                  JMETA.fill_metadata_row(j, True, 81))
    for bad in ("rank_10d", "proyear_1700", "frobnicate"):
        for mod in (TMETA, JMETA):
            with pytest.raises(ValueError, match="unknown humanSL profile"):
                mod.get_profile(bad)


def test_gtp_humansl_session_matches_jax(tmp_path):
    cfg = tmp_path / "gtp.cfg"
    cfg.write_text(C.HUMANSL_GTP_CONFIG)
    out = io.StringIO()
    eng = G.main(["-model", MODEL, "-config", str(cfg), "-boardsize", "9",
                  "-device", "cpu"], io.StringIO(C.HUMANSL_GTP_SCRIPT), out)
    assert_transcripts_match(out.getvalue(), str(HUMANSL["gtp"]))
    assert eng.sgf_meta is not None
    assert eng.search_params.avoid_repeated_pattern_utility == 0.3
    # the human policy differs from the unconditioned one
    blocks = out.getvalue().split("\n\n")
    human = next(b for b in blocks if "whiteWin" in b)
    plain = [b for b in blocks if "whiteWin" in b][1]
    assert human != plain


def test_analysis_humansl_queries_match_jax():
    eng = A.AnalysisEngine(MODEL, device="cpu")
    out = io.StringIO()
    A.run_protocol(eng, io.StringIO(C.HUMANSL_ANALYSIS_SCRIPT), out)
    got = [json.loads(x) for x in out.getvalue().splitlines()]
    want = [json.loads(x) for x in str(HUMANSL["analysis"]).splitlines()]
    assert len(got) == len(want) == 3
    for i, (g, w) in enumerate(zip(got, want)):
        assert_json_match(g, w, f"response {i}")
    # the tree cache is keyed by the profile too (the JAX engine's is not;
    # ROADMAP Queue 3): h2's position without its profile searches anew,
    # with it the cached tree answers
    h2 = json.loads(C.HUMANSL_ANALYSIS_SCRIPT.splitlines()[1])
    assert eng._tree_cache_hits == 0
    plain = dict(h2, overrideSettings={})
    assert eng.handle(plain)[-1]["rootInfo"]["visits"] == 6
    assert eng._tree_cache_hits == 0
    again = eng.handle(h2)[-1]
    assert eng._tree_cache_hits == 1
    assert again["rootInfo"]["visits"] == got[1]["rootInfo"]["visits"]
    assert [(m["move"], m["visits"]) for m in again["moveInfos"]] == \
        [(m["move"], m["visits"]) for m in got[1]["moveInfos"]]


def test_humanslnet_server_session_matches_jax():
    out = io.StringIO()
    SRV.main(["-model", MODEL, "-device", "cpu"],
             io.StringIO(C.HUMANSL_SERVER_SCRIPT), out)
    got = [json.loads(x) for x in out.getvalue().splitlines()]
    want = [json.loads(x) for x in str(HUMANSL["server"]).splitlines()]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_json_match(g, w, f"response {i}")
    outputs = [r["outputs"] for r in got if isinstance(
        r.get("outputs"), dict)]
    assert len(outputs) == 3 and all(o["moves_and_probs0"] for o in outputs)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SRV.main(["-model", MODEL], io.StringIO(""), io.StringIO())


def _vnet(tmp_path, version) -> str:
    path = str(tmp_path / f"v{version}.txt.gz")
    C.write_tiny_model(path, version, seed=version)
    return path


@pytest.mark.parametrize("version", VNETS_META["versions"])
def test_gtp_serves_older_input_versions_like_jax(version, tmp_path):
    eng = G.GTPEngine(model_path=_vnet(tmp_path, version),
                      size=VNETS_META["size"], visits=VNETS_META["visits"],
                      device="cpu", seed=0)
    assert eng.feature_version == C.DESC_VERSIONS[version][0]
    out = io.StringIO()
    G.run_gtp(eng, io.StringIO(C.VNET_GTP_SCRIPT), out)
    assert_transcripts_match(out.getvalue(), str(VNETS[f"gtp_v{version}"]))
    # kata-raw-nn feeds the net its own input version (the JAX engine
    # feeds V7 and fails on these nets; ROADMAP Queue 3)
    raw = eng.raw_nn().splitlines()
    assert raw[0].startswith("whiteWin") and len(raw) == 4 + 5 + 1


@pytest.mark.parametrize("version", VNETS_META["versions"])
def test_analysis_serves_older_input_versions_like_jax(version, tmp_path):
    eng = A.AnalysisEngine(_vnet(tmp_path, version), device="cpu")
    out = io.StringIO()
    A.run_protocol(eng, io.StringIO(C.VNET_ANALYSIS_SCRIPT), out)
    got = [json.loads(x) for x in out.getvalue().splitlines()]
    want = [json.loads(x) for x in
            str(VNETS[f"analysis_v{version}"]).splitlines()]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_json_match(g, w, f"response {i}")
    assert got[-1]["rootInfo"]["visits"] == 8


@pytest.mark.parametrize("win", [5, 9])
def test_local_pattern_hashes_match_jax(win):
    """The batched hash with atari keys and the 16 symmetry images, and
    the host hash, against the JAX package's host_pattern_hash (numpy,
    bit-identical to its device hash) on seeded 9x9 boards."""
    from katago_tpu.search import localpattern as JLP
    from katago_torch.search import localpattern as TLP
    size, g = 9, 24
    boards = C.random_boards(size, g, seed=win)
    rng = np.random.default_rng(win)
    loc = rng.integers(-1, size * size + 1, g)
    pla = rng.integers(1, 3, g)
    sym = rng.integers(0, 8, g)
    flip = rng.random(g) < 0.5
    atari = rng.random((g, size * size)) < 0.2
    want = np.stack([JLP.host_pattern_hash(
        boards[i], int(loc[i]), int(pla[i]), size, win, atari=atari[i],
        symmetry=int(sym[i]), flip_colors=bool(flip[i]))
        for i in range(g)]).astype(np.int64)
    got = TLP.local_pattern_hash(
        torch.from_numpy(boards), torch.from_numpy(loc),
        torch.from_numpy(pla), size, win, atari=torch.from_numpy(atari),
        symmetry=torch.from_numpy(sym), flip_colors=torch.from_numpy(flip))
    np.testing.assert_array_equal(C.to_np(got), want)
    host = np.stack([TLP.host_pattern_hash(
        boards[i], int(loc[i]), int(pla[i]), size, win, atari=atari[i],
        symmetry=int(sym[i]), flip_colors=bool(flip[i]))
        for i in range(g)]).astype(np.int64)
    np.testing.assert_array_equal(host, want)
    plain = TLP.local_pattern_hash(torch.from_numpy(boards),
                                   torch.from_numpy(loc),
                                   torch.from_numpy(pla), size, win)
    np.testing.assert_array_equal(C.to_np(plain), np.stack([
        JLP.host_pattern_hash(boards[i], int(loc[i]), int(pla[i]), size,
                              win) for i in range(g)]).astype(np.int64))


def _pattern_game():
    """The fixture's game on the port: boards before each move, the
    movers, and the position after the moves."""
    size = PATTERN_META["size"]
    gs = TH.new_game(size, C.RULESETS["tromp_taylor"][1], 64, g=1,
                     device="cpu")
    boards, plas = [], []
    for mv in PATTERN_META["moves"]:
        boards.append(C.to_np(gs.pos.board.stones[0]))
        plas.append(int(gs.pos.to_move[0]))
        gs, _ = TH.step(gs, torch.tensor([mv]), size)
    return boards, plas, gs


def _pattern_history(boards, plas, gs):
    return C.pattern_history(boards, plas, C.to_np(gs.pos.board.stones[0]),
                             int(gs.pos.to_move[0]))


def test_pattern_bonus_table_matches_jax():
    boards, plas, gs = _pattern_game()
    size = PATTERN_META["size"]
    pla_for = int(gs.pos.to_move[0])
    assert pla_for == PATTERN_META["pla_for"]
    hist = _pattern_history(boards, plas, gs)
    t = TPB.build_avoid_repeat_table(*hist, size, pla_for,
                                     PATTERN_META["utility"], "cpu")
    j = JPB.build_avoid_repeat_table(*hist, size, pla_for,
                                     PATTERN_META["utility"])
    for name in ("keys", "bonus"):
        np.testing.assert_array_equal(C.to_np(getattr(t, name)),
                                      np.asarray(getattr(j, name)).astype(
                                          C.to_np(getattr(t, name)).dtype))
        np.testing.assert_array_equal(
            C.to_np(getattr(t, name)),
            PATTERN[name].astype(C.to_np(getattr(t, name)).dtype))
    assert TPB.build_avoid_repeat_table(*hist, size, pla_for, 0.0,
                                        "cpu") is None


@pytest.mark.parametrize("tag", ["on", "off"])
def test_pattern_bonus_search_gives_jax_visits(tag):
    boards, plas, roots = _pattern_game()
    size, visits = PATTERN_META["size"], PATTERN_META["visits"]
    table = None
    if tag == "on":
        table = TPB.build_avoid_repeat_table(
            *_pattern_history(boards, plas, roots), size,
            PATTERN_META["pla_for"], PATTERN_META["utility"], "cpu")
    sp = dataclasses.replace(SearchParams.for_selfplay(),
                             root_noise_enabled=False).to_arr("cpu")
    drv = SearchDriver(C.ref_model(size), sp, size=size,
                       max_nodes=PATTERN_META["max_nodes"],
                       chunk_size=PATTERN_META["chunk_size"],
                       with_ladders=True, device="cpu")
    res = drv.search(roots, torch.Generator().manual_seed(0),
                     max_visits=visits + 1, pattern_bonus=table)
    for name in ("root_visits", "child_visits"):
        np.testing.assert_array_equal(C.to_np(getattr(res, name)),
                                      PATTERN[f"{tag}/{name}"], err_msg=name)
    np.testing.assert_array_equal(C.to_np(res.ss.tree.num_nodes),
                                  PATTERN[f"{tag}/num_nodes"])
    np.testing.assert_allclose(C.to_np(res.ss.tree.stats[..., 17]),
                               PATTERN[f"{tag}/pattern_stats"], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(C.to_np(res.root_utility),
                               PATTERN[f"{tag}/root_utility"], rtol=0,
                               atol=1e-4)
    if tag == "on":
        # the bonus reached the tree and changed the search
        assert (PATTERN["on/pattern_stats"] != 0).any()
        assert not np.array_equal(PATTERN["on/child_visits"],
                                  PATTERN["off/child_visits"])
