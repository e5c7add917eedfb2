"""The port's selfplay data path vs katago_tpu: play_games (5x5, b1c6
fp32, 2 games, 8 visits, tree reuse, exact ladder planes in the rows)
against the reference fixtures tests/data/torch_ref/selfplay.npz and
resign.npz (the same games with resignation on),
_place_handicap / _adjust_komi_to_even against handicap.npz, the numpy
halves of the writer, play settings and game initializer against the JAX
package's own functions, and the selfplay CLI on the CPU."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from katago_tpu.dataio import trainingwrite as JTW
from katago_tpu.selfplay import gameinit as JGI
from katago_tpu.selfplay import playsettings as JPS
from katago_torch.cli import selfplay_cmd as SC
from katago_torch.dataio import poses as TPOS
from katago_torch.dataio import sgf as TSGF
from katago_torch.dataio import trainingwrite as TTW
from katago_torch.game import history as TH
from katago_torch.search import mcts
from katago_torch.search.params import SearchParams
from katago_torch.selfplay import gameinit as TGI
from katago_torch.selfplay import loop as LOOP
from katago_torch.selfplay import playsettings as TPS

from tests import test_torch_common as C

SCHEMA = json.loads((C.REF_DIR / "npz_schema.json").read_text())["per_row"]
# integer channels quantized from MCTS floats (q * 32000, score * 60):
# floats within 1e-4 may round to neighbouring integers, so these are held
# to one quantum; every other integer channel comes from exact inputs
FROM_SEARCH_FLOATS = ("qValueTargetsNCMove",)


def check_schema(arrays, size):
    """Keys, dtypes and per-row shapes of a training npz against the
    schema pinned by the fixture."""
    want = SCHEMA[str(size)]
    assert sorted(arrays) == sorted(want)
    for k, (dtype, shape) in want.items():
        assert str(arrays[k].dtype) == dtype, k
        assert list(arrays[k].shape[1:]) == shape, k


@pytest.fixture(scope="module", params=["selfplay", "resign"])
def selfplay(request):
    """The port's play_games on a fixture's setup: games played to the
    end, and the same games with resignation on (game 0 resigns)."""
    ref, meta = C.load_ref(request.param)
    resign = {k: meta[k] for k in ("resign_threshold",
                                   "resign_consec_turns") if k in meta}
    size, g = meta["size"], meta["num_games"]
    rules = TH.RulesArr.from_rules(C.RULESETS["tromp_taylor"][1], g, "cpu")
    rules.komi = torch.tensor(meta["komi"], dtype=torch.float32)
    sp = dataclasses.replace(SearchParams.for_selfplay(),
                             root_noise_enabled=False,
                             chosen_move_temperature=0.0,
                             chosen_move_temperature_early=0.0)
    timings = {}
    data, stats = LOOP.play_games(
        C.ref_model(size, seed=4), size=size, num_games=g,
        visits=meta["visits"], search_params=sp,
        gen=torch.Generator().manual_seed(meta["seed"]), device="cpu",
        tree_reuse=True, play_settings=TPS.PlaySettings.for_testing(
            meta["visits"]), game_rules=rules, timings=timings, **resign)
    return ref, meta, data, stats, timings


def test_play_games_matches_jax(selfplay):
    ref, meta, data, stats, timings = selfplay
    assert meta["all_finished"] and stats["all_finished"]
    for f in dataclasses.fields(data):
        got, want = getattr(data, f.name), ref[f"data/{f.name}"]
        assert got.dtype == want.dtype and got.shape == want.shape, f.name
        if got.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4,
                                       err_msg=f.name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f.name)
    for k, v in stats.items():
        want = ref[f"stats/{k}"]
        if np.asarray(v).dtype.kind == "f":
            np.testing.assert_allclose(v, want, rtol=0, atol=1e-4)
        else:
            np.testing.assert_array_equal(v, want, err_msg=k)
    # the rows hold laddered stones, a draw and both colors to move
    assert data.spatial[..., 14].any()
    assert (data.value_target[:, 0] == 0.5).any()
    assert set(data.to_move.tolist()) == {1, 2}
    # the instrumentation counted every move and every exact solve
    assert timings["moves"] == stats["moves_per_game"].max()
    assert timings["ladder"]["calls"] == timings["recorded_moves"]
    assert stats["resignations"] == (1 if "resign_threshold" in meta else 0)


def test_to_npz_arrays_match_jax(selfplay):
    ref, meta, data, stats, _ = selfplay
    arrays = data.to_npz_arrays(meta["size"], stats["white_minus_black"],
                                komi_white=stats["komi_white"])
    check_schema(arrays, meta["size"])
    assert sorted(arrays) == sorted(k[4:] for k in ref if
                                    k.startswith("npz/"))
    for k, got in arrays.items():
        want = ref[f"npz/{k}"]
        assert got.dtype == want.dtype and got.shape == want.shape, k
        if got.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4,
                                       err_msg=k)
        elif k in FROM_SEARCH_FLOATS:
            np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=0, atol=0)
            np.testing.assert_allclose(got, want, rtol=0, atol=1, err_msg=k)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)
    pol = arrays["policyTargetsNCMove"][:, 0].astype(np.float64)
    np.testing.assert_allclose(pol.sum(1), 30000, atol=pol.shape[1])


def test_handicap_and_komi_compensation_match_jax():
    ref, meta = C.load_ref("handicap")
    size = meta["size"]
    g = len(meta["num_handicap"])
    games = TH.new_game(size, C.RULESETS["tromp_taylor"][1],
                        meta["max_hist"], g=g, device="cpu")
    games = dataclasses.replace(games, rules=dataclasses.replace(
        games.rules, komi=torch.from_numpy(ref["komi_in"])))
    games = LOOP._place_handicap(games, np.asarray(meta["num_handicap"]),
                                 size)
    for name, got in (("stones", games.pos.board.stones),
                      ("to_move", games.pos.to_move),
                      ("pos_hash", games.pos.board.pos_hash),
                      ("prev_stones", games.pos.prev_stones),
                      ("prev_prev_stones", games.pos.prev_prev_stones),
                      ("ko_hash_hist", games.ko_hash_hist)):
        np.testing.assert_array_equal(
            C.to_np(got).astype(np.int64), ref[name].astype(np.int64),
            err_msg=name)
    sp = dataclasses.replace(SearchParams.for_selfplay(),
                             root_noise_enabled=False).to_arr("cpu")
    adj = LOOP._adjust_komi_to_even(
        games, np.asarray(meta["compensate"]), C.ref_model(size),
        mcts._feature_params(sp), size)
    np.testing.assert_array_equal(C.to_np(adj.rules.komi), ref["komi_out"])
    assert (ref["komi_out"] != ref["komi_in"]).any()


def test_start_positions_match_jax():
    ref, meta = C.load_ref("handicap")
    size = meta["size"]
    stones = np.zeros(size * size, np.int8)
    stones[[20, 21, 30, 40]] = (1, 2, 1, 2)
    samples = [TPOS.PositionSample(x_size=size, y_size=size, stones=stones,
                                   next_pla=2, moves=[(2, 22), (1, 81)],
                                   initial_turn_number=6),
               None,
               TPOS.PositionSample(x_size=size, y_size=size, stones=stones,
                                   next_pla=1, moves=[],
                                   initial_turn_number=3)]
    games = TH.new_game(size, C.RULESETS["tromp_taylor"][1],
                        meta["max_hist"], g=len(samples), device="cpu")
    games = LOOP._place_start_positions(games, samples, size)
    for name, got in (("stones", games.pos.board.stones),
                      ("to_move", games.pos.to_move),
                      ("move_num", games.pos.move_num),
                      ("pos_hash", games.pos.board.pos_hash),
                      ("recent_moves", games.pos.recent_moves),
                      ("prev_stones", games.pos.prev_stones),
                      ("ko_hash_hist", games.ko_hash_hist),
                      ("hist_len", games.hist_len)):
        np.testing.assert_array_equal(
            C.to_np(got).astype(np.int64),
            ref[f"start/{name}"].astype(np.int64), err_msg=name)


def test_play_games_with_every_game_init_option():
    """The paths the JAX fixtures cannot pin (their draws come from the
    generator): policy-init openings, cheap/full mixing, komi draws,
    handicap with komi compensation, an early fork and a start
    position, on 7x7 for 8 moves. Only full searches are recorded, the
    start position keeps its turn number, komis stay on the half-point
    grid, and the rows pack to the schema."""
    size = 7
    stones = np.zeros(size * size, np.int8)
    stones[[10, 24]] = (1, 2)
    start = TPOS.PositionSample(x_size=size, y_size=size, stones=stones,
                                next_pla=2, moves=[(2, 16)],
                                initial_turn_number=9)
    ps = TPS.PlaySettings(policy_init_avg_move_num=2.0, cheap_search_prob=0.5,
                          cheap_search_visits=2, komi_stdev=1.0)
    data, stats = LOOP.play_games(
        C.ref_model(size, seed=4), size=size, num_games=4, visits=4,
        max_moves=8, gen=torch.Generator().manual_seed(5), device="cpu",
        play_settings=ps, num_handicap=np.array([0, 3, 0, 0]),
        compensate_komi=np.array([False, True, False, False]),
        early_fork=np.array([False, False, True, False]),
        start_samples=[None, None, None, start])
    assert data.spatial.shape[0] > 0 and (data.visits == 4).all()
    assert stats["moves_per_game"][3] > 10
    assert (data.move_num[data.game_idx == 3] >= 10).all()
    komi = stats["komi_white"]
    np.testing.assert_array_equal(komi * 2, np.round(komi * 2))
    check_schema(data.to_npz_arrays(size, stats["white_minus_black"],
                                    komi_white=komi), size)


def _rows_inputs(rng, n, size):
    area = size * size
    f = rng.random
    pol = f((n, area + 1)).astype(np.float32)
    return dict(
        spatial=(f((n, size, size, 22)) < 0.3).astype(np.float32),
        global_in=f((n, 19)).astype(np.float32),
        policy_target=pol / pol.sum(1, keepdims=True),
        next_policy_target=np.where(f((n, 1)) < 0.8, pol / pol.sum(
            1, keepdims=True), 0).astype(np.float32),
        value_target=f((n, 3)).astype(np.float32),
        td_targets=f((n, 5, 4)).astype(np.float32),
        score_target=rng.normal(0, 10, n).astype(np.float32),
        lead_target=rng.normal(0, 10, n).astype(np.float32),
        ownership_target=rng.uniform(-1, 1, (n, area)).astype(np.float32),
        self_komi=rng.normal(0, 7, n).astype(np.float32),
        turn_idx=np.arange(n, dtype=np.float32),
        visits=np.full(n, 8, np.float32), size=size,
        variance_time=f(n).astype(np.float32),
        futurepos=rng.integers(-1, 2, (n, 2, area)).astype(np.float32),
        seki_diff=rng.integers(-1, 2, (n, area)).astype(np.float32),
        scoring=rng.uniform(-1, 1, (n, area)).astype(np.float32),
        q_winloss=rng.uniform(-1, 1, (n, area + 1)).astype(np.float32),
        q_score=rng.normal(0, 20, (n, area + 1)).astype(np.float32),
        q_visits=rng.integers(0, 40000, (n, area + 1)).astype(np.int32),
        game_hash=rng.integers(0, 2 ** 63, n).astype(np.uint64),
        row_weight=f(n).astype(np.float32))


def _poses_file(tmp_path):
    """Two start positions written by the port's pose writer."""
    stones = np.zeros(25, np.int8)
    stones[[6, 12]] = (1, 2)
    writer = TPOS.PosWriter("txt", str(tmp_path))
    for turn in (3, 5):
        writer.write_pos(TPOS.PositionSample(
            x_size=5, y_size=5, stones=stones, next_pla=1,
            moves=[(1, 7), (2, 25)], initial_turn_number=turn,
            weight=float(turn)))
    writer.flush_and_stop()
    return str(tmp_path / "poses.0.txt")


@pytest.mark.parametrize("name", ["pack_rows", "td_groups",
                                  "variance_time_target", "sample_komis",
                                  "policy_surprise_weights",
                                  "sample_game_specs"])
def test_numpy_functions_match_jax_package(name, tmp_path):
    rng = np.random.default_rng(5)
    if name == "pack_rows":
        for size in (5, 19):
            kw = _rows_inputs(rng, 7, size)
            got, want = TTW.pack_rows(**kw), JTW.pack_rows(**kw)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            check_schema(got, size)
    elif name == "td_groups":
        wt = rng.random((12, 4)).astype(np.float32)
        np.testing.assert_array_equal(TTW.td_groups(wt, 25),
                                      JTW.td_groups(wt, 25))
    elif name == "variance_time_target":
        wl = rng.uniform(-1, 1, 30)
        np.testing.assert_array_equal(TTW.variance_time_target(wl),
                                      JTW.variance_time_target(wl))
    elif name == "sample_komis":
        for ps_t, ps_j in ((TPS.PlaySettings.for_selfplay(),
                            JPS.PlaySettings.for_selfplay()),
                           (TPS.PlaySettings(komi_stdev=2.0,
                                             komi_big_stdev_prob=0.5),
                            JPS.PlaySettings(komi_stdev=2.0,
                                             komi_big_stdev_prob=0.5))):
            np.testing.assert_array_equal(
                TPS.sample_komis(7.5, ps_t, 64, np.random.default_rng(1)),
                JPS.sample_komis(7.5, ps_j, 64, np.random.default_rng(1)))
    elif name == "policy_surprise_weights":
        p = rng.random((9, 26)).astype(np.float32)
        q = np.where(rng.random((9, 26)) < 0.2, -1.0,
                     rng.random((9, 26))).astype(np.float32)
        w = rng.random(9).astype(np.float32)
        for dw in (0.0, 0.5):
            np.testing.assert_array_equal(
                TPS.policy_surprise_weights(p, q, w, dw),
                JPS.policy_surprise_weights(p, q, w, dw))
    else:
        kw = dict(allowed_sizes=(5, 9, 13), size_rel_probs=(1.0, 1.0, 2.0),
                  handicap_prob=0.4, handicap_compensate_komi_prob=0.5,
                  early_fork_game_prob=0.3, start_poses_prob=0.3,
                  start_poses_files=(_poses_file(tmp_path),))
        got = TGI.sample_game_specs(TGI.GameInitParams(**kw), 40,
                                    np.random.default_rng(2))
        want = JGI.sample_game_specs(JGI.GameInitParams(**kw), 40,
                                     np.random.default_rng(2))
        assert any(s.start_pos is not None for s in want)
        assert any(s.num_handicap > 0 for s in want)
        for a, b in zip(got, want):
            da, db = dataclasses.asdict(a), dataclasses.asdict(b)
            pa, pb = da.pop("start_pos"), db.pop("start_pos")
            assert da == db
            assert (pa is None) == (pb is None)
            if pa is not None:
                assert pa["initial_turn_number"] == pb["initial_turn_number"]
                np.testing.assert_array_equal(pa["stones"], pb["stones"])
        for size, bucket in TGI.group_specs_by_size(got).items():
            t_rules, *t_rest = TGI.specs_to_rules_arrays(bucket, "cpu")
            j_rules, *j_rest = JGI.specs_to_rules_arrays(
                JGI.group_specs_by_size(want)[size])
            C.assert_tree_equal(j_rules, t_rules)
            for a, b in zip(t_rest[:3], j_rest[:3]):
                np.testing.assert_array_equal(a, b)


def test_selfplay_cli_writes_shard_and_sgfs_on_cpu(tmp_path, capsys):
    out = tmp_path / "out"
    SC.main(["-device", "cpu", "-size", "5", "-config", "b1c6",
             "-games-per-batch", "2", "-visits", "2", "-max-batches", "1",
             "-output-dir", str(out)])
    totals = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert totals["games"] == 2 and totals["rows"] > 0
    files = sorted(p.relative_to(out).as_posix() for p in out.rglob("*")
                   if p.is_file())
    assert files == ["random-init/sgfs/batch000000_0.sgfs",
                     "random-init/tdata/batch000000_0_s5.npz"]
    with np.load(out / files[1]) as z:
        arrays = {k: z[k] for k in z.files}
    check_schema(arrays, 5)
    assert arrays["globalInputNC"].shape[0] == totals["rows"]
    for k, v in arrays.items():
        if v.dtype.kind == "f":
            assert np.isfinite(v).all(), k
    games = TSGF.parse_sgf((out / files[0]).read_text())
    assert len(games) == 2
    assert sum(len(gm.moves()) for gm in games) == totals["rows"]


@pytest.mark.parametrize("case", ["no_device_without_cuda", "models_dir",
                                  "mesh"])
def test_selfplay_refusals(case, tmp_path, monkeypatch):
    if case == "no_device_without_cuda":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SC.run_selfplay(str(tmp_path), None, size=5, games_per_batch=2,
                            visits=2, max_batches=1, config_name="b1c6")
    elif case == "models_dir":
        # an export of another net: refused before any game is played
        from katago_torch.models import config as TC
        from katago_torch.models import model as TM
        from katago_torch.train import checkpoint as TCK
        other = TM.KataGoModel(TC.get_config("b2c16"), 5, torch.float32)
        TCK.export_params(str(tmp_path / "models"), "b2c16-s1",
                          other.state_dict())
        with pytest.raises(ValueError, match="keys differ"):
            SC.main(["-device", "cpu", "-size", "5", "-config", "b1c6",
                     "-output-dir", str(tmp_path / "out"),
                     "-models-dir", str(tmp_path / "models")])
    else:
        # a game count that does not split over the mesh's ranks
        from katago_torch.parallel.mesh import Mesh
        mesh = Mesh(rank=0, world_size=2, device=torch.device("cpu"))
        with pytest.raises(ValueError, match="not divisible"):
            LOOP.play_games(C.ref_model(5), size=5, num_games=3, visits=2,
                            device="cpu", mesh=mesh)
    assert not any(tmp_path.rglob("*.npz"))
