"""Reference outputs of katago_tpu for the PyTorch port's CPU tests.

    JAX_PLATFORMS=cpu python tools/make_torch_fixtures.py [--only NAME ...]

Runs the JAX package on the CPU on seeded inputs and writes compressed
npz files under tests/data/torch_ref/. Every file holds the arrays the
tests compare against plus a `meta` entry: a JSON string with the seed
and the arguments that made it. The port's tests read these files
instead of compiling the JAX programs themselves (a JAX search or ladder
compile costs seconds to a minute each on the CPU).

Fixtures:
  weights_b1c6_sN  seeded Flax parameters of the b1c6 net
                (size-independent), seeds 3 and 4
  search        5x5 SearchDriver searches with ladder planes on, then one
                search that reuses the trees after each game's most
                visited move (prev_tree / prev_actions)
  chase         jax.vmap(ladder_map_chase) on the boards of
                tests/test_torch_ladder.py
  ladder_exact  ladder_map (the exact backtracking solver) on seeded
                random 9x9 and 19x19 boards, some with a ko point, with
                reduced node budget / depth / iteration caps, and on the
                board of the longest lane met on the card
  selfplay      play_games at 5x5, b1c6 fp32, 2 games, 8 visits, tree
                reuse, PlaySettings.for_testing(8), explicit rules, root
                noise off, move temperatures 0, played to the end
  resign        the same with resign_threshold -0.05 over 2 searches
  features      fill_features_v7 with its default exact ladders (the
                3-solve path) on seeded random 9x9 games
  handicap      _place_handicap, _adjust_komi_to_even and
                _place_start_positions on 9x9 batches
  npz_schema    (JSON) keys, dtypes and per-row shapes of the training
                npz at 5x5, 7x7 and 19x19
  train_losses  compute_losses of the b1c6 net (weights seed 3) on one
                seeded 5x5 batch of 16 rows (is_training True and False,
                the seki EMA in and out), the gradients of the total loss
                by every parameter, and two steps of each optimizer
                (sgd, muon, normuon, polar) from those gradients: params
                after each step and the optimizer state after the second
  train         run_training at 5x5, b1c6, batch 16, 6 SGD steps with
                SWA on seeded random shards: the initial params, every
                metrics.json line, the final params, EMA and SWA
  train_muon    the same for 3 steps of -optimizer normuon
  train_resume  3 SGD steps with an -lr-schedule, then a resume for 3
                more: both runs' metrics lines, the final state, and the
                optimizer count the checkpoint restores
  desc          load_model + apply_desc_model on the tiny text-format
                models of every version 3..17 (tests.test_torch_common.
                write_tiny_model) and on b1c6_s3.bin.gz, which it writes
                with the JAX exporter from weights_b1c6_s3
  search_extras a 5x5 run_search with ladders on, root_allowed_mask,
                root_num_symmetries=4 (the symmetry ids it drew) and
                track_moves_ownership, its extract_pv and
                child_analysis_extras; and 9x9 searches of a mirrored
                game with and without MirrorArrs
  gtp           a scripted 9x9 GTP session of the JAX engine on
                b1c6_s3.bin.gz (visit-bounded searches only), and a
                second one through gtp.main with a config file
  analysis      scripted 5x5 analysis-engine sessions on b1c6_s3.bin.gz
  model_shapes  (JSON) every preset's Flax parameter shapes (eval_shape)
  nets          a float32 forward of each tests.test_torch_common.NET_KINDS
                net (bottle1-3, attn/ffn, QK-norm GQA, nbttf with RoPE
                and with GAB, the metadata encoder, both intermediate-head
                variants) with seeded weights
  nets_train    compute_losses, gradients and one sgd and one normuon
                step of NET_TRAIN (intermediate head, nbttf-GAB, QK-norm)
  desc_tf       apply_desc_model on v17 files: the JAX exporter's attn/ffn
                (fixed RoPE) and metadata-encoder files of the nets
                weights, and write_tiny_transformer_model's (learnable
                RoPE, trunk-tip RMSNorm, spatial and not), which the JAX
                exporter cannot write
  features_versions  fill_features at versions 3-6 (chase ladders) on the
                features games
  pattern_search  a 5x5 search with and without an avoid-repeated-shapes
                table (its game's moves and moves made before from its
                root position)
  humansl       writes humansl_b1c6.bin.gz, then the JAX GTP (main with a
                humanSLProfile and avoidRepeatedPatternUtility config),
                analysis and humanslnet_server sessions on it
  vnets         GTP and analysis sessions on the tiny nets of model
                versions 3, 5, 6, 7 (input features V3-V6)
  match         play_match and a 3-bot play_round_robin at 5x5 on b1c6
                nets (tests.test_torch_common.MATCH_*, ROUND_ROBIN_*),
                match_cmd.SearchParams patched to temperature 0; the
                round robin's matches cut by a max_moves bound into
                match_cmd.play_match; holds the seed-5 weights
  gatekeeper    run_gatekeeper on JAX exports of those weights: a first
                model, then an accepted and a rejected candidate
                (GATE_CALLS) under the same patches (max_moves bound into
                gatekeeper_cmd.play_match); results and final directories
  forward       forward_cmd.main on b1c6_s3.bin.gz: the empty 9x9 board
                and TOOLS_SGF at turn 10, both -full (printed JSON)
  evalsgf       sgf_cmds evalsgf on TOOLS_SGF at EVALSGF_VISITS (text)
  play          play_cmd.main on b1c6_s3.bin.gz with input() scripted by
                PLAY_INPUTS (transcript)
  ckpt_clean    checkpoint_tools_cmd clean -bin-gz of a JAX checkpoint
                whose EMA is the seed-4 b1c6 weights: the printed JSON
                and the gunzipped .bin.gz bytes
  fused_mesh    the JAX fused step jitted with NamedShardings over a
                2-device CPU mesh (games and ring sharded, parameters
                replicated) on the `fused` arguments: the ring, the games
                after the chunk, the learner's indices from the step's
                key, its metrics and the parameters after it
  jax_ckpt      2 steps of run_training (b1c6, 5x5) with SGD and with
                normuon (Newton-Schulz in float32), saved by orbax,
                flattened by tools/jax_checkpoint_to_npz.py (its npz and
                metadata), and the JAX state and metrics after one more
                step; the shards it trained on
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "tests" / "data" / "torch_ref"
sys.path.insert(0, str(ROOT))
os.environ.setdefault("JAX_PLATFORMS", "cpu")
# fused_mesh runs the JAX step sharded over MESH_DEVICES CPU devices, every
# other maker on one (a JAX trainer would go data-parallel over more). The
# device count is fixed when JAX is imported, so fused_mesh is made in a
# process of its own (main starts one), which sets it here.
MESH_DEVICES = 2
if sys.argv[1:] == ["--only", "fused_mesh"]:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") +
        f" --xla_force_host_platform_device_count={MESH_DEVICES}")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from katago_tpu.cli import train_cmd as JTRAIN  # noqa: E402
from katago_tpu.dataio import trainingwrite as JTW  # noqa: E402
from katago_tpu.dataio.poses import PositionSample  # noqa: E402
from katago_tpu.game import history as JH  # noqa: E402
from katago_tpu.game import ladder as JL  # noqa: E402
from katago_tpu.game import rules as JR  # noqa: E402
from katago_tpu.models import config as JC  # noqa: E402
from katago_tpu.models import features as JF  # noqa: E402
from katago_tpu.models.model import KataGoModel as JModel  # noqa: E402
from katago_tpu.search.driver import SearchDriver as JDriver  # noqa: E402
from katago_tpu.search.params import SearchParams as JParams  # noqa: E402
from katago_tpu.selfplay import loop as JLOOP  # noqa: E402
from katago_tpu.selfplay.playsettings import PlaySettings  # noqa: E402
from katago_tpu.train import checkpoint as JCK  # noqa: E402
from katago_tpu.train import losses as JLOSS  # noqa: E402
from katago_tpu.train import muon as JMUON  # noqa: E402
from katago_tpu.train import schedules as JSCH  # noqa: E402
from katago_tpu.train import train_step as JSTEP  # noqa: E402
from katago_torch.ops import cases as CASES  # noqa: E402

from tests import test_torch_common as C  # noqa: E402

WEIGHT_SEED = 3
# the selfplay games end (two passes) within the default 60 moves
SELFPLAY_WEIGHT_SEED = 4
SEARCH_SIZE = 5
SEARCH_VISITS = 24
# both roots hold laddered stones, and so do the boards before them
SEARCH_MOVES = [[20, 6, 2, 8, 11], [20, 2, 5, 7, 4]]
RESULT_FIELDS = ("root_visits", "child_visits", "root_policy_prior",
                 "root_winloss", "root_score_mean", "root_lead",
                 "root_utility", "root_score_stdev", "child_winloss",
                 "child_score_mean", "root_ownership")
LADDER_FIELDS = ("laddered", "working_vs_black", "working_vs_white")


def save(name: str, arrays: dict, meta: dict) -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    arrays = dict(arrays, meta=np.array(json.dumps(meta, sort_keys=True)))
    np.savez_compressed(OUT / f"{name}.npz", **arrays)
    kb = (OUT / f"{name}.npz").stat().st_size / 1024
    print(f"wrote {name}.npz ({kb:.1f} KiB)", flush=True)


def jax_model(size: int):
    return JModel(JC.get_config("b1c6"), pos_len=size, dtype=jnp.float32)


def jax_params(seed: int = WEIGHT_SEED):
    return C.flax_params(jax_model(SEARCH_SIZE), SEARCH_SIZE, seed)


def flat_params(params) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    return {"w/" + "/".join(k.key for k in path): np.asarray(v)
            for path, v in leaves}


def make_weights():
    for seed in (WEIGHT_SEED, SELFPLAY_WEIGHT_SEED):
        save(f"weights_b1c6_s{seed}", flat_params(jax_params(seed)),
             {"config": "b1c6", "seed": seed,
              "made_by": "tests.test_torch_common.flax_params"})


def _search_params(**kw):
    return dataclasses.replace(JParams.for_selfplay(),
                               root_noise_enabled=False, **kw).to_arr()


def _jax_roots(size, moves_per_game, max_hist=64):
    g = len(moves_per_game)
    rules = JH.RulesArr.from_rules(JR.Rules.tromp_taylorish())
    gs = C.jax_batch(JH.new_game(size, rules, max_hist), g)
    step = jax.jit(jax.vmap(lambda s, m: JH.step(s, m, size)[0]))
    for k in range(len(moves_per_game[0])):
        gs = step(gs, jnp.asarray([m[k] for m in moves_per_game], jnp.int32))
    return gs, step


def _result_arrays(res, prefix):
    out = {f"{prefix}{n}": np.asarray(getattr(res, n)) for n in RESULT_FIELDS}
    tree = res.ss.tree
    out[f"{prefix}num_nodes"] = np.asarray(tree.num_nodes)
    out[f"{prefix}laddered"] = np.asarray(tree.laddered)
    out[f"{prefix}root_prev_laddered"] = np.asarray(res.ss.root_prev_laddered)
    return out


def make_search():
    size, visits = SEARCH_SIZE, SEARCH_VISITS
    params = jax_params()
    jm = jax_model(size)
    roots, step = _jax_roots(size, SEARCH_MOVES)
    drv = JDriver(jm.apply, params, _search_params(), size=size,
                  max_nodes=visits + 3, chunk_size=visits // 2,
                  with_ladders=True)
    res = drv.search(roots, jax.random.PRNGKey(0), max_visits=visits + 1)
    actions = np.asarray(res.child_visits).argmax(1).astype(np.int32)
    roots2 = step(roots, jnp.asarray(actions))
    res2 = drv.search(roots2, jax.random.PRNGKey(1), max_visits=visits + 1,
                      prev_tree=res.ss.tree,
                      prev_actions=jnp.asarray(actions))
    arrays = {**_result_arrays(res, "s1/"), **_result_arrays(res2, "s2/"),
              "actions": actions}
    save("search", arrays, {
        "size": size, "visits": visits, "max_nodes": visits + 3,
        "chunk_size": visits // 2, "moves": SEARCH_MOVES,
        "weights": f"weights_b1c6_s{WEIGHT_SEED}",
        "params": "for_selfplay, root noise off",
        "rules": "tromp_taylor", "max_hist": 64, "with_ladders": True,
        "reuse": "actions = argmax of s1 child_visits, then a search with "
                 "prev_tree=s1 trees, prev_actions=actions"})


def _chase(stones, ko, size):
    ref = jax.vmap(lambda s, k: JL.ladder_map_chase(s, size, ko_loc=k))(
        jnp.asarray(stones), jnp.asarray(ko))
    return {n: np.asarray(getattr(ref, n)) for n in LADDER_FIELDS}


def make_chase():
    """The boards of tests/test_torch_ladder.py."""
    arrays = {}

    def add(name, stones, ko, size):
        stones = np.asarray(stones, np.int32)
        ko = np.asarray(ko, np.int32)
        arrays[f"{name}/stones"] = stones
        arrays[f"{name}/ko"] = ko
        for k, v in _chase(stones, ko, size).items():
            arrays[f"{name}/{k}"] = v

    size = 9
    boards = C.random_boards(size, 12, 0)
    atari = np.zeros((size, size), np.int32)
    atari[1, 1] = 2
    atari[0, 1] = 1
    atari[1, 0] = 1
    atari[1, 2] = 1          # atari: lone liberty at (2,1)
    ko_board = C.random_boards(size, 1, 5)[0]
    stones = np.concatenate([boards, atari.reshape(1, -1), ko_board[None]])
    ko = np.full((stones.shape[0],), -1, np.int32)
    ko[-1] = 4               # a ko point set: exercises the lane masking
    add("random9", stones, ko, size)
    add("random19", C.random_boards(19, 2, 1), np.full((2,), -1), 19)
    steps9 = 4 * 9 + 14
    st, k, _ = CASES.chase_cases(9, 14, 6, steps9)["dense"]
    add("dense9", C.to_np(st), C.to_np(k), 9)
    steps19 = 4 * 19 + 14
    st, k, _ = CASES.chase_cases(19, 1, 0, steps19)["ladder"]
    add("ladder19", C.to_np(st), C.to_np(k), 19)
    save("chase", arrays, {
        "random9": "tests.test_torch_common.random_boards(9, 12, 0) + an "
                   "atari board + random_boards(9, 1, 5) with ko point 4",
        "random19": "random_boards(19, 2, 1)",
        "dense9": "katago_torch.ops.cases.chase_cases(9, 14, 6, 50)"
                  "['dense']",
        "ladder19": "chase_cases(19, 1, 0, 90)['ladder']",
        "solver": "jax.vmap(katago_tpu.game.ladder.ladder_map_chase)"})


# (name, size, boards, seed, density_lo, density_hi, ladder_map kwargs)
EXACT_SETS = [
    ("random9", 9, 16, 11, 0.15, 0.6, {}),
    ("dense9", 9, 8, 12, 0.55, 0.8, {}),
    ("random19", 19, 4, 13, 0.15, 0.6, {}),
    ("caps9", 9, 8, 14, 0.3, 0.7,
     {"budget": 6, "max_depth": 6, "max_iters": 40, "max_chains": 5}),
    ("iters9", 9, 8, 15, 0.3, 0.7, {"max_iters": 9}),
]


# The board of the longest exact-solver lane (1918 iterations: white's
# two-liberty edge stone at 189, black's first move at 188) that
# chip_smoke.py's selfplay phase met on an H100; its nine stones as
# (point, color).
LONGTAIL19 = [(19, 2), (132, 1), (151, 2), (170, 1), (182, 1), (189, 2),
              (196, 1), (219, 1), (240, 2)]


def make_ladder_exact():
    arrays = {}
    meta = {"solver": "katago_tpu.game.ladder.ladder_map", "sets": {}}
    for name, size, n, seed, lo, hi, kw in EXACT_SETS:
        stones = C.random_boards(size, n, seed, lo, hi)
        rng = np.random.default_rng(seed + 1000)
        # a ko point on every other board: an empty point (legal or not,
        # the solver only masks premoves with it)
        ko = np.full((n,), -1, np.int32)
        for i in range(0, n, 2):
            empty = np.flatnonzero(stones[i] == 0)
            ko[i] = rng.choice(empty)
        t0 = time.time()
        fn = jax.jit(jax.vmap(
            lambda s, k: JL.ladder_map(s, size, ko_loc=k, **kw)))
        ref = fn(jnp.asarray(stones), jnp.asarray(ko))
        arrays[f"{name}/stones"] = stones
        arrays[f"{name}/ko"] = ko
        for f in LADDER_FIELDS:
            arrays[f"{name}/{f}"] = np.asarray(getattr(ref, f))
        meta["sets"][name] = {
            "size": size, "boards": n, "seed": seed,
            "density": [lo, hi], "ko_seed": seed + 1000,
            "ladder_map_kwargs": kw,
            "boards_by": "tests.test_torch_common.random_boards"}
        print(f"  ladder_exact {name}: {time.time() - t0:.1f} s, "
              f"{int(np.asarray(ref.laddered).sum())} laddered points",
              flush=True)
    stones = np.zeros((1, 361), np.int32)
    for point, color in LONGTAIL19:
        stones[0, point] = color
    ko = np.full((1,), -1, np.int32)
    ref = jax.jit(jax.vmap(lambda s, k: JL.ladder_map(s, 19, ko_loc=k)))(
        jnp.asarray(stones), jnp.asarray(ko))
    arrays["longtail19/stones"] = stones
    arrays["longtail19/ko"] = ko
    for f in LADDER_FIELDS:
        arrays[f"longtail19/{f}"] = np.asarray(getattr(ref, f))
    meta["sets"]["longtail19"] = {
        "size": 19, "boards": 1, "stones": LONGTAIL19, "ko": -1,
        "ladder_map_kwargs": {},
        "boards_by": "the longest exact-solver lane of chip_smoke.py's "
                    "selfplay phase on an H100"}
    save("ladder_exact", arrays, meta)


SELFPLAY = dict(size=5, num_games=2, visits=8, seed=7,
                komi=[7.5, 6.0], max_moves=None)


def selfplay_params():
    return _search_params(chosen_move_temperature=0.0,
                          chosen_move_temperature_early=0.0)


def _play(name: str, **extra):
    """play_games on the SELFPLAY setup (plus `extra` arguments): rows,
    stats and npz arrays."""
    s = SELFPLAY
    size, g = s["size"], s["num_games"]
    params = jax_params(SELFPLAY_WEIGHT_SEED)
    rules = JH.RulesArr.from_rules(JR.Rules.tromp_taylorish())
    game_rules = jax.tree.map(
        lambda x: jnp.broadcast_to(x, (g,) + x.shape).copy(), rules)
    game_rules = game_rules._replace(komi=jnp.asarray(s["komi"], jnp.float32))
    sp = dataclasses.replace(JParams.for_selfplay(), root_noise_enabled=False,
                             chosen_move_temperature=0.0,
                             chosen_move_temperature_early=0.0)
    t0 = time.time()
    data, stats = JLOOP.play_games(
        jax_model(size).apply, params, size=size, num_games=g,
        visits=s["visits"], search_params=sp,
        rng=jax.random.PRNGKey(s["seed"]), tree_reuse=True,
        play_settings=PlaySettings.for_testing(s["visits"]),
        game_rules=game_rules, **extra)
    print(f"  play_games: {time.time() - t0:.1f} s", flush=True)
    arrays = {f"data/{f.name}": getattr(data, f.name)
              for f in dataclasses.fields(data)}
    for k, v in stats.items():
        arrays[f"stats/{k}"] = np.asarray(v)
    packed = data.to_npz_arrays(size, stats["white_minus_black"],
                                komi_white=stats["komi_white"])
    for k, v in packed.items():
        arrays[f"npz/{k}"] = v
    save(name, arrays, {
        **s, **extra, "weights": f"weights_b1c6_s{SELFPLAY_WEIGHT_SEED}",
        "rules": "tromp_taylor, per-game "
        "komi", "search_params": "for_selfplay, root noise off, "
        "chosen_move_temperature(_early) 0", "tree_reuse": True,
        "play_settings": "PlaySettings.for_testing(visits)",
        "rng": "jax.random.PRNGKey(seed)", "ladder_mode": "chase",
        "all_finished": bool(stats["all_finished"])})


def make_selfplay():
    _play("selfplay")


def make_resign():
    """Game 0 resigns at move 14 (two full searches below -0.05)."""
    _play("resign", resign_threshold=-0.05, resign_consec_turns=2)


# (rules, games, moves, seed, pass_prob) of tests.test_torch_common's
# random_games_torch
FEATURE_GAMES = [("tromp_taylor", 3, 40, 31, 0.03),
                 ("japanese", 3, 30, 32, 0.2)]


def make_features():
    size = 9
    t_gs = None
    for rules, g, n, seed, pp in FEATURE_GAMES:
        t = C.random_games_torch(size, g, n, rules, seed, pass_prob=pp)
        t_gs = t if t_gs is None else C.tree_cat(t_gs, t)
    j_gs = C.jax_games_like(t_gs, size)
    params = JF.FeatureParams(jnp.float32(0.5), jnp.float32(0.25),
                              jnp.bool_(False))
    sp, gl = jax.jit(jax.vmap(
        lambda gs_: JF.fill_features_v7(gs_, size, params)))(j_gs)
    save("features", {"spatial": np.asarray(sp), "global": np.asarray(gl)},
         {"size": size, "games": FEATURE_GAMES,
          "games_by": "tests.test_torch_common.random_games_torch, "
                      "concatenated in order",
          "feature_params": [0.5, 0.25, False],
          "call": "jax.vmap(fill_features_v7(gs, size, params)): legal "
                  "moves computed inside, ladder_mode exact, no cached "
                  "masks"})


HANDICAP = dict(size=9, num_handicap=[0, 2, 3, 5, 9, 4], seed=21,
                compensate=[True, True, False, True, False, True])


def make_handicap():
    s = HANDICAP
    size = s["size"]
    g = len(s["num_handicap"])
    params = jax_params()
    rules = JH.RulesArr.from_rules(JR.Rules.tromp_taylorish())
    games = C.jax_batch(JH.new_game(size, rules, 32), g)
    rng = np.random.default_rng(s["seed"])
    komi = np.round(rng.normal(7.0, 3.0, g) * 2) / 2
    games = games._replace(rules=games.rules._replace(
        komi=jnp.asarray(komi, jnp.float32)))
    games = JLOOP._place_handicap(games, np.asarray(s["num_handicap"]), size)
    sp = _search_params()
    feat_params = JF.FeatureParams(
        draw_equiv_wins_for_white=sp.draw_equivalent_wins_for_white,
        playout_doubling_advantage=sp.playout_doubling_advantage,
        conservative_pass=sp.conservative_pass)
    feat_fn = jax.jit(jax.vmap(JF.fill_features_v7, in_axes=(0, None, None)),
                      static_argnums=1)
    adj = JLOOP._adjust_komi_to_even(
        games, np.asarray(s["compensate"]), jax_model(size).apply, params,
        feat_fn, feat_params, size)
    # start positions: games 0 and 2 start from pose samples (stones,
    # context moves incl. a pass, the sample's turn number); game 1 not
    stones = np.zeros(size * size, np.int8)
    stones[[20, 21, 30, 40]] = (1, 2, 1, 2)
    samples = [PositionSample(x_size=size, y_size=size, stones=stones,
                              next_pla=2, moves=[(2, 22), (1, 81)],
                              initial_turn_number=6),
               None,
               PositionSample(x_size=size, y_size=size, stones=stones,
                              next_pla=1, moves=[], initial_turn_number=3)]
    starts = C.jax_batch(JH.new_game(size, rules, 32), len(samples))
    starts = JLOOP._place_start_positions(starts, samples, size)
    start_arrays = {f"start/{k}": np.asarray(v) for k, v in (
        ("stones", starts.pos.board.stones),
        ("to_move", starts.pos.to_move), ("move_num", starts.pos.move_num),
        ("pos_hash", starts.pos.board.pos_hash),
        ("recent_moves", starts.pos.recent_moves),
        ("prev_stones", starts.pos.prev_stones),
        ("ko_hash_hist", starts.ko_hash_hist),
        ("hist_len", starts.hist_len))}
    save("handicap", {**start_arrays,
        "komi_in": komi.astype(np.float32),
        "stones": np.asarray(games.pos.board.stones),
        "to_move": np.asarray(games.pos.to_move),
        "pos_hash": np.asarray(games.pos.board.pos_hash),
        "prev_stones": np.asarray(games.pos.prev_stones),
        "prev_prev_stones": np.asarray(games.pos.prev_prev_stones),
        "ko_hash_hist": np.asarray(games.ko_hash_hist),
        "komi_out": np.asarray(adj.rules.komi)}, {
        **s, "weights": f"weights_b1c6_s{WEIGHT_SEED}",
        "rules": "tromp_taylor",
        "max_hist": 32, "komi_in": "round(N(7, 3) * 2) / 2 from "
        "numpy default_rng(seed)", "feature_params": "for_selfplay",
        "start_samples": "black 20, 30 and white 21, 40; game 0: white "
        "to move, context moves white 22 then black pass, turn 6; game 1: "
        "none; game 2: black to move, no moves, turn 3"})


def make_schema():
    schema = {}
    for size in (5, 7, 19):
        area = size * size
        z = np.zeros
        arrays = JTW.pack_rows(
            spatial=z((1, size, size, 22), np.float32),
            global_in=z((1, 19), np.float32),
            policy_target=z((1, area + 1), np.float32),
            next_policy_target=z((1, area + 1), np.float32),
            value_target=z((1, 3), np.float32),
            td_targets=z((1, 5, 4), np.float32),
            score_target=z((1,), np.float32), lead_target=z((1,), np.float32),
            ownership_target=z((1, area), np.float32),
            self_komi=z((1,), np.float32), turn_idx=z((1,), np.float32),
            visits=z((1,), np.float32), size=size,
            variance_time=z((1,), np.float32),
            futurepos=z((1, 2, area), np.float32),
            seki_diff=z((1, area), np.float32),
            scoring=z((1, area), np.float32),
            q_winloss=z((1, area + 1), np.float32),
            q_score=z((1, area + 1), np.float32),
            q_visits=z((1, area + 1), np.int32),
            game_hash=z((1,), np.uint64), row_weight=z((1,), np.float32))
        schema[str(size)] = {k: [str(v.dtype), list(v.shape[1:])]
                             for k, v in sorted(arrays.items())}
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "npz_schema.json").write_text(json.dumps(
        {"made_by": "katago_tpu.dataio.trainingwrite.pack_rows, one row",
         "per_row": schema}, indent=1, sort_keys=True) + "\n")
    print("wrote npz_schema.json", flush=True)


# ---- trainer ----

TRAIN_SIZE = 5
TRAIN_BATCH = 16
LOSS_ROWS_SEED = 7          # tests.test_torch_common.random_rows seed
SEKI_IN = (0.3, 2.0)        # the seki EMA (sum, weight) passed in
OPT_LR = 0.01
OPT_SCHEDULE = "(0,1.0),(16,0.5)"   # the second step runs at half the lr
OPT_GRAD_SCALES = (1.0, 0.5)        # step k uses the gradients times this
OPT_KINDS = ("sgd", "muon", "normuon", "polar")
TRAIN_SHARDS = [40, 30, 25]         # rows per shard
TRAIN_DATA_SEED = 1                 # tests.test_torch_common.write_shards
TRAIN_RUN = {"size": TRAIN_SIZE, "config_name": "b1c6",
             "batch_size": TRAIN_BATCH, "lr": 0.01, "seed": 0}
RESUME_SCHEDULE = "(0,1.0),(56,0.5),(100,0.25)"
NS_SHAPES = [(864, 96), (96, 96), (198, 6), (12, 8)]   # seeded matrices


class ns_float32:
    """Inside, the JAX package's Muon orthogonalizes in float32 instead
    of bfloat16 (its module's jnp.bfloat16 reads float32), as the port
    does with muon.NS_DTYPE = float32: the rest of the update can then be
    compared at float32 precision."""

    def __enter__(self):
        import types
        proxy = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                         if not k.startswith("__")})
        proxy.bfloat16 = jnp.float32
        self.saved, JMUON.jnp = JMUON.jnp, proxy

    def __exit__(self, *exc):
        JMUON.jnp = self.saved
        return False


def flat(tree, prefix: str) -> dict:
    """A pytree's array leaves as {prefix/path: numpy array}."""
    out = {}
    for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        names = [str(getattr(k, "key", getattr(k, "name",
                                               getattr(k, "idx", k))))
                 for k in path]
        out["/".join([prefix] + names)] = np.asarray(v)
    return out


def train_batch():
    return JTW.decode_rows(C.random_rows(TRAIN_SIZE, TRAIN_BATCH,
                                         LOSS_ROWS_SEED), TRAIN_SIZE)


def _opt_state_arrays(kind: str, st) -> dict:
    """The optimizer state of make_optimizer(kind) as flat arrays: the
    SGD trace, or Muon's momentum / normuon_v and Adam's mu / nu, plus
    the counts."""
    if kind == "sgd":
        trace, sched = st[2]
        return {**flat(trace.trace, "trace"),
                "count": np.asarray(sched.count)}
    inner = st[1].inner_states
    muon_state, _, muon_sched = inner["muon"].inner_state
    adam_state, _, adam_sched = inner["adam"].inner_state
    return {**flat(muon_state.momentum, "momentum"),
            **flat(muon_state.normuon_v, "normuon_v"),
            **flat(adam_state.mu, "mu"), **flat(adam_state.nu, "nu"),
            "count": np.asarray(muon_sched.count),
            "adam_count": np.asarray(adam_state.count),
            "adam_sched_count": np.asarray(adam_sched.count)}


def make_train_losses():
    model = jax_model(TRAIN_SIZE)
    params = jax_params(WEIGHT_SEED)
    batch = {k: jnp.asarray(v) for k, v in train_batch().items()}
    seki_in = JLOSS.SekiEma(sum=jnp.float32(SEKI_IN[0]),
                            weight=jnp.float32(SEKI_IN[1]))

    def loss(p, is_training):
        raw = model.apply(p, batch["binaryInputNCHW"].transpose(0, 2, 3, 1),
                          batch["globalInputNC"])
        return JLOSS.compute_losses(raw, batch, seki_ema=seki_in,
                                    is_training=is_training)

    arrays = {}
    for train in (True, False):
        _, metrics, ema = jax.jit(lambda p: loss(p, train))(params)
        tag = "train" if train else "eval"
        arrays.update({f"m_{tag}/{k}": np.asarray(v)
                       for k, v in metrics.items()})
        arrays[f"seki_{tag}"] = np.asarray([ema.sum, ema.weight])
    grads = jax.jit(jax.grad(lambda p: loss(p, True)[0]))(params)
    arrays.update(flat(grads["params"], "grad"))
    import contextlib

    import optax
    runs = [(k, k, contextlib.nullcontext) for k in OPT_KINDS] + \
        [(k, f"{k}_f32", ns_float32) for k in OPT_KINDS if k != "sgd"]
    for kind, tag, ctx in runs:
        sched = JSCH.make_lr_schedule(OPT_LR, TRAIN_BATCH,
                                      lr_schedule_str=OPT_SCHEDULE)
        opt = JSTEP.make_optimizer(lr=sched, kind=kind)
        st = opt.init(params)
        p = params
        with ctx():
            for i, scale in enumerate(OPT_GRAD_SCALES):
                g = jax.tree.map(lambda x: x * scale, grads)
                upd, st = jax.jit(opt.update)(g, st, p)
                p = optax.apply_updates(p, upd)
                arrays.update(flat(p["params"], f"{tag}/p{i}"))
        arrays.update({f"{tag}/state/{k}": v
                       for k, v in _opt_state_arrays(kind, st).items()})
    rng = np.random.default_rng(LOSS_ROWS_SEED)
    for shape in NS_SHAPES:
        g = rng.standard_normal(shape).astype(np.float32)
        name = f"{shape[0]}x{shape[1]}"
        arrays[f"ns_in/{name}"] = g
        arrays[f"ns5/{name}"] = np.asarray(
            JMUON.zeropower_newtonschulz5(jnp.asarray(g)))
        arrays[f"polar/{name}"] = np.asarray(
            JMUON.zeropower_polar_express(jnp.asarray(g)))
    save("train_losses", arrays, {
        "config": "b1c6", "weights": f"weights_b1c6_s{WEIGHT_SEED}",
        "size": TRAIN_SIZE, "batch": TRAIN_BATCH,
        "rows": f"tests.test_torch_common.random_rows(size, batch, "
                f"{LOSS_ROWS_SEED}) through decode_rows",
        "seki_in": SEKI_IN, "lr": OPT_LR, "lr_schedule": OPT_SCHEDULE,
        "grad_scales": OPT_GRAD_SCALES, "kinds": OPT_KINDS,
        "f32": "KIND_f32/*: the Muon kinds with Newton-Schulz in float32 "
               "(ns_float32)",
        "ns_shapes": NS_SHAPES,
        "ns_in": f"standard normal, numpy default_rng({LOSS_ROWS_SEED}), "
                 f"in order"})


def _jax_run(data_dir: str, ckpt_dir: str, steps: int, **kw):
    """JAX run_training; returns (metrics lines, checkpoint metadata,
    restored TrainState, the initial params)."""
    model = JModel(JC.get_config("b1c6"), pos_len=TRAIN_SIZE,
                   dtype=jnp.float32)
    init = model.init(jax.random.PRNGKey(TRAIN_RUN["seed"]),
                      jnp.zeros((1, TRAIN_SIZE, TRAIN_SIZE, 22)),
                      jnp.zeros((1, 19)))
    JTRAIN.run_training(data_dir, ckpt_dir, None, steps=steps, **TRAIN_RUN,
                        **kw)
    with open(os.path.join(ckpt_dir, "metrics.json")) as f:
        lines = [json.loads(x) for x in f]
    latest = JCK.latest_checkpoint(ckpt_dir)
    sched = JSCH.make_lr_schedule(TRAIN_RUN["lr"], TRAIN_BATCH)
    template = JSTEP.init_train_state(init, JSTEP.make_optimizer(
        lr=sched, kind=kw.get("optimizer_kind", "sgd")))
    state = JCK.restore_checkpoint(latest, template)
    return lines, JCK.load_metadata(latest), state, init


def _state_arrays(state) -> dict:
    return {**flat(state.params["params"], "params"),
            **flat(state.ema_params["params"], "ema"),
            **flat(state.swa_params["params"], "swa"),
            "seki": np.asarray([state.seki_ema.sum, state.seki_ema.weight])}


def _make_run(name: str, steps: int, ns_dtype: str = "bfloat16", **kw):
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        C.write_shards(data, TRAIN_SIZE, TRAIN_SHARDS, TRAIN_DATA_SEED)
        lines, meta, state, init = _jax_run(data, os.path.join(tmp, "ckpt"),
                                            steps, **kw)
    serve = {k: [os.path.basename(f) for f in v] for k, v in
             meta["data_serve_state"].items() if k != "old_train_data_dirs"}
    save(name, {**flat(init["params"], "init"), **_state_arrays(state)}, {
        "run_training": dict(TRAIN_RUN, steps=steps, **kw),
        "shards": TRAIN_SHARDS, "data_seed": TRAIN_DATA_SEED,
        "metrics": lines, "serve_state": serve, "ns_dtype": ns_dtype,
        "swa_sample_accum": meta["swa_sample_accum"],
        "global_step": meta["global_step"],
        "init": "flax model.init(PRNGKey(seed)), as the JAX run_training"})


def make_train():
    _make_run("train", 6, swa_period_samples=32, swa_scale=4.0)


def make_train_muon():
    """Newton-Schulz in float32 (ns_float32): bfloat16 rounding differs
    between XLA and PyTorch and the iteration amplifies it."""
    with ns_float32():
        _make_run("train_muon", 3, optimizer_kind="normuon",
                  ns_dtype="float32")


def make_train_resume():
    """3 SGD steps under RESUME_SCHEDULE, then a resume for 3 more. The
    resumed run's schedule adds start_samples (3 steps x batch) to
    count x batch, and the count it reads is the restored optimizer
    count (3 at the first resumed step): samples 96, 112, 128 where 48,
    64, 80 were trained."""
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        ckpt = os.path.join(tmp, "ckpt")
        C.write_shards(data, TRAIN_SIZE, TRAIN_SHARDS, TRAIN_DATA_SEED)
        lines1, meta1, state1, init = _jax_run(
            data, ckpt, 3, lr_schedule=RESUME_SCHEDULE)
        count = int(np.asarray(state1.opt_state[2][1].count))
        lines2, meta2, state2, _ = _jax_run(
            data, ckpt, 3, lr_schedule=RESUME_SCHEDULE)
    sched = JSCH.make_lr_schedule(
        TRAIN_RUN["lr"], TRAIN_BATCH, lr_schedule_str=RESUME_SCHEDULE,
        start_samples=meta1["global_step"] * TRAIN_BATCH)
    lrs = [float(sched(count + i)) for i in range(3)]
    save("train_resume", {**flat(init["params"], "init"),
                          **_state_arrays(state2)}, {
        "run_training": dict(TRAIN_RUN, steps=3,
                             lr_schedule=RESUME_SCHEDULE),
        "shards": TRAIN_SHARDS, "data_seed": TRAIN_DATA_SEED,
        "metrics_first": lines1, "metrics_resumed": lines2,
        "restored_count": count, "resumed_lrs": lrs,
        "global_step": meta2["global_step"]})


BIN_B1C6 = OUT / f"b1c6_s{WEIGHT_SEED}.bin.gz"
DESC_SIZE, DESC_BATCH = 7, 3


def make_desc():
    from katago_tpu.models import desc as JD
    from katago_tpu.models import export as JEXP
    arrays = {}
    with tempfile.TemporaryDirectory() as tmp:
        for v in range(3, 18):
            path = f"{tmp}/v{v}.txt.gz"
            C.write_tiny_model(path, v, seed=v)
            desc = JD.load_model(path)
            sp, gl, mask = C.desc_inputs(v, DESC_SIZE, DESC_BATCH, seed=v)
            out = JD.apply_desc_model(desc, sp, gl, mask=mask)
            for k, val in out.items():
                if k != "supports_shortterm_error":
                    arrays[f"v{v}/{k}"] = np.asarray(val)
            arrays[f"v{v}/sha256"] = np.array(desc.sha256)
    JEXP.export_model(jax_params(), JC.get_config("b1c6"), str(BIN_B1C6),
                      name="b1c6-s3")
    desc = JD.load_model(str(BIN_B1C6))
    sp, gl, _ = C.desc_inputs(15, 9, DESC_BATCH, seed=100)
    for k, val in JD.apply_desc_model(desc, sp, gl).items():
        arrays[f"bin/{k}"] = np.asarray(val)
    arrays["bin/sha256"] = np.array(desc.sha256)
    save("desc", arrays, {
        "versions": list(range(3, 18)), "size": DESC_SIZE,
        "batch": DESC_BATCH, "inputs": "tests.test_torch_common.desc_inputs"
        "(version, size, batch, seed=version); the bin file's: (15, 9, "
        "batch, seed=100), no mask",
        "models": "write_tiny_model(path, version, seed=version)",
        "bin": BIN_B1C6.name, "bin_weights": f"weights_b1c6_s{WEIGHT_SEED}"})


EXTRAS_SYMS = 4
MIRROR_SIZE, MIRROR_VISITS = 9, 32


def make_search_extras():
    from katago_tpu.models import desc as JD
    from katago_tpu.search import mcts as JM
    from katago_tpu.search import mirror as JMIR
    size, visits = SEARCH_SIZE, SEARCH_VISITS
    params = jax_params()
    jm = jax_model(size)
    roots, _ = _jax_roots(size, SEARCH_MOVES)
    sp = _search_params()
    mask = C.extras_mask(size)
    key = jax.random.PRNGKey(5)
    # the symmetry ids init_search draws (run_search splits its key in 3,
    # init_search splits its share once more)
    r_init = jax.random.split(key, 3)[1]
    syms = np.asarray(jax.random.randint(jax.random.split(r_init)[1],
                                         (EXTRAS_SYMS, 2), 0, 8))
    res = jax.jit(lambda r, k, m: JM.run_search(
        jm.apply, params, r, sp, k, size=size, num_sims=visits,
        max_nodes=visits + 3, max_visits=visits + 1, with_ladders=True,
        root_allowed_mask=m, root_num_symmetries=EXTRAS_SYMS,
        track_moves_ownership=True))(roots, key, jnp.asarray(mask))
    arrays = _result_arrays(res, "x/")
    for n in ("moves_ownership", "moves_ownership_stdev",
              "moves_own_weight"):
        arrays[f"x/{n}"] = np.asarray(getattr(res, n))
    pv, pv_len = jax.vmap(lambda t: JM.extract_pv(t, 15))(res.ss.tree)
    cv = np.asarray(res.child_visits)
    top = cv.argmax(1)
    starts = np.asarray(res.ss.tree.children)[np.arange(2), 0, top]
    cpv, cpv_len = jax.vmap(lambda t, st: JM.extract_pv(t, 14, start=st))(
        res.ss.tree, jnp.asarray(starts, jnp.int32))
    arrays.update({"x/pv": np.asarray(pv), "x/pv_len": np.asarray(pv_len),
                   "x/child_pv": np.asarray(cpv),
                   "x/child_pv_len": np.asarray(cpv_len), "syms": syms,
                   "mask": mask})
    for k, v in JM.child_analysis_extras(res, sp).items():
        arrays[f"x/extras/{k}"] = np.asarray(v)

    # a mirrored 9x9 game (tests/test_mirror.py's history): the desc net
    desc = JD.load_model(str(BIN_B1C6))
    apply = JD.make_desc_apply(desc)
    moves, plas = C.mirror_history(MIRROR_SIZE, 15)
    gs = C.jax_batch(JH.new_game(MIRROR_SIZE, JH.RulesArr.from_rules(
        JR.Rules.tromp_taylorish()), 128), 1)
    step = jax.jit(jax.vmap(lambda s, m: JH.step(s, m, MIRROR_SIZE)[0]))
    for mv in moves:
        gs = step(gs, jnp.asarray([mv], jnp.int32))
    stones = np.asarray(gs.pos.board.stones[0])
    mirroring, adv, err = JMIR.detect_game(
        moves, plas, root_pla=1, stones=stones, komi=7.5,
        scoring_area=True, size=MIRROR_SIZE)
    assert mirroring
    marr = JMIR.MirrorArrs(
        mirroring=jnp.asarray([True]), mirror_pla=jnp.asarray([2], jnp.int32),
        advantage=jnp.asarray([adv], jnp.float32),
        center_err=jnp.asarray([err], jnp.float32))
    gsp = JParams(root_noise_enabled=False).to_arr()
    for name, mir in (("m_on", marr), ("m_off", None)):
        r = jax.jit(lambda r_, k: JM.run_search(
            apply, None, r_, gsp, k, size=MIRROR_SIZE,
            num_sims=MIRROR_VISITS, max_nodes=MIRROR_VISITS + 3,
            max_visits=MIRROR_VISITS + 1, with_ladders=False, mirror=mir))(
                gs, jax.random.PRNGKey(1))
        arrays.update(_result_arrays(r, f"{name}/"))
    save("search_extras", arrays, {
        "size": size, "visits": visits, "max_nodes": visits + 3,
        "max_visits": visits + 1, "moves": SEARCH_MOVES,
        "weights": f"weights_b1c6_s{WEIGHT_SEED}",
        "params": "for_selfplay, root noise off", "with_ladders": True,
        "root_num_symmetries": EXTRAS_SYMS, "key": 5,
        "mask": "extras_mask(size)", "mirror": {
            "size": MIRROR_SIZE, "visits": MIRROR_VISITS,
            "max_visits": MIRROR_VISITS + 1, "model": BIN_B1C6.name,
            "params": "SearchParams(root_noise_enabled=False)",
            "with_ladders": False, "history": "mirror_history(9, 15)",
            "detect": [bool(mirroring), float(adv), float(err)]}})


def _gtp_transcript(script: str, main_args=None) -> str:
    import io
    from katago_tpu.cli import gtp as JGTP
    out = io.StringIO()
    if main_args is None:
        eng = JGTP.GTPEngine(model_path=str(BIN_B1C6), size=9,
                             visits=C.GTP_VISITS)
        JGTP.run_gtp(eng, io.StringIO(script), out)
    else:
        # main() runs run_gtp(engine) on the process's stdin and stdout
        run = JGTP.run_gtp
        JGTP.run_gtp = lambda eng: run(eng, io.StringIO(script), out)
        try:
            JGTP.main(main_args)
        finally:
            JGTP.run_gtp = run
    return out.getvalue()


def make_gtp():
    t0 = time.time()
    main_out = ""
    with tempfile.TemporaryDirectory() as tmp:
        cfg = Path(tmp) / "gtp.cfg"
        cfg.write_text(C.GTP_CONFIG)
        main_out = _gtp_transcript(
            C.GTP_MAIN_SCRIPT, ["-model", str(BIN_B1C6), "-config",
                                str(cfg), "-boardsize", "9"])
    print(f"  main session: {time.time() - t0:.1f} s", flush=True)
    out = _gtp_transcript(C.GTP_SCRIPT)
    save("gtp", {"transcript": np.array(out),
                 "main_transcript": np.array(main_out)}, {
        "model": BIN_B1C6.name, "size": 9, "visits": C.GTP_VISITS,
        "script": "tests.test_torch_common.GTP_SCRIPT",
        "main": "GTP_MAIN_SCRIPT through gtp.main with GTP_CONFIG"})


def make_analysis():
    import io
    from katago_tpu.cli import analysis as JAN
    outs = {}
    for name, script in C.ANALYSIS_SCRIPTS.items():
        eng = JAN.AnalysisEngine(str(BIN_B1C6))
        out = io.StringIO()
        JAN.run_protocol(eng, io.StringIO(script), out)
        outs[name] = np.array(out.getvalue())
    save("analysis", outs, {"model": BIN_B1C6.name,
                            "scripts": "tests.test_torch_common."
                            "ANALYSIS_SCRIPTS"})


NET_SIZE, NET_BATCH, NET_INPUT_SEED = 5, 3, 11
HUMANSL_BIN = OUT / C.HUMANSL_MODEL


def _jax_cfg(kind: str, fields: dict | None = None):
    return C.net_config(JC, kind, fields)


def make_model_shapes():
    """Every preset's Flax parameter shapes from jax.eval_shape (nothing
    compiled), as JSON."""
    shapes = {}
    for name, cfg in JC.CONFIGS.items():
        m = JModel(cfg, pos_len=NET_SIZE, dtype=jnp.float32)
        tree = jax.eval_shape(m.init, jax.random.PRNGKey(0),
                              jnp.zeros((1, NET_SIZE, NET_SIZE, 22)),
                              jnp.zeros((1, 19)))["params"]
        shapes[name] = {"/".join(k.key for k in path): list(v.shape)
                        for path, v in
                        jax.tree_util.tree_flatten_with_path(tree)[0]}
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "model_shapes.json").write_text(json.dumps({
        "meta": {"made_by": "jax.eval_shape(KataGoModel(cfg, pos_len="
                            f"{NET_SIZE}).init) of every config.CONFIGS"},
        "shapes": shapes}, sort_keys=True))
    print(f"wrote model_shapes.json ({len(shapes)} presets)", flush=True)


def make_nets():
    """A float32 forward of each NET_KINDS config with seeded weights."""
    sp, gl, mask, meta = C.net_inputs(NET_SIZE, NET_BATCH, NET_INPUT_SEED)
    arrays = {}
    for i, kind in enumerate(C.NET_KINDS):
        cfg = _jax_cfg(kind)
        params = C.net_params(cfg, NET_SIZE, seed=100 + i)
        m = JModel(cfg, pos_len=NET_SIZE, dtype=jnp.float32)
        out = jax.jit(m.apply)({"params": params}, sp, gl, mask, meta)
        arrays.update(flat(params, f"w_{kind}"))
        arrays.update({f"out_{kind}/{k}": np.asarray(v)
                       for k, v in out.items()})
    save("nets", arrays, {
        "size": NET_SIZE, "batch": NET_BATCH, "kinds": list(C.NET_KINDS),
        "configs": "tests.test_torch_common.NET_KINDS",
        "weights": "net_params(cfg, size, seed=100 + index of the kind)",
        "inputs": f"net_inputs(size, batch, {NET_INPUT_SEED}): spatial, "
                  "global, mask, metadata",
        "dtype": "float32"})


def make_nets_train():
    """compute_losses of the NET_TRAIN net (intermediate head, nbttf-GAB,
    QK-norm GQA) on the train_losses batch, its gradients, and one step
    of sgd and of normuon (Newton-Schulz in float32) from them."""
    import optax
    cfg = _jax_cfg("net_train", C.NET_TRAIN)
    params = {"params": C.net_params(cfg, TRAIN_SIZE, seed=200)}
    model = JModel(cfg, pos_len=TRAIN_SIZE, dtype=jnp.float32)
    batch = {k: jnp.asarray(v) for k, v in train_batch().items()}
    seki_in = JLOSS.SekiEma(sum=jnp.float32(SEKI_IN[0]),
                            weight=jnp.float32(SEKI_IN[1]))

    def loss(p):
        raw = model.apply(p, batch["binaryInputNCHW"].transpose(0, 2, 3, 1),
                          batch["globalInputNC"])
        return JLOSS.compute_losses(raw, batch, seki_ema=seki_in,
                                    is_training=True)

    _, metrics, ema = jax.jit(loss)(params)
    arrays = {f"m/{k}": np.asarray(v) for k, v in metrics.items()}
    arrays["seki"] = np.asarray([ema.sum, ema.weight])
    grads = jax.jit(jax.grad(lambda p: loss(p)[0]))(params)
    arrays.update(flat(params["params"], "w"))
    arrays.update(flat(grads["params"], "grad"))
    for kind, tag, ctx in (("sgd", "sgd", None),
                           ("normuon", "normuon_f32", ns_float32)):
        opt = JSTEP.make_optimizer(lr=OPT_LR, kind=kind)
        st = opt.init(params)
        if ctx is None:
            upd, _ = jax.jit(opt.update)(grads, st, params)
        else:
            with ctx():
                upd, _ = jax.jit(opt.update)(grads, st, params)
        arrays.update(flat(optax.apply_updates(params, upd)["params"],
                           f"{tag}/p0"))
    save("nets_train", arrays, {
        "config": "tests.test_torch_common.NET_TRAIN",
        "weights": "net_params(cfg, size, seed=200)", "size": TRAIN_SIZE,
        "batch": TRAIN_BATCH,
        "rows": f"random_rows(size, batch, {LOSS_ROWS_SEED}) through "
                "decode_rows", "seki_in": SEKI_IN, "lr": OPT_LR,
        "steps": "one step of sgd and of normuon (ns_float32) from the "
                 "weights with these gradients"})


DESC_TF_CASES = {"fixed_rope": "attn_ffn", "metadata": "metadata"}


def make_desc_tf():
    """apply_desc_model on v17 files: the JAX exporter's files of the
    nets fixture's attn_ffn (fixed RoPE) and metadata weights, and the
    tool-written tiny transformer (learnable RoPE, GQA, trunk-tip
    RMSNorm, spatial and per position)."""
    from katago_tpu.models import desc as JD
    from katago_tpu.models import export as JEXP
    nets, _ = C.load_ref("nets")
    sp, gl, mask, meta = C.net_inputs(NET_SIZE, NET_BATCH, NET_INPUT_SEED)
    arrays = {}
    with tempfile.TemporaryDirectory() as tmp:
        files = {}
        for case, kind in DESC_TF_CASES.items():
            path = f"{tmp}/{case}.bin"
            JEXP.export_model(C.flax_tree(nets, f"w_{kind}"),
                              _jax_cfg(kind), path)
            files[case] = path
        for spatial in (True, False):
            case = f"learnable_rope_rms{'_spatial' if spatial else ''}"
            files[case] = f"{tmp}/{case}.txt.gz"
            C.write_tiny_transformer_model(files[case], seed=7,
                                           spatial_rms=spatial)
        for case, path in files.items():
            desc = JD.load_model(path)
            out = JD.apply_desc_model(desc, sp, gl, mask=mask,
                                      metadata=meta)
            for k, v in out.items():
                arrays[f"{case}/{k}"] = np.asarray(v)
            arrays[f"{case}/sha256"] = np.array(desc.sha256)
    save("desc_tf", arrays, {
        "cases": sorted(files), "exported": DESC_TF_CASES,
        "written": "write_tiny_transformer_model(path, seed=7, "
                   "spatial_rms=...)",
        "inputs": f"net_inputs({NET_SIZE}, {NET_BATCH}, {NET_INPUT_SEED})"})


FEATURE_VERSIONS = (3, 4, 5, 6)


def make_features_versions():
    """fill_features at versions 3..6 (chase ladders, no cached masks) on
    the features fixture's games."""
    size = 9
    t_gs = None
    for rules, g, n, seed, pp in FEATURE_GAMES:
        t = C.random_games_torch(size, g, n, rules, seed, pass_prob=pp)
        t_gs = t if t_gs is None else C.tree_cat(t_gs, t)
    j_gs = C.jax_games_like(t_gs, size)
    params = JF.FeatureParams(jnp.float32(0.5), jnp.float32(0.25),
                              jnp.bool_(False))
    arrays = {}
    for v in FEATURE_VERSIONS:
        sp, gl = jax.jit(jax.vmap(lambda gs_: JF.fill_features(
            gs_, size, params, JH.legal_moves(gs_, size), version=v,
            ladder_mode="chase")))(j_gs)
        arrays[f"v{v}/spatial"] = np.asarray(sp)
        arrays[f"v{v}/global"] = np.asarray(gl)
    save("features_versions", arrays, {
        "size": size, "games": FEATURE_GAMES, "versions": FEATURE_VERSIONS,
        "games_by": "tests.test_torch_common.random_games_torch, "
                    "concatenated in order",
        "feature_params": [0.5, 0.25, False],
        "call": "jax.vmap(fill_features(gs, size, params, legal, "
                "version=v, ladder_mode='chase')): no cached masks"})


def make_pattern_search():
    """A 5x5 SearchDriver search of one game with and without an
    avoid-repeated-shapes table of its moves and of moves made before
    from its root position (tests.test_torch_common.pattern_history)."""
    from katago_tpu.search import patternbonus as JPB
    size, visits = SEARCH_SIZE, SEARCH_VISITS
    params = jax_params()
    jm = jax_model(size)
    roots, _ = _jax_roots(size, [C.PATTERN_MOVES])
    boards, plas = [], []
    gs = C.jax_batch(JH.new_game(size, JH.RulesArr.from_rules(
        JR.Rules.tromp_taylorish()), 64), 1)
    step = jax.jit(jax.vmap(lambda s, m: JH.step(s, m, size)[0]))
    for mv in C.PATTERN_MOVES:
        boards.append(np.asarray(gs.pos.board.stones[0]))
        plas.append(int(gs.pos.to_move[0]))
        gs = step(gs, jnp.asarray([mv], jnp.int32))
    pla_for = int(gs.pos.to_move[0])
    hist = C.pattern_history(boards, plas, np.asarray(gs.pos.board.stones[0]),
                             pla_for)
    table = JPB.build_avoid_repeat_table(*hist, size, pla_for,
                                         C.PATTERN_UTILITY)
    drv = JDriver(jm.apply, params, _search_params(), size=size,
                  max_nodes=visits + 3, chunk_size=visits // 2,
                  with_ladders=True)
    arrays = {"keys": np.asarray(table.keys), "bonus": np.asarray(table.bonus)}
    for tag, pb in (("on", table), ("off", None)):
        res = drv.search(roots, jax.random.PRNGKey(0), max_visits=visits + 1,
                         pattern_bonus=pb)
        arrays.update(_result_arrays(res, f"{tag}/"))
        arrays[f"{tag}/pattern_stats"] = np.asarray(
            res.ss.tree.stats[..., 17])
    save("pattern_search", arrays, {
        "size": size, "visits": visits, "max_nodes": visits + 3,
        "chunk_size": visits // 2, "moves": C.PATTERN_MOVES,
        "pla_for": pla_for, "utility": C.PATTERN_UTILITY,
        "weights": f"weights_b1c6_s{WEIGHT_SEED}",
        "params": "for_selfplay, root noise off", "with_ladders": True,
        "table": "build_avoid_repeat_table(*pattern_history(boards "
                 "before each move, players, root board, pla_for), size, "
                 "pla_for, utility)"})


def _write_humansl_net():
    """b1c6 with the metadata encoder, seeded, through the JAX exporter,
    gzipped with mtime 0 (a stable file)."""
    import gzip
    from katago_tpu.models import export as JEXP
    cfg = dataclasses.replace(JC.get_config("b1c6"), metadata_encoder=True,
                              metadata_encoder_channels=8)
    params = C.net_params(cfg, C.HUMANSL_SIZE, seed=300)
    with tempfile.TemporaryDirectory() as tmp:
        JEXP.export_model(params, cfg, f"{tmp}/h.bin", name="humansl-b1c6")
        data = Path(f"{tmp}/h.bin").read_bytes()
    with gzip.GzipFile(HUMANSL_BIN, "wb", mtime=0) as f:
        f.write(data)


def make_humansl():
    import contextlib
    import io
    from katago_tpu.cli import analysis as JAN
    from katago_tpu.cli import humanslnet_server as JSRV
    _write_humansl_net()
    outs = {}
    with tempfile.TemporaryDirectory() as tmp:
        cfg = Path(tmp) / "gtp.cfg"
        cfg.write_text(C.HUMANSL_GTP_CONFIG)
        outs["gtp"] = _gtp_transcript(
            C.HUMANSL_GTP_SCRIPT, ["-model", str(HUMANSL_BIN), "-config",
                                   str(cfg), "-boardsize", "9"])
    from katago_tpu.models import desc as JD
    eng = JAN.AnalysisEngine(str(HUMANSL_BIN))
    # the JAX engine's apply (make_desc_apply) takes no metadata, so its
    # humanSLProfile searches fail; give it apply_desc_model, as its GTP
    # engine has, to record what it answers with the profile applied
    eng.model_apply = lambda p, s, g, metadata=None: JD.apply_desc_model(
        eng.desc, s, g, metadata=metadata)
    out = io.StringIO()
    JAN.run_protocol(eng, io.StringIO(C.HUMANSL_ANALYSIS_SCRIPT), out)
    outs["analysis"] = out.getvalue()
    out = io.StringIO()
    saved = sys.stdin
    sys.stdin = io.StringIO(C.HUMANSL_SERVER_SCRIPT)
    try:
        with contextlib.redirect_stdout(out):
            JSRV.main(["-model", str(HUMANSL_BIN)])
    finally:
        sys.stdin = saved
    outs["server"] = out.getvalue()
    save("humansl", {k: np.array(v) for k, v in outs.items()}, {
        "model": HUMANSL_BIN.name,
        "model_by": "b1c6 + metadata_encoder (8 channels), "
                    "net_params(cfg, 9, seed=300), the JAX exporter",
        "gtp": "HUMANSL_GTP_SCRIPT through gtp.main with HUMANSL_GTP_CONFIG",
        "analysis": "HUMANSL_ANALYSIS_SCRIPT, the engine's model_apply "
                    "replaced by apply_desc_model (its own takes no "
                    "metadata)", "server":
        "HUMANSL_SERVER_SCRIPT through humanslnet_server.main -model"})


def make_vnets():
    """GTP and analysis sessions on the tiny nets of model versions 3, 5,
    6 and 7 (input features V3-V6)."""
    import io
    from katago_tpu.cli import analysis as JAN
    from katago_tpu.cli import gtp as JGTP
    outs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for v in C.VNET_VERSIONS:
            path = f"{tmp}/v{v}.txt.gz"
            C.write_tiny_model(path, v, seed=v)
            eng = JGTP.GTPEngine(model_path=path, size=C.VNET_SIZE,
                                 visits=C.GTP_VISITS)
            out = io.StringIO()
            JGTP.run_gtp(eng, io.StringIO(C.VNET_GTP_SCRIPT), out)
            outs[f"gtp_v{v}"] = out.getvalue()
            aeng = JAN.AnalysisEngine(path)
            out = io.StringIO()
            JAN.run_protocol(aeng, io.StringIO(C.VNET_ANALYSIS_SCRIPT), out)
            outs[f"analysis_v{v}"] = out.getvalue()
    save("vnets", {k: np.array(v) for k, v in outs.items()}, {
        "versions": list(C.VNET_VERSIONS), "size": C.VNET_SIZE,
        "visits": C.GTP_VISITS,
        "models": "write_tiny_model(path, version, seed=version)",
        "gtp": "VNET_GTP_SCRIPT through GTPEngine(size, visits)",
        "analysis": "VNET_ANALYSIS_SCRIPT (through the chunked driver: "
                    "reportDuringSearchEvery)"})


def _stdout_of(fn, *args):
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue()


def make_match():
    import functools
    from katago_tpu.cli import match_cmd as JM
    params = {s: jax_params(s) for s in C.MATCH_SEEDS}
    apply = jax_model(SEARCH_SIZE).apply
    orig_sp, orig_pm = JM.SearchParams, JM.play_match
    JM.SearchParams = C.temperature_zero(orig_sp)
    try:
        match = JM.play_match(apply, params[3], apply, params[4],
                              **C.MATCH_ARGS)
        JM.play_match = functools.partial(
            orig_pm, max_moves=C.ROUND_ROBIN_MAX_MOVES)
        rr = JM.play_round_robin(
            [(f"s{s}", apply, params[s]) for s in C.MATCH_SEEDS],
            **C.ROUND_ROBIN_ARGS)
    finally:
        JM.SearchParams, JM.play_match = orig_sp, orig_pm
    arrays = {"w5" + k[1:]: v for k, v in flat_params(params[5]).items()}
    save("match", arrays, {
        "match": match, "round_robin": rr, "seeds": list(C.MATCH_SEEDS),
        "weights": "flax_params(b1c6 at 5, seed); seed 5 stored as w5/",
        "patch": "match_cmd.SearchParams = temperature_zero(SearchParams)"
                 "; round robin: match_cmd.play_match bound max_moves="
                 f"{C.ROUND_ROBIN_MAX_MOVES}",
        "match_args": C.MATCH_ARGS, "round_robin_args": C.ROUND_ROBIN_ARGS})


def make_gatekeeper():
    import functools
    from katago_tpu.cli import gatekeeper_cmd as JG
    from katago_tpu.cli import match_cmd as JM
    orig_sp, orig_pm = JM.SearchParams, JG.play_match
    JM.SearchParams = C.temperature_zero(orig_sp)
    JG.play_match = functools.partial(orig_pm, max_moves=C.GATE_MAX_MOVES)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            dirs = {n: os.path.join(tmp, n) for n in
                    ("test-models", "models", "rejected-models")}
            t0 = time.time() - 1000.0
            calls = []
            for names, threshold in C.GATE_CALLS:
                for name in names:
                    seed = C.GATE_CANDIDATES[name]
                    path = JCK.export_params(dirs["test-models"], name,
                                             jax_params(seed))
                    t = t0 + 10.0 * seed
                    os.utime(path, (t, t))
                calls.append(JG.run_gatekeeper(
                    dirs["test-models"], dirs["models"],
                    dirs["rejected-models"], win_threshold=threshold,
                    **C.GATE_ARGS))
            layout = {n: sorted(os.listdir(d)) for n, d in dirs.items()}
    finally:
        JM.SearchParams, JG.play_match = orig_sp, orig_pm
    save("gatekeeper", {}, {
        "calls": calls, "layout": layout, "gate_args": C.GATE_ARGS,
        "gate_calls": C.GATE_CALLS,
        "candidates": C.GATE_CANDIDATES,
        "weights": "flax_params(b1c6 at 5, seed) (seed 5: match.npz w5/)",
        "mtimes": "each export's mtime set to t0 + 10 * seed",
        "patch": "match_cmd.SearchParams = temperature_zero(SearchParams)"
                 "; gatekeeper_cmd.play_match bound max_moves="
                 f"{C.GATE_MAX_MOVES}"})


def make_forward():
    from katago_tpu.cli import forward_cmd as JFWD
    outs = {}
    with tempfile.TemporaryDirectory() as tmp:
        sgf = Path(tmp) / "game.sgf"
        sgf.write_text(C.TOOLS_SGF)
        for name, args in C.FORWARD_CASES.items():
            argv = ["-model", str(BIN_B1C6)] + [a.format(sgf=sgf)
                                                 for a in args]
            outs[name] = np.array(_stdout_of(JFWD.main, argv))
    save("forward", outs, {"model": BIN_B1C6.name,
                           "cases": "tests.test_torch_common.FORWARD_CASES"
                                    " (sgf: TOOLS_SGF)"})


def make_evalsgf():
    from katago_tpu.cli import sgf_cmds as JSGF
    outs = {}
    with tempfile.TemporaryDirectory() as tmp:
        sgf = Path(tmp) / "game.sgf"
        sgf.write_text(C.TOOLS_SGF)
        for name, args in C.EVALSGF_CASES.items():
            argv = ["evalsgf", str(sgf), "-model", str(BIN_B1C6),
                    "-visits", str(C.EVALSGF_VISITS)] + args
            outs[name] = np.array(_stdout_of(JSGF.main, argv))
    save("evalsgf", outs, {"model": BIN_B1C6.name,
                           "visits": C.EVALSGF_VISITS,
                           "cases": "tests.test_torch_common.EVALSGF_CASES"
                                    " on TOOLS_SGF"})


def make_play():
    from katago_tpu.cli import play_cmd as JPLAY
    JPLAY.input = C.scripted_input(C.PLAY_INPUTS)
    try:
        out = _stdout_of(JPLAY.main, ["-model", str(BIN_B1C6)]
                         + C.PLAY_ARGS)
    finally:
        del JPLAY.input
    save("play", {"transcript": np.array(out)}, {
        "model": BIN_B1C6.name, "args": C.PLAY_ARGS,
        "inputs": C.PLAY_INPUTS,
        "input": "play_cmd.input = scripted_input(PLAY_INPUTS)"})


CLEAN_SEED, CLEAN_NAME = 4, "cleaned"


def make_ckpt_clean():
    import gzip
    from katago_tpu.cli import checkpoint_tools_cmd as JCT
    state = JSTEP.init_train_state(jax_params(CLEAN_SEED),
                                   JSTEP.make_optimizer())
    with tempfile.TemporaryDirectory() as tmp:
        path = JCK.save_checkpoint(os.path.join(tmp, "ckpt"), state, 0)
        out_dir = os.path.join(tmp, "out")
        printed = _stdout_of(JCT.main, [
            "clean", "-ckpt", path, "-out", out_dir, "-name", CLEAN_NAME,
            "-config", "b1c6", "-size", str(SEARCH_SIZE), "-bin-gz"])
        with gzip.open(os.path.join(out_dir, f"{CLEAN_NAME}.bin.gz")) as f:
            data = f.read()
    # the printed paths lay in a temporary directory
    printed = {k: v for k, v in json.loads(printed).items()
               if k not in ("bin_gz", "export")}
    save("ckpt_clean", {"bin": np.frombuffer(data, np.uint8)}, {
        "printed": printed, "name": CLEAN_NAME,
        "config": "b1c6", "size": SEARCH_SIZE,
        "weights": f"init_train_state(flax_params(b1c6 at 5, seed "
                   f"{CLEAN_SEED})): params = EMA = SWA, step 0"})


# ---- slice 8: the SGF tools, genboard / genposes, the book, contribute,
# the fused actor-learner -------------------------------------------------

def _write_corpus(d: Path) -> dict:
    corpus = C.sgf_corpus()
    d.mkdir(parents=True, exist_ok=True)
    for name, text in corpus.items():
        (d / name).write_text(text)
    # an .sgfs of several games, one per line
    (d / "more.sgfs").write_text("\n".join(
        [corpus["g0.sgf"], corpus["g3.sgf"]]) + "\n")
    return corpus


def _dir_texts(d: Path) -> dict:
    """The text files of d by name (npz files left out)."""
    return {p.name: p.read_text() for p in sorted(d.iterdir())
            if p.suffix != ".npz"}


def make_sgftools():
    """sgfscan, summarize_sgfs, the six sgf_cmds subcommands and
    npz_tools on tests.test_torch_common.sgf_corpus (SGF_TOOL_CASES)."""
    import dataclasses as dc
    from katago_tpu.cli import npz_tools_cmd as JNPZ
    from katago_tpu.cli import sgf_cmds as JSGF
    from katago_tpu.cli import summarize_sgfs_cmd as JSUM
    from katago_tpu.dataio import sgfscan as JSCAN
    arrays, out = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        corpus = _write_corpus(tmp / "sgf")
        out["scan"] = {name: dc.asdict(JSCAN.scan_sgf_or_parse(text))
                       for name, text in corpus.items()}
        out["native"] = JSCAN.have_native()
        # a malformed line: the native scanner's summary, the parser's
        # verdict (the JAX fallback when the library is absent)
        native = JSCAN.scan_sgf(C.SGF_BROKEN)
        out["broken"] = {
            "native": dc.asdict(native) if native else None,
            "parser": _parse_or_none(C.SGF_BROKEN) != []}
        out["summarize"] = {
            name: _stdout_of(JSUM.main, [str(tmp / "sgf")] + extra)
            for name, extra in (("json", ["-json"]), ("text", []))}
        for name, case in C.SGF_TOOL_CASES.items():
            work = tmp / name
            work.mkdir()
            argv = [a.format(sgf=tmp / "sgf", out=work, model=BIN_B1C6)
                    for a in case]
            printed = _stdout_of(JSGF.main, argv)
            out[name] = {"stdout": printed, "files": _dir_texts(work)}
            for npz in work.glob("*.npz"):
                with np.load(npz) as z:
                    arrays.update({f"{name}/{k}": z[k] for k in z.files})
            if name in C.SGF_VIEW_CASES:
                for vname, vcase in C.SGF_VIEW_CASES[name].items():
                    files = sorted(work.glob("*.txt")) + sorted(
                        work.glob("*.jsonl"))
                    vargv = [a for f in files if "hashes" not in f.name
                             for a in ("--start-poses-file", str(f))]
                    vargv = [vcase[0]] + vargv + [
                        a.format(model=BIN_B1C6) for a in vcase[1:]]
                    out[vname] = {"stdout": _stdout_of(JSGF.main, vargv)}
        # npz_tools on seeded shards: summarize, then add-meta twice
        d = tmp / "npz"
        C.write_shards(d / "a", C.SGF_SIZE, [5, 7], 1)
        C.write_shards(d / "b", C.SGF_SIZE, [3], 2)
        (d / "b" / "bad.npz").write_bytes(b"not a zip")
        out["npz_summarize"] = _stdout_of(
            JNPZ.main, ["summarize", str(d / "a"), str(d / "b")]
        ).replace(str(d), "{dir}")
        (d / "b" / "bad.npz").unlink()
        for prof in C.NPZ_PROFILES:
            out[f"add_meta_{prof or 'selfplay'}"] = _stdout_of(
                JNPZ.main, ["add-meta", "-dir", str(d), "-profile", prof,
                            "-board-area", str(C.SGF_SIZE ** 2), "-force"])
            for f in sorted(d.rglob("*.npz")):
                with np.load(f) as z:
                    arrays[f"meta_{prof or 'selfplay'}/"
                           f"{f.parent.name}/{f.name}"] = \
                        z["metadataInputNC"]
    save("sgftools", arrays, {
        "corpus": C.sgf_corpus(), "outputs": out,
        "cases": "tests.test_torch_common.SGF_TOOL_CASES, SGF_VIEW_CASES, "
                 "NPZ_PROFILES", "model": BIN_B1C6.name,
        "shards": "write_shards(a, 7, [5, 7], 1), write_shards(b, 7, [3], "
                  "2) and b/bad.npz (not a zip) for summarize"})


def _gumbel_rows(key, steps: int, shape) -> np.ndarray:
    """The Gumbel noise of `steps` jax.random.categorical draws made as
    `key, sub = split(key)` then categorical(sub, logits[shape])."""
    rows = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        rows.append(np.asarray(jax.random.gumbel(sub, shape, jnp.float32)))
    return np.stack(rows)


def make_genposes():
    """genposes_cmd.main at 7x7 in both modes on b1c6_s3.bin.gz
    (GENPOSES_ARGS), with its games, leads and categorical noise."""
    from katago_tpu.cli import genposes_cmd as JGP
    from katago_tpu.models import desc as JD
    from katago_tpu.search import mcts as JM
    arrays, out = {}, {}
    a = C.GENPOSES_ARGS
    size, n, nn = a["size"], a["n"], a["size"] ** 2
    apply = JD.make_desc_apply(JD.load_model(str(BIN_B1C6)))
    evaluator = JM.make_nn_evaluator(apply, None, size, with_ladders=False)
    for mode in ("random", "clumpy"):
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "poses.jsonl")
            printed = _stdout_of(JGP.main, C.genposes_argv(
                path, str(BIN_B1C6), mode))
            lines = Path(path).read_text()
        budget = np.random.default_rng(a["seed"]).integers(
            a["min_moves"], a["max_moves"] + 1, size=n)
        key = jax.random.PRNGKey(a["seed"])
        games = jax.jit(lambda k, b: JGP.generate_positions(
            n, size, a["max_moves"], k, b, clumpy=(mode == "clumpy")))(
                key, jnp.asarray(budget))
        raw, _, _ = jax.jit(lambda gs: evaluator(
            gs, JF.FeatureParams.default()))(games)
        arrays.update({
            f"{mode}/gumbel": _gumbel_rows(key, a["max_moves"], (n, nn)),
            f"{mode}/budget": budget,
            f"{mode}/stones": np.asarray(games.pos.board.stones),
            f"{mode}/to_move": np.asarray(games.pos.to_move),
            f"{mode}/move_num": np.asarray(games.pos.move_num),
            f"{mode}/lead_mover": np.asarray(raw["miscvalue"][:, 2]) * 20.0})
        out[mode] = {"stdout": printed, "poses": lines}
    save("genposes", arrays, {"args": a, "outputs": out,
                              "model": BIN_B1C6.name,
                              "draws": "gumbel[t] = jax.random.gumbel(sub, "
                                       "(n, nn)) after key, sub = "
                                       "split(key), from PRNGKey(seed)"})


def make_genboard():
    """GenBoardModel (GENBOARD_NET) forward and loss on seeded inputs,
    genboard_cmd train on the SGF corpus (GENBOARD_TRAIN) with its
    initial params and its params npz, and sample_fill with its
    permutation and noise."""
    import random as pyrandom
    from katago_tpu.cli import genboard_cmd as JGBC
    from katago_tpu.models import genboard as JGB
    net = C.GENBOARD_NET
    size = net["size"]
    model = JGB.GenBoardModel(num_channels=net["channels"],
                              num_blocks=net["blocks"])
    dummy = jnp.zeros((1, size, size, JGB.NUM_INPUT_CHANNELS))
    params = model.init(jax.random.PRNGKey(net["seed"]), dummy)
    arrays = {"p/" + "/".join(k.key for k in path): np.asarray(v)
              for path, v in jax.tree_util.tree_flatten_with_path(
                  params["params"])[0]}
    inp = C.genboard_inputs(size, net["batch"], net["seed"])
    x = JGB.build_inputs(*(jnp.asarray(inp[k]) for k in (
        "stones", "known", "points", "turn", "stdev", "source")), size)
    pl, al = model.apply(params, x)
    main, aux = JGB.genboard_loss(pl, al, jnp.asarray(inp["labels"]),
                                  jnp.asarray(inp["stones"]), x)
    arrays.update({"inputs": np.asarray(x), "point_logits": np.asarray(pl),
                   "aux_logits": np.asarray(al), "main": np.asarray(main),
                   "aux": np.asarray(aux)})
    # sample_fill with the fill's own key draws
    b, nn = net["fill_batch"], size * size
    stones, known = C.genboard_pattern(size, b)
    rng = jax.random.PRNGKey(net["fill_seed"])
    filled = JGB.sample_fill(model.apply, params, jnp.asarray(stones),
                             jnp.asarray(known), size=size, rng=rng,
                             turn=30.0, turn_stdev=5.0, source=0.0)
    rng, perm_key = jax.random.split(rng)
    arrays.update({"fill/order": np.asarray(jax.random.permutation(
        perm_key, nn)), "fill/gumbel": _gumbel_rows(rng, nn, (b, 3)),
        "fill/out": np.asarray(filled)})
    # cmd_train on the corpus, and the examples its generator makes
    t = C.GENBOARD_TRAIN
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        _write_corpus(tmp / "sgf")
        out = tmp / "gb.npz"
        printed = _stdout_of(JGBC.cmd_train, argparse.Namespace(
            sgf_dir=str(tmp / "sgf"), out=str(out), **t))
        with np.load(out) as z:
            arrays.update({"trained/" + k: z[k] for k in z.files})
        tmodel = JGB.GenBoardModel(num_channels=t["channels"],
                                   num_blocks=t["blocks"])
        init = tmodel.init(jax.random.PRNGKey(t["seed"]), dummy)
        arrays.update({"init/" + "/".join(k.key for k in path):
                       np.asarray(v) for path, v in
                       jax.tree_util.tree_flatten_with_path(
                           init["params"])[0]})
        games = [g for f in sorted((tmp / "sgf").glob("*.sgf*"))
                 for line in f.read_text().split("\n") if line.strip()
                 for g in _parse_or_none(line)]
        games = [g for g in games if g.size == (size, size)]
        ex = JGBC.make_examples(games, size, t["batch"],
                                pyrandom.Random(t["seed"]))
        for k, v in zip(("stones", "known", "pts", "labels", "aux", "turns",
                         "stds"), ex):
            arrays[f"examples/{k}"] = v
    save("genboard", arrays, {
        "net": net, "train": t, "train_stdout": printed,
        "params": "GenBoardModel.init(PRNGKey(seed)) under p/, cmd_train's "
                  "initial params under init/ and its npz under trained/",
        "fill": "sample_fill(rng=PRNGKey(fill_seed), turn 30, stdev 5, "
                "source 0) on genboard_pattern; order = permutation of "
                "split(rng)[1], gumbel rows from split(rng)[0]",
        "examples": "make_examples(corpus games at size, batch, "
                    "Random(seed)), the first batch cmd_train draws"})


def _parse_or_none(text):
    from katago_tpu.dataio import sgf as JS
    try:
        return JS.parse_sgf(text)
    except Exception:
        return []


def make_book():
    """gen_book at 5x5 on b1c6 (weights seed 3; BOOK_ARGS), its JSON,
    HTML pages and the host commands of book_cmd on it; canonical_hash
    of seeded boards under their 8 symmetries."""
    from katago_tpu.book import book as JB
    from katago_tpu.cli import book_cmd as JBC
    a = C.BOOK_ARGS
    params = jax_params()
    book = JB.gen_book(jax_model(SEARCH_SIZE).apply, params,
                       size=SEARCH_SIZE, visits=a["visits"],
                       rounds=a["rounds"],
                       nodes_per_round=a["nodes_per_round"],
                       log=lambda *_: None)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        path = tmp / "book.json"
        book.save(str(path))
        out["book"] = path.read_text()
        book.write_html(str(tmp / "html"))
        out["html"] = _dir_texts(tmp / "html")
        for name, argv in C.BOOK_CMD_CASES.items():
            work = tmp / name
            work.mkdir()
            argv = [x.format(book=path, out=work, book2=tmp / "b2.json")
                    for x in argv]
            if name == "comparebooks":
                b2 = JB.Book.load(str(path))
                b2.nodes.pop(sorted(b2.nodes)[-1])
                b2.nodes[b2.root_hash].recursive.winloss += 0.25
                b2.save(str(tmp / "b2.json"))
            out[name] = {"stdout": _stdout_of(JBC.main, argv).replace(
                str(tmp), "{tmp}"), "files": _dir_texts(work)}
    boards = C.book_hash_boards()
    hashes = [[JB.canonical_hash(b, pla, b.shape[-1]) for b in syms]
              for syms, pla in boards]
    save("book", {}, {"args": a, "outputs": out, "hashes": hashes,
                      "weights": f"weights_b1c6_s{WEIGHT_SEED}",
                      "search_params": "SearchParams() (gen_book's "
                                       "default), PRNGKey(7)"})


def make_fused():
    """One actor chunk at 5x5 on b1c6 (weights seed 3) at temperature 0
    with root noise off (FUSED_ARGS): 4 games, game 1 over at the start,
    a ring of capacity 8 (it wraps); then one learner step (SGD with
    momentum) on indices drawn from PRNGKey(6)."""
    from katago_tpu.selfplay import fused as JFU
    a = C.FUSED_ARGS
    size = SEARCH_SIZE
    params = jax_params()
    apply = jax_model(size).apply
    normals = np.asarray(jax.random.normal(jax.random.PRNGKey(a["komi_seed"]),
                                           (a["games"],)))
    games = JFU.new_games(size, a["games"], max_moves=a["max_moves"],
                          komi_stdev=a["komi_stdev"],
                          rng=jax.random.PRNGKey(a["komi_seed"]))
    over = np.zeros(a["games"], bool)
    over[list(a["over"])] = True
    games = games._replace(pos=games.pos._replace(
        game_over=jnp.asarray(over)))
    replay = JFU.ReplayRing.create(a["capacity"], size)
    actor = jax.jit(JFU.make_actor_chunk(
        apply, size=size, visits=a["visits"],
        search_params=dataclasses.replace(JParams.for_selfplay(),
                                          root_noise_enabled=False,
                                          **C.TEMPERATURE_ZERO),
        moves_per_chunk=a["moves"]))
    games2, replay2 = actor(params, games, replay, jax.random.PRNGKey(5))
    arrays = {f"ring/{k}": np.asarray(v)
              for k, v in replay2._asdict().items()}
    arrays.update({"normals": normals,
                   "komi": np.asarray(games.rules.komi),
                   "final_stones": np.asarray(games2.pos.board.stones),
                   "final_move_num": np.asarray(games2.pos.move_num),
                   "final_komi": np.asarray(games2.rules.komi)})
    import optax
    opt = optax.sgd(a["lr"], momentum=0.9)
    learner = JFU.make_learner_step(apply, opt, a["batch"])
    rng = jax.random.PRNGKey(6)
    idx = jax.random.randint(rng, (a["batch"],), 0,
                             jnp.maximum(replay2.filled, 1),
                             dtype=jnp.int32)
    new_params, _, metrics = learner(params, opt.init(params), replay2, rng)
    arrays["learner/idx"] = np.asarray(idx)
    arrays.update({f"learner/{k}": np.asarray(v)
                   for k, v in metrics.items()})
    arrays.update({"after/" + k[2:]: v
                   for k, v in flat_params(new_params).items()})
    save("fused", arrays, {
        "args": a, "weights": f"weights_b1c6_s{WEIGHT_SEED}",
        "search_params": "for_selfplay, root noise off, TEMPERATURE_ZERO",
        "actor_key": "PRNGKey(5)", "learner_key": "PRNGKey(6)",
        "optimizer": "optax.sgd(lr, momentum=0.9)",
        "komi": "new_games(komi_stdev, rng=PRNGKey(komi_seed)); normals = "
                "jax.random.normal(PRNGKey(komi_seed), (games,))"})


def make_fused_mesh():
    """The fused step at the `fused` arguments, jitted with the games and
    the ring sharded over a 2-device mesh and the parameters replicated,
    on PRNGKey(5): the learner's indices are those its key's second half
    draws."""
    import optax
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    from katago_tpu.selfplay import fused as JFU
    if len(jax.devices()) != MESH_DEVICES:
        raise RuntimeError("make fused_mesh alone: --only fused_mesh")
    a = C.FUSED_ARGS
    size = SEARCH_SIZE
    params = jax_params()
    apply = jax_model(size).apply
    games = JFU.new_games(size, a["games"], max_moves=a["max_moves"],
                          komi_stdev=a["komi_stdev"],
                          rng=jax.random.PRNGKey(a["komi_seed"]))
    over = np.zeros(a["games"], bool)
    over[list(a["over"])] = True
    games = games._replace(pos=games.pos._replace(
        game_over=jnp.asarray(over)))
    replay = JFU.ReplayRing.create(a["capacity"], size)
    opt = optax.sgd(a["lr"], momentum=0.9)
    opt_state = opt.init(params)
    mesh = Mesh(np.array(jax.devices()), ("data",))
    shard, repl = NamedSharding(mesh, P("data")), NamedSharding(mesh, P())

    def place(tree, n):
        return jax.tree.map(lambda x: jax.device_put(
            x, shard if x.ndim >= 1 and x.shape[0] == n else repl), tree)

    games, replay = place(games, a["games"]), place(replay, a["capacity"])
    params, opt_state = place(params, -1), place(opt_state, -1)
    step = jax.jit(JFU.make_fused_step(
        apply, opt, size=size, visits=a["visits"], batch_size=a["batch"],
        moves_per_chunk=a["moves"],
        search_params=dataclasses.replace(JParams.for_selfplay(),
                                          root_noise_enabled=False,
                                          **C.TEMPERATURE_ZERO)))
    key = jax.random.PRNGKey(5)
    new_params, _, games2, replay2, metrics = step(
        params, opt_state, games, replay, jax.device_put(key, repl))
    assert len(replay2.spatial.sharding.device_set) == 2
    _, r_learn = jax.random.split(key)
    idx = jax.random.randint(r_learn, (a["batch"],), 0,
                             jnp.maximum(replay2.filled, 1),
                             dtype=jnp.int32)
    arrays = {f"ring/{k}": np.asarray(v)
              for k, v in replay2._asdict().items()}
    arrays.update({"final_stones": np.asarray(games2.pos.board.stones),
                   "final_move_num": np.asarray(games2.pos.move_num),
                   "final_komi": np.asarray(games2.rules.komi),
                   "learner/idx": np.asarray(idx)})
    arrays.update({f"learner/{k}": np.asarray(v)
                   for k, v in metrics.items()})
    arrays.update({"after/" + k[2:]: v
                   for k, v in flat_params(new_params).items()})
    save("fused_mesh", arrays, {
        "args": a, "weights": f"weights_b1c6_s{WEIGHT_SEED}",
        "devices": MESH_DEVICES, "sharding": "games and ring P('data'), params and "
                                  "optimizer state P()",
        "search_params": "for_selfplay, root noise off, TEMPERATURE_ZERO",
        "key": "PRNGKey(5) into make_fused_step; learner indices from "
               "randint(split(key)[1], (batch,), 0, max(filled, 1))",
        "optimizer": "optax.sgd(lr, momentum=0.9)",
        "komi": "new_games(komi_stdev, rng=PRNGKey(komi_seed)), the "
                "fused fixture's normals"})


JAX_CKPT_SHARDS = [24, 20]          # rows per shard at TRAIN_SIZE
JAX_CKPT_STEPS = 2                  # steps before the checkpoint


def make_jax_ckpt():
    """run_training (TRAIN_RUN) for JAX_CKPT_STEPS steps with SGD and
    with normuon (ns_float32), each checkpoint flattened by
    tools/jax_checkpoint_to_npz.py; then one more JAX step from it."""
    import contextlib

    from tools import jax_checkpoint_to_npz as J2N
    arrays = {}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        for i, path in enumerate(C.write_shards(
                data, TRAIN_SIZE, JAX_CKPT_SHARDS, TRAIN_DATA_SEED)):
            with np.load(path) as z:
                arrays.update({f"shard{i:03d}/{k}": z[k] for k in z.files})
        for kind, ctx in (("sgd", contextlib.nullcontext),
                          ("normuon", ns_float32)):
            ckpt = os.path.join(tmp, f"ckpt_{kind}")
            with ctx():
                _jax_run(data, ckpt, JAX_CKPT_STEPS, optimizer_kind=kind)
            npz = os.path.join(tmp, f"{kind}.npz")
            J2N.convert(JCK.latest_checkpoint(ckpt), "b1c6", TRAIN_SIZE,
                        kind, npz)
            with np.load(npz) as z:
                arrays.update({f"{kind}/npz/{k}": z[k] for k in z.files})
            with open(npz + ".json") as f:
                meta = json.load(f)
            with ctx():
                lines, next_meta, state, _ = _jax_run(
                    data, ckpt, 1, optimizer_kind=kind)
            arrays.update({f"{kind}/next/{k}": v
                           for k, v in _state_arrays(state).items()})
            out[kind] = {"metadata": meta, "data_dir": data,
                         "next_metrics": lines[-1],
                         "next_global_step": next_meta["global_step"]}
    save("jax_ckpt", arrays, {
        "run_training": dict(TRAIN_RUN, steps=JAX_CKPT_STEPS),
        "shards": JAX_CKPT_SHARDS, "data_seed": TRAIN_DATA_SEED,
        "runs": out, "ns_dtype": {"sgd": None, "normuon": "float32"},
        "npz": "KIND/npz/<keystr path>: tools/jax_checkpoint_to_npz.py's "
               "arrays; runs[KIND].metadata its JSON (paths under the "
               "maker's data_dir)",
        "next": "KIND/next/*: the state after one more run_training step"})


MAKERS = {"weights_b1c6": make_weights, "search": make_search,
          "chase": make_chase, "ladder_exact": make_ladder_exact,
          "selfplay": make_selfplay, "resign": make_resign,
          "features": make_features,
          "handicap": make_handicap,
          "npz_schema": make_schema, "train_losses": make_train_losses,
          "train": make_train, "train_muon": make_train_muon,
          "train_resume": make_train_resume, "desc": make_desc,
          "search_extras": make_search_extras, "gtp": make_gtp,
          "analysis": make_analysis, "model_shapes": make_model_shapes,
          "nets": make_nets, "nets_train": make_nets_train,
          "desc_tf": make_desc_tf,
          "features_versions": make_features_versions,
          "pattern_search": make_pattern_search, "humansl": make_humansl,
          "vnets": make_vnets, "match": make_match,
          "gatekeeper": make_gatekeeper, "forward": make_forward,
          "evalsgf": make_evalsgf, "play": make_play,
          "ckpt_clean": make_ckpt_clean, "sgftools": make_sgftools,
          "genposes": make_genposes, "genboard": make_genboard,
          "book": make_book, "fused": make_fused,
          "fused_mesh": make_fused_mesh, "jax_ckpt": make_jax_ckpt}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", nargs="*", choices=sorted(MAKERS),
                    help="fixtures to write (default: all)")
    opts = ap.parse_args()
    torch.set_num_threads(1)
    names = opts.only or list(MAKERS)
    for name in names:
        t0 = time.time()
        if name == "fused_mesh" and names != ["fused_mesh"]:
            import subprocess
            subprocess.run([sys.executable, __file__, "--only", name],
                           check=True)
        else:
            MAKERS[name]()
        print(f"{name}: {time.time() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
