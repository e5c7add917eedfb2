"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--baseline DIR]

Phases (any failure raises and exits non-zero; nothing is caught):
  1. build both CUDA kernels from katago_torch/ops/csrc (one nvcc each)
     and both C++ host libraries from katago_torch/dataio/csrc (one g++
     each), all in parallel, and print the build times;
  2. K2 connected_labels vs its plain torch version on the cases of
     katago_torch/ops/cases.py (a spiral, a serpentine, a checkerboard,
     a full and an empty board, 128 random mid-game 19x19 boards) —
     exact equality; then its time on the main path's [128, 361] shape;
  3. K1 chase_lanes vs its plain torch version on the 4096 lanes that
     _chase_setup builds from 128 random mid-game 19x19 positions (ko and
     atari boards included) and on the lanes of the quirk cases — exact
     equality; then its time on the 4096 main-path lanes;
  4. the b18c384nbt net in bfloat16 at batch 128 — finite outputs;
  5. SearchDriver.search at 19x19, b18c384nbt, bf16, 128 games,
     SearchParams.for_selfplay(), ladder planes on, chunks of 200, 600
     visits: every game reaches visits+1 and both kernels' launch counters
     rise during the search;
  6. the exact ladder solver on the card vs the JAX package's results
     saved in tests/data/torch_ref/ladder_exact.npz — exact; then
     selfplay (`run_selfplay_phase`): play_games on the same net, with
     tree reuse, the chase ladders in the search and the exact solver in
     the recorded rows; the rows go through the port's npz writer and
     the sgf writer into a temporary directory and are read back and
     checked against the npz schema of tests/data/torch_ref/; both
     kernels' launch counters rise during the games;
  7. the trainer (`run_train_phase`): run_training on phase 6's shard
     (459 rows at 19x19, served again each epoch) with b18c384nbt in
     float32 (TF32 off) at batch 256: TRAIN_WARMUP SGD steps, then
     TRAIN_STEPS more resumed from their checkpoint (timed: data,
     host-to-device, forward+backward, optimizer+EMA), then MUON_STEPS
     steps of -optimizer normuon from scratch; every loss term and gnorm
     finite; the checkpoint restored, saved again and restored equal, the
     export equal to the restored EMA, the .bin.gz written; then one SGD
     step of CHECK_MODEL at batch CHECK_BATCH from the shard on the card
     and on the CPU from the same weights, loss terms and updates held
     within stated tolerances;
  8. selfplay from phase 7's export (`run_models_dir_phase`):
     run_selfplay(models_dir=...) at 19x19, 128 games, 32 visits, bf16,
     every move recorded, P8_MOVES moves: the output directory is named
     after the export and the shard holds rows;
  9. the GTP engine (`run_gtp_phase`) on phase 7's b18c384nbt .bin.gz,
     loaded with the port's desc.load_model: first DescNet against
     KataGoModel on the exported EMA weights, float32, on 8 positions of
     phase 6's shard (largest relative difference per output key within
     DESC_RTOL); then a scripted 19x19 session through run_gtp (plays,
     genmoves at GTP_VISITS, a streaming kata-analyze, undo, kata-raw-nn,
     showboard, a genmove under time_settings 60 5 1 held to the
     recommended time plus the lag buffer plus 2 s, a ponder turn, and a
     second session through gtp.main with a config file that sets
     rootNumSymmetriesToSample = 4): every response "=", every move
     legal, both kernels launched, kata-raw-nn equal on the CPU within
     RAW_NN_ATOL; prints load, forward, playout and command times and the
     launches per genmove; then both kernels timed at the one-game shape;
 10. the analysis engine (`run_analysis_phase`) on the same file:
     run_protocol on 4 queries at ANALYSIS_VISITS (a 3-turn analyzeTurns
     game, avoidMoves with every include flag, reportDuringSearchEvery,
     and the first query again, which must hit the tree cache and run no
     playouts): every final response has rootInfo and moveInfos and root
     visits maxVisits; prints seconds per query;
 11. humanSL serving (`run_humansl_phase`): b18c384nbt with the metadata
     encoder (the public b18c384nbt-humanv0's shape), seeded, exported
     to .bin.gz by the port and served by the GTP engine (desc.load_model,
     DescNet float32) with humanSLProfile = rank_5d: genmoves at
     GTP_VISITS, kata-raw-human-nn equal on the card and the CPU within
     RAW_NN_ATOL, a genmove with avoidRepeatedPatternUtility (the pattern
     table probed in the tree), one playout at one game timed, and one
     get_model_outputs of humanslnet_server; both kernels launched;
 12. the transformer family (`run_transformer_phase`) at
     b5c384h6nbttfgabs: forward in bf16 at batch 128; play_games in bf16
     on 128 games with ladders and tree reuse at SP_VISITS for TF_MOVES
     moves, each a full recorded search (the shard in the pinned schema,
     both kernels launched);
     run_training on that shard in float32 at batch 256 (one warm-up
     step, TF_TRAIN_STEPS timed), losses finite, peak memory; one SGD
     step of a small nbttf-GAB net with QK-norm GQA and an intermediate
     head on the card and the CPU within CHECK_LOSS_RTOL /
     CHECK_UPDATE_REL;
 13. the other families (`run_families_phase`): b28c512nbt in bf16,
     forward at batch 128 and a 128-game search at B28_VISITS visits with
     ladders on (both kernels launched); b7c96h3tfrs exported as a v17
     .bin.gz, loaded by DescNet, kata-raw-nn equal on the card and the
     CPU within RAW_NN_ATOL;
 14. the match and the gatekeeper (`run_match_phase`): play_match at
     19x19 in float32 with ladders on, phase 7's trained b18c384nbt
     against the seeded net it started from, MATCH_GAMES games of
     MATCH_MOVES moves at MATCH_VISITS visits (each move both bots
     search every game): the record adds up, Elo finite, both kernels
     launched; then run_gatekeeper at 5x5 with a seeded champion in
     models/ and phase 7's export as the candidate (2 games at 4
     visits): it plays a match and moves the candidate;
 15. one cycle of the training loop (`run_loop_phase`): run_loop (sync)
     at 7x7 with b18c384nbt, a seeded champion in models/, so selfplay,
     shuffle, training and the gatekeeper's match all run; the shards,
     the checkpoint and the moved candidate checked, seconds and
     launches per stage;
 16. the tools (`run_tools_phase`) through their mains: benchmark_cmd's
     games-per-batch sweep and -train, genconfig_cmd -benchmark on
     phase 7's .bin.gz with its config loaded by gtp -config for a
     genmove, forward_cmd on phase 6's first game on the card and the
     CPU (every number within RAW_NN_ATOL), evalsgf, play_cmd with
     scripted input, checkpoint_tools show and clean -bin-gz (the
     cleaned .bin.gz through check_desc_net);
 17. the SGF tools (`run_sgftools_phase`) on phase 6's games and phase
     7's .bin.gz (DescNet): summarize_sgfs, startposes, samplesgfs viewed
     by viewstartposes, writetrainingdata read back in the pinned npz
     schema, dataminesgfs (game mode, visits cut to DATAMINE_VISITS) and
     checksgfhintpolicy; seconds and launches per command;
 18. genposes and genboard (`run_genposes_phase`): GENPOSES_N clumpy
     19x19 positions scored by phase 7's .bin.gz; genboard_cmd train at
     its defaults for GENBOARD_STEPS steps (its SGF replays on the card),
     run on a 19x19 board, the GenBoard forward on the card and the CPU
     within GENBOARD_ATOL;
 19. the book (`run_book_phase`): genbook at 19x19 on phase 7's .bin.gz,
     BOOK_ROUNDS rounds of BOOK_NODES nodes (searches without ladder
     planes: K2 only), the saved book loaded back equal, booktoposes
     (its replays on the card), findbookbottlenecks and the HTML;
 20. contribute (`run_contribute_phase`): one task against a stub server
     on 127.0.0.1 serving phase 7's .bin.gz with its sha256: download,
     verify, selfplay cut to CONTRIB_MOVES moves, upload; the server
     holds the npz to the pinned schema;
 21. data parallelism and the fused actor-learner (`run_parallel_phase`):
     train_cmd -multi-host at world size 1 on NCCL against the plain
     train_cmd step; play_games(mesh=...) at world size 1; the fused
     actor-learner at bench.py main_fused's shape (128 games, bf16,
     2 moves a chunk, learner batch 64) with visits cut to FUSED_VISITS:
     env-steps/s, playouts/s, the ring's filled, finite losses;
 22. the fused step across ranks, the JAX import and the host libraries
     (`run_slice9_phase`): the fused step at phase 21's shape with a mesh
     at world size 1 on NCCL against the plain step on the same draws
     (ring rows, cursor and filled exactly, loss within
     FUSED22_LOSS_RTOL, parameters within FUSED22_UPDATE_REL of the
     largest update, both launching K1 and K2); a small JAX checkpoint
     (tests/data/torch_ref/jax_ckpt.npz, b1c6 at 5x5: the card machine
     has no JAX) imported by checkpoint_tools_cmd import-jax and resumed
     by train_cmd for one step in float32, within JAX_IMPORT_ATOL of the
     JAX step; the C++ SGF scanner over phase 17's records equal to the
     parser (summarize_sgfs too) and the symmetry transforms of phase
     7's batch equal to numpy, each timed beside its plain version;
 23. report: the card's name and power limit, each kernel's time beside
     its plain version's and its bound, launches per search, per
     selfplay move, per GTP session, per analysis session, per humanSL
     genmove, per transformer selfplay move, per b28c512nbt search, per
     match move, per gatekeeper, per loop cycle, in the tools, per
     datamine, per writetrainingdata, per genposes batch, per genboard
     train, per book round, per booktoposes,
     per contribute task, per mesh play_games, per fused step and per
     mesh fused step, playouts/s, a `kernels` JSON line, and the result
     line last.

A kernel's time ("device-only") is that of N launches captured in one
CUDA graph and replayed, timed with CUDA events, over N: the device's
time alone, with no host work between launches. The wrapper's host cost
is printed on its own line: a host clock over N calls with no sync in
the loop. The plain version's time is CUDA events around one call.

--baseline DIR builds DIR/labels.cu and DIR/chase.cu (the kernels' first
design, commit 5f55cfa, with its C interface; copy them from git history
into a git-ignored directory, never commit them) into DIR, holds them
against the plain versions too and times each old kernel and the current
one in turns (old, new, new, old) on the same inputs; it then stops
after phase 3 and prints no result line.

Weights are random (seeded); the bound of a kernel is the larger of the
bytes its function needs (each input it must read, read once; each output
written once) over 3.35 TB/s and a lower bound of its integer operations
over 67 Tops/s (the H100 SXM's non-tensor 32-bit rate).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

SIZE = 19
GAMES = 128
VISITS = 600
CHUNK = 200
MODEL = "b18c384nbt"
SEED = 0
SP_VISITS = 32
SP_MOVES = 16
TRAIN_BATCH = 256           # the reference's training batch size
TRAIN_WARMUP = 2
TRAIN_STEPS = 10
MUON_STEPS = 2
TRAIN_LR = 6e-5
CHECK_MODEL = "b6c96"       # the same block kinds, small enough for the CPU
CHECK_BATCH = 16
CHECK_LOSS_RTOL = 1e-4      # loss terms and gnorm, card vs CPU
CHECK_UPDATE_REL = 1e-3     # updates, of each tensor's largest update
P8_MOVES = 2
GTP_VISITS = 64             # phase 9's genmoves (the time limit)
ANALYSIS_VISITS = 32        # phase 10's queries
DESC_POSITIONS = 8
DESC_RTOL = 1e-3            # DescNet vs KataGoModel, relative per key
RAW_NN_ATOL = 1e-5          # card vs CPU raw nn: ten quanta of its %.6f
F32_FLOPS_PER_S = 67e12     # H100 SXM float32 peak outside the tensor cores
HUMANSL_PROFILE = "rank_5d"  # phase 11: b18c384nbt + the metadata encoder
PATTERN_UTILITY = 0.3        # phase 11's avoidRepeatedPatternUtility genmove
TF_MODEL = "b5c384h6nbttfgabs"   # phase 12: the largest transformer preset
TF_MOVES = 3                 # phase 12's selfplay moves (the time limit)
TF_TRAIN_STEPS = 3           # phase 12's timed train steps (after one warm-up)
# phase 12's card-vs-CPU step: a small nbttf-GAB net with QK-norm GQA and a
# mid-trunk intermediate head (ModelConfig fields over TF_MODEL's)
TF_CHECK_FIELDS = dict(
    name="nbttf-gab-check", trunk_num_channels=32, mid_num_channels=16,
    gpool_num_channels=8, transformer_ffn_channels=32, transformer_heads=2,
    transformer_kv_heads=1, attention_qk_norm=True, gab_num_templates=8,
    gab_num_fourier_features=4, gab_mlp_hidden=16, gab_d1=8, gab_d2=8,
    has_intermediate_head=True, intermediate_head_blocks=1,
    block_kind=("bottlenest2transformergabsg", "regulargpool", "attnrope",
                "ffnsg"),
    p1_num_channels=8, g1_num_channels=8, v1_num_channels=8, v2_size=16,
    sbv2_num_channels=16, num_scorebeliefs=2)
B28_MODEL = "b28c512nbt"     # phase 13: the kata1 main-run shape
B28_VISITS = 32              # phase 13's search (a few dozen visits)
V17_MODEL = "b7c96h3tfrs"    # phase 13: exported as v17, served by DescNet
MATCH_GAMES = 16             # phase 14: the match (trained vs seeded)
MATCH_VISITS = 16
MATCH_MOVES = 4              # max_moves: the games are cut (time limit)
GATE_SIZE = 5                # phase 14's gatekeeper: one candidate
GATE_GAMES = 2
GATE_VISITS = 4
GATE_MOVES = 4               # max_moves of its match (time limit)
LOOP_SIZE = 7                # phase 15: one cycle (the JAX loop's -size)
LOOP_GAMES = 8
LOOP_VISITS = 4
LOOP_TRAIN_STEPS = 2
LOOP_BATCH = 64
LOOP_GATE_GAMES = 2
LOOP_MOVES = 8               # max_moves of its games (time limit)
BENCH_BATCHES = "1,32,128"   # phase 16: benchmark_cmd's sweep
BENCH_VISITS = 16
BENCH_TRAIN_BATCH = 256      # benchmark_cmd -train (float32)
BENCH_TRAIN_STEPS = 3
TOOLS_TURN = 10              # forward_cmd / evalsgf position in phase 6's game
EVALSGF_VISITS = 32
PLAY_VISITS = 16
SGF17_RECORDS = 16           # phase 17: phase 6's first records as .sgf files
SGF17_GAMES = 8              # and random legal games (phase 6's records hold
SGF17_MOVES = 48             # its recorded moves only: a few a game)
SGF17_SAMPLE_PROB = 0.1      # startposes' and samplesgfs' sampling
DATAMINE_VISITS = 16         # phase 17's dataminesgfs (default 300), /5, /25
DATAMINE_MIN_TURN = 36
WTD_MAX_ROWS = 128           # phase 17's writetrainingdata rows
GENPOSES_N = 128             # phase 18: genposes positions (clumpy)
GENBOARD_STEPS = 2           # phase 18: genboard train steps at its defaults
GENBOARD_ATOL = 1e-4         # GenBoard forward, card vs CPU (float32, no TF32)
BOOK_ROUNDS = 3              # phase 19: gen_book rounds of BOOK_NODES nodes
BOOK_NODES = 8
BOOK_VISITS = 16
CONTRIB_GAMES = 8            # phase 20: one contribute task
CONTRIB_VISITS = 8
CONTRIB_MOVES = 4            # max_moves of its games (the time limit)
MESH_GAMES = 16              # phase 21: play_games(mesh=...) at world size 1
MESH_VISITS = 8
MESH_MOVES = 2
FUSED_GAMES = 128            # phase 21: bench.py main_fused's shape
FUSED_MOVES = 2              # moves a chunk
FUSED_BATCH = 64             # learner batch
FUSED_VISITS = 32            # cut from 600
FUSED22_LOSS_RTOL = 1e-6     # phase 22: the mesh step vs the plain step
FUSED22_UPDATE_REL = 1e-6    # of the largest update
JAX_IMPORT_ATOL = 1e-5       # phase 22: the imported run's step vs JAX's
SCAN_REPEATS = 5             # phase 22: timed passes over the records
SYM_REPEATS = 5              # and over the 7 symmetries of the batch
REF_DIR = Path(__file__).resolve().parent / "tests" / "data" / "torch_ref"
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12

# The C interface of the kernels' first design, for --baseline.
_P = ctypes.c_void_p
_I = ctypes.c_int
OLD_SIGNATURES = {
    "labels": {"connected_labels_launch": [_P, _P, _I, _I, _P]},
    "chase": {"chase_lanes_launch": [_P] * 8 + [_I] * 3 + [_P]},
}


def build_everything() -> tuple[float, float]:
    """Both CUDA kernels (nvcc) and both C++ host libraries (g++), every
    source compiled at once; (kernel seconds, host seconds)."""
    import concurrent.futures

    from katago_torch.ops import _build, _hostbuild
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        kernels = ex.submit(_build.build_all)
        host = ex.submit(_hostbuild.build_all)
        return kernels.result(), host.result()


def log(*a):
    print(*a, flush=True)


def event_ms(fn, reps):
    """Median of per-call CUDA-event times around fn (after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def device_ms(fn, n, reps=5):
    """Device-only ms per launch: n calls of fn (which must launch the
    kernel and nothing else) captured in one CUDA graph; the median over
    reps replays of the replay's event time over n."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / n)
    return statistics.median(times)


def host_us(fn, n):
    """Host microseconds per call of fn: a host clock over n calls with
    no sync inside the loop."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def in_turns(old, new, n):
    """Device-only ms of the old and the new launch, timed old, new,
    new, old; returns ([old, old], [new, new])."""
    t = [device_ms(f, n) for f in (old, new, new, old)]
    return [t[0], t[3]], [t[1], t[2]]


def build_baseline(src_dir: Path):
    """Build src_dir/{labels,chase}.cu with the port's nvcc flags (one
    nvcc each, in parallel) into src_dir and load them with the first
    design's C interface; returns ({name: library}, wall seconds)."""
    from katago_torch.ops import _build
    t0 = time.time()
    procs = {n: subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(src_dir / f"lib{n}.so"),
         str(src_dir / f"{n}.cu")], stderr=subprocess.PIPE, text=True)
        for n in OLD_SIGNATURES}
    for n, proc in procs.items():
        err = proc.communicate()[1]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {src_dir / n}.cu:\n{err}")
    libs = {n: _build.bind(src_dir / f"lib{n}.so", sig)
            for n, sig in OLD_SIGNATURES.items()}
    return libs, time.time() - t0


def old_labels(lib, vals):
    """The first design's K2 on vals: (launch closure, output tensor)."""
    out = torch.empty_like(vals)
    fn = lib.connected_labels_launch

    def launch():
        rc = fn(vals.data_ptr(), out.data_ptr(), vals.shape[0], SIZE,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"old connected_labels failed: {rc}")
    return launch, out


def old_chase(lib, args, steps):
    """The first design's K1 on the lanes args: (launch closure, int8 output)."""
    stones, labels, hlibs, rep, dfn, pre, active = args
    act = active.to(torch.int8)
    out = torch.empty((stones.shape[0],), dtype=torch.int8,
                      device=stones.device)
    tensors = (stones, labels, hlibs, rep, dfn, pre, act, out)
    fn = lib.chase_lanes_launch

    def launch():
        rc = fn(*[t.data_ptr() for t in tensors], stones.shape[0], SIZE,
                steps, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"old chase_lanes failed: {rc}")
    return launch, out


def check_exact_ladders(dev) -> None:
    """The exact ladder solver on the card against the JAX package's
    ladder_map on the boards of tests/data/torch_ref/ladder_exact.npz
    (every set, the reduced-cap sets included): bit for bit."""
    import numpy as np

    from katago_torch.game import ladder as LAD

    with np.load(REF_DIR / "ladder_exact.npz") as z:
        ref = {k: z[k] for k in z.files}
    meta = json.loads(str(ref["meta"]))
    boards = 0
    for name, m in sorted(meta["sets"].items()):
        got = LAD.ladder_map_batch(
            torch.from_numpy(ref[f"{name}/stones"]).to(dev), m["size"],
            ko_loc=torch.from_numpy(ref[f"{name}/ko"]).long().to(dev),
            **m["ladder_map_kwargs"])
        for f in ("laddered", "working_vs_black", "working_vs_white"):
            if not np.array_equal(getattr(got, f).cpu().numpy(),
                                  ref[f"{name}/{f}"]):
                raise AssertionError(f"exact ladders on the card differ "
                                     f"from the JAX fixture: {name} {f}")
        boards += m["boards"]
    log(f"phase exact ladders: equal to the JAX fixture on {boards} boards "
        f"({len(meta['sets'])} sets)")


def run_selfplay_phase(model, gen, dev, work: Path, moves: int = SP_MOVES,
                       tdata_name: str = "tdata", tag: str = "selfplay",
                       play_settings=None) -> dict:
    """Selfplay at the production shape: play_games at 19x19 with the
    b18c384nbt net in bf16, 128 games, SearchParams.for_selfplay(),
    PlaySettings.for_selfplay() (policy-init openings, cheap/full
    mixing, komi randomization), tree reuse on, ladder planes on (the
    chase in the search, the exact solver for the recorded rows). Two
    cuts, both for the time limit: SP_VISITS = 32 visits per move
    (selfplay uses 600) and SP_MOVES = 16 moves per game (games are not
    played to the end). The shard and the sgfs go through the port's
    writers into work/tdata (phase 7 trains on it) and are read back:
    keys, dtypes and per-row shapes equal the schema pinned by the CPU
    fixture, rows > 0, policy targets sum to 1, every float is finite,
    and both kernels were launched during the games. Returns the phase's
    numbers. moves, tdata_name, tag and play_settings: another path's
    cut, shard directory, log label and PlaySettings (phase 12)."""
    import numpy as np

    from katago_torch.cli.selfplay_cmd import game_records
    from katago_torch.ops import chase as K1
    from katago_torch.ops import labels as K2
    from katago_torch.search.params import SearchParams
    from katago_torch.selfplay.loop import play_games
    from katago_torch.selfplay.playsettings import PlaySettings

    schema = json.loads((REF_DIR / "npz_schema.json").read_text())[
        "per_row"][str(SIZE)]
    timings = {}
    K1.reset_launches()
    K2.reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    data, stats = play_games(
        model, size=SIZE, num_games=GAMES, visits=SP_VISITS,
        search_params=SearchParams.for_selfplay(), max_moves=moves,
        gen=gen, device=dev, tree_reuse=True,
        play_settings=play_settings or PlaySettings.for_selfplay(),
        ladder_mode="chase",
        timings=timings)
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = {"chase_lanes": K1.launches, "connected_labels": K2.launches}
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched by {tag}")
    rows = data.spatial.shape[0]
    if rows == 0:
        raise AssertionError(f"{tag} recorded no rows")
    pol_sum = data.policy_target.sum(1)
    if not np.allclose(pol_sum, 1.0, atol=1e-5):
        raise AssertionError(f"policy targets sum to {pol_sum.min()}.."
                             f"{pol_sum.max()}, not 1")
    arrays = data.to_npz_arrays(SIZE, stats["white_minus_black"],
                                komi_white=stats["komi_white"])
    tdata = work / tdata_name
    tdata.mkdir(parents=True)
    shard = tdata / f"batch000000_{SEED}_s{SIZE}.npz"
    np.savez_compressed(shard, **arrays)
    sgfs = work / f"{tdata_name}_batch000000_{SEED}.sgfs"
    sgfs.write_text("\n".join(game_records(data, stats, SIZE, GAMES,
                                            None)) + "\n")
    npz_bytes, sgf_bytes = shard.stat().st_size, sgfs.stat().st_size
    with np.load(shard) as z:
        back = {k: z[k] for k in z.files}
    if sorted(back) != sorted(schema):
        raise AssertionError(f"npz keys {sorted(back)} != {sorted(schema)}")
    for k, (dtype, shape) in schema.items():
        if str(back[k].dtype) != dtype or list(back[k].shape) != \
                [rows] + shape:
            raise AssertionError(f"npz {k}: {back[k].dtype} "
                                 f"{back[k].shape}, want {dtype} {shape}")
        if back[k].dtype.kind == "f" and not np.isfinite(back[k]).all():
            raise AssertionError(f"npz {k} is not finite")
    for f in ("spatial", "global_in", "policy_target", "value_target",
              "mcts_winloss_white", "q_winloss_white", "policy_prior"):
        if not np.isfinite(getattr(data, f)).all():
            raise AssertionError(f"row field {f} is not finite")
    moves = timings["moves"]
    rec = timings.get("recorded_moves", 0)
    lad = timings["ladder"]
    out = {"seconds": dt, "moves": moves, "recorded_moves": rec,
           "rows": rows, "npz_bytes": npz_bytes, "sgf_bytes": sgf_bytes,
           "playouts": stats["total_playouts"],
           "playouts_per_s": stats["total_playouts"] / dt,
           "launches": launches,
           "s_per_move": {k: timings.get(k + "_s", 0.0) / moves
                          for k in ("search", "choose", "step")},
           "features_s_per_recorded_move":
               timings.get("features_s", 0.0) / max(rec, 1),
           "ladder": lad,
           "ladder_ms_per_call": lad["seconds"] / lad["calls"] * 1e3}
    log(f"phase {tag}: {GAMES} games x {moves} moves ({rec} recorded) "
        f"at {SP_VISITS} visits in {dt:.2f} s; {stats['total_playouts']} "
        f"playouts ({out['playouts_per_s']:.1f} playouts/s); {rows} rows, "
        f"npz {npz_bytes} B, sgfs {sgf_bytes} B; launches {launches} "
        f"({launches['chase_lanes'] / moves:.1f} K1 and "
        f"{launches['connected_labels'] / moves:.1f} K2 per move)")
    log(f"{tag} s/move: search {out['s_per_move']['search']:.3f}, move "
        f"choice {out['s_per_move']['choose']:.3f}, board step "
        f"{out['s_per_move']['step']:.3f}; row featurization "
        f"{out['features_s_per_recorded_move']:.3f} s per recorded move")
    log(f"{tag} exact ladders: {lad['calls']} ladder_map_batch calls, "
        f"{out['ladder_ms_per_call']:.1f} host ms per call, {lad['lanes']} "
        f"lanes, longest lane {lad['max_lane_iters']} iterations, "
        f"{lad['lockstep_iters']} lockstep iterations, unfinished "
        f"{lad['unfinished_lanes']}, depth hits {lad['depth_hits']}")
    log(f"{tag} json " + json.dumps(
        dict(out, ladder={k: v for k, v in lad.items()
                          if k != "longest_lane"})))
    if "longest_lane" in lad:
        log(f"{tag} longest exact lane " + json.dumps(
            lad["longest_lane"]))
    return out


def smi_query(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()


def forward_flops(model, size: int, batch: int, dev) -> float:
    """Multiply-add FLOPs (2 per MAC) of one forward of model at batch,
    reckoned from the shapes its convolutions, dense layers and attention
    matmuls see (one forward at batch 1, scaled: every layer is linear in
    the batch)."""
    from katago_torch.models import model as M
    flops = [0.0]

    def conv_hook(mod, args, out):
        k = mod.kernel.shape
        flops[0] += 2.0 * out.numel() * k[1] * k[2] * k[3]

    def dense_hook(mod, args, out):
        flops[0] += 2.0 * out.numel() * mod.kernel.shape[1]

    def attention_hook(mod, args, out):
        b, c, h, w = out.shape      # QK^T and attention x V
        flops[0] += 2.0 * 2.0 * b * mod.nh * (h * w) ** 2 * mod.qd

    hooks = [m.register_forward_hook(conv_hook if isinstance(m, M.ConvCore)
                                     else dense_hook)
             for m in model.modules()
             if isinstance(m, (M.ConvCore, M.Dense))]
    hooks += [m.register_forward_hook(attention_hook)
              for m in model.modules()
              if isinstance(m, M.TransformerAttentionBlock)]
    spatial = torch.ones((1, size, size, 22), device=dev)
    with torch.no_grad():
        model(spatial, torch.zeros((1, 19), device=dev))
    for h in hooks:
        h.remove()
    return flops[0] * batch


def check_step_card_vs_cpu(shard: Path, dev, cfg=None) -> dict:
    """One SGD step of CHECK_MODEL (or the ModelConfig cfg; float32, TF32
    off) at CHECK_BATCH rows of the shard, on the card and on the CPU
    from the same weights: every
    loss term and gnorm within CHECK_LOSS_RTOL, each tensor's update (new
    minus old params) within CHECK_UPDATE_REL of its largest entry plus
    1e-6 of the largest update of the net (the floor covers tensors whose
    gradient is rounding noise, such as the score-belief mixture bias).
    Reports the worst update error relative to its tensor's largest entry
    over the tensors whose updates reach 1e-3 of the net's largest, and
    the worst error as a fraction of its limit."""
    from katago_torch.cli.train_cmd import make_model
    from katago_torch.dataio import trainingwrite as TW
    from katago_torch.models import model as M
    from katago_torch.models import weights as W
    from katago_torch.train import train_step as TS

    rows = {k: torch.from_numpy(v[:CHECK_BATCH])
            for k, v in TW.read_npz(str(shard), SIZE).items()}
    out = {}
    for where in ("card", "cpu"):
        d = dev if where == "card" else torch.device("cpu")
        if cfg is None:
            model = make_model(SIZE, CHECK_MODEL, d, seed=SEED)
        else:
            model = W.init_weights(M.KataGoModel(cfg, SIZE, torch.float32),
                                   seed=SEED).to(d)
        params = {k: v.detach() for k, v in model.named_parameters()}
        opt = TS.make_optimizer(lr=0.01, kind="sgd")
        state = TS.init_train_state(params, opt)
        new, metrics = TS.make_train_step(model, opt)(
            state, {k: v.to(d) for k, v in rows.items()})
        out[where] = ({k: float(v) for k, v in metrics.items()},
                      {k: (new.params[k] - state.params[k]).cpu()
                       for k in params})
    (m_gpu, u_gpu), (m_cpu, u_cpu) = out["card"], out["cpu"]
    loss_err = max(abs(m_gpu[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-5)
                   for k in m_cpu)
    for k in m_cpu:
        if not abs(m_gpu[k] - m_cpu[k]) <= CHECK_LOSS_RTOL * abs(m_cpu[k]) \
                + 1e-5:
            raise AssertionError(f"card vs CPU: {k} {m_gpu[k]} vs "
                                 f"{m_cpu[k]}")
    net_max = max(float(u.abs().max()) for u in u_cpu.values())
    upd_err, worst = 0.0, 0.0
    for k, u in u_cpu.items():
        err = float((u_gpu[k] - u).abs().max())
        scale = float(u.abs().max())
        limit = CHECK_UPDATE_REL * scale + 1e-6 * net_max
        worst = max(worst, err / limit)
        if scale >= 1e-3 * net_max:
            upd_err = max(upd_err, err / scale)
        if err > limit:
            raise AssertionError(f"card vs CPU: update of {k} differs by "
                                 f"{err} (largest entry {scale})")
    return {"loss_max_rel_err": loss_err, "update_max_rel_err": upd_err,
            "update_worst_of_limit": worst, "loss": m_gpu["loss"],
            "gnorm": m_gpu["gnorm"]}


def run_train_phase(work: Path, dev) -> dict:
    """Phase 7 (see the module docstring): run_training at b18c384nbt,
    float32, batch TRAIN_BATCH on phase 6's shard; returns the numbers."""
    import gzip

    from katago_torch.cli import train_cmd as TCMD
    from katago_torch.models import config as MC
    from katago_torch.train import checkpoint as C
    from katago_torch.train import train_step as TS

    data, ckpt, export = work / "tdata", work / "ckpt", work / "export"
    shard = next(data.glob("*.npz"))
    lines = []
    common = dict(size=SIZE, config_name=MODEL, batch_size=TRAIN_BATCH,
                  lr=TRAIN_LR, seed=SEED, device=dev, log=lines.append)
    with TS.float32_precision():
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
    log(f"phase train: {MODEL} float32, batch {TRAIN_BATCH}; inside the "
        f"step allow_tf32 matmul={tf32[0]} cudnn={tf32[1]}")

    def finite(out, what):
        for i, m in enumerate(out["metrics"]):
            bad = [k for k, v in m.items() if not math.isfinite(v)]
            if bad:
                raise AssertionError(f"{what} step {i}: {bad} not finite")

    t0 = time.time()
    warm = TCMD.run_training(str(data), str(ckpt), None, steps=TRAIN_WARMUP,
                             **common)
    finite(warm, "warm-up")
    warm_s = time.time() - t0
    timings = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    out = TCMD.run_training(str(data), str(ckpt), str(export),
                            steps=TRAIN_STEPS, timings=timings, **common)
    run_s = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    clocks = smi_query("name,power.limit,power.draw,clocks.sm,clocks.max.sm,"
                       "temperature.gpu")
    finite(out, "sgd")
    if out["steps"] != TRAIN_STEPS or len(out["metrics"]) != TRAIN_STEPS:
        raise AssertionError(f"trained {out['steps']} steps, logged "
                             f"{len(out['metrics'])}")
    if not any(line.startswith("resumed from") for line in lines):
        raise AssertionError("the timed run did not resume the warm-up's "
                             "checkpoint")

    # checkpoint: restored, saved again and restored equal; the export is
    # the restored EMA; the reference .bin.gz is written
    cfg = MC.get_config(MODEL)
    model = TCMD.make_model(SIZE, MODEL, dev, SEED)
    template = TS.init_train_state(dict(model.named_parameters()),
                                   TS.make_optimizer(kind="sgd"))
    latest = C.latest_checkpoint(str(ckpt))
    state = C.restore_checkpoint(latest, template)
    again = C.restore_checkpoint(C.save_checkpoint(
        str(work / "ckpt2"), state, state.step), template)
    total = TRAIN_WARMUP + TRAIN_STEPS
    if state.step != total or state.opt_state["count"] != total:
        raise AssertionError(f"restored step {state.step}, count "
                             f"{state.opt_state['count']}, want {total}")

    def same(a, b):
        if isinstance(a, dict):
            return sorted(a) == sorted(b) and all(same(a[k], b[k])
                                                  for k in a)
        if isinstance(a, torch.Tensor):
            return torch.equal(a, b)
        return a == b
    for f in ("params", "opt_state", "ema_params", "swa_params", "step"):
        if not same(getattr(state, f), getattr(again, f)):
            raise AssertionError(f"checkpoint round trip changed {f}")
    exported = C.load_params(out["export"], state.params)
    if not same(exported, state.ema_params):
        raise AssertionError("the export is not the checkpoint's EMA")
    for t in state.params.values():
        if not torch.isfinite(t).all():
            raise AssertionError("a trained parameter is not finite")
    t0 = time.time()
    bin_gz = Path(C.export_bin_gz(str(export), Path(out["export"]).name,
                                  state.ema_params, cfg))
    bin_s = time.time() - t0
    with gzip.open(bin_gz, "rb") as f:
        head = f.read(64).split(b"\n")
    if head[0].decode() != Path(out["export"]).name or head[1] != b"15":
        raise AssertionError(f"bad .bin.gz header {head[:2]}")

    t0 = time.time()
    muon = TCMD.run_training(str(data), str(work / "ckpt_muon"), None,
                             steps=MUON_STEPS, optimizer_kind="normuon",
                             **common)
    muon_s = time.time() - t0
    finite(muon, "normuon")

    t0 = time.time()
    check = check_step_card_vs_cpu(shard, dev)
    check_s = time.time() - t0

    steps = out["steps"]
    ms = {k: timings[k] / steps * 1e3
          for k in ("data_s", "h2d_s", "fwd_bwd_s", "opt_s")}
    step_ms = sum(ms.values())
    flops = 3.0 * forward_flops(model, SIZE, TRAIN_BATCH, dev)
    res = {"steps": steps, "batch": TRAIN_BATCH, "model": MODEL,
           "ms_per_step": ms, "step_ms": step_ms,
           "rows_per_s_steps": TRAIN_BATCH / step_ms * 1e3,
           "rows_per_s_run": out["rows_per_s"],
           "peak_mem_bytes": peak, "train_flops_per_step": flops,
           "fwd_bwd_tflops": flops / (ms["fwd_bwd_s"] / 1e3) / 1e12,
           "f32_peak_share": flops / (ms["fwd_bwd_s"] / 1e3)
           / F32_FLOPS_PER_S,
           "first_loss": out["first_loss"], "final_loss": out["final_loss"],
           "muon_losses": [m["loss"] for m in muon["metrics"]],
           "warmup_s": warm_s, "run_s": run_s, "muon_s": muon_s,
           "bin_gz_s": bin_s,
           "bin_gz_bytes": bin_gz.stat().st_size,
           "card_vs_cpu": check, "card_vs_cpu_s": check_s,
           "tf32": {"matmul": tf32[0], "cudnn": tf32[1]}, "smi": clocks}
    log(f"phase train: {steps} steps resumed at step {TRAIN_WARMUP}; ms per "
        f"step: data {ms['data_s']:.2f}, host-to-device {ms['h2d_s']:.2f}, "
        f"forward+backward {ms['fwd_bwd_s']:.2f}, optimizer+EMA "
        f"{ms['opt_s']:.2f} (sum {step_ms:.2f}); "
        f"{res['rows_per_s_steps']:.1f} rows/s over the steps, "
        f"{out['rows_per_s']:.1f} over the run (checkpoint and export "
        f"included); peak device memory {peak / 2**30:.2f} GiB")
    log(f"phase train: {flops / 1e12:.3f} TFLOP per step (3x the forward's "
        f"{flops / 3e12:.3f}, reckoned from the shapes); forward+backward "
        f"at {res['fwd_bwd_tflops']:.2f} TFLOP/s, "
        f"{100 * res['f32_peak_share']:.1f}% of the 67 TFLOP/s float32 "
        f"peak; loss {out['first_loss']:.4f} -> {out['final_loss']:.4f}; "
        f"normuon losses {res['muon_losses']}")
    log(f"phase train: checkpoint round trip equal, export equal to the "
        f"EMA, {bin_gz.name} {res['bin_gz_bytes']} B in {bin_s:.1f} s; "
        f"card vs CPU ({CHECK_MODEL}, batch {CHECK_BATCH}): loss terms "
        f"within {check['loss_max_rel_err']:.2e} relative (limit "
        f"{CHECK_LOSS_RTOL}), updates within "
        f"{check['update_max_rel_err']:.2e} of their tensor's largest "
        f"(limit {CHECK_UPDATE_REL}; worst error "
        f"{check['update_worst_of_limit']:.3f} of its limit)")
    log(f"phase train card: {clocks} (name, power limit, draw, SM clock, "
        f"max SM clock, temperature)")
    log("train json " + json.dumps(res))
    res["bin_gz"], res["export"] = str(bin_gz), out["export"]
    return res


def run_models_dir_phase(work: Path, dev) -> dict:
    """Phase 8: selfplay from phase 7's export through run_selfplay's
    -models-dir; the output is named after the newest export."""
    import numpy as np

    from katago_torch.cli.selfplay_cmd import run_selfplay
    from katago_torch.train import checkpoint as C

    latest = C.find_latest_model(str(work / "export"))
    out_dir = work / "selfplay_from_export"
    lines = []
    t0 = time.time()
    totals = run_selfplay(str(out_dir), str(work / "export"), size=SIZE,
                          games_per_batch=GAMES, visits=SP_VISITS,
                          max_batches=1, config_name=MODEL,
                          data_quality="test", device=dev,
                          dtype=torch.bfloat16, max_moves=P8_MOVES,
                          log=lines.append)
    torch.cuda.synchronize()
    dt = time.time() - t0
    shard = out_dir / Path(latest).name / "tdata" / \
        f"batch000000_0_s{SIZE}.npz"
    with np.load(shard) as z:
        rows = z["globalInputNC"].shape[0]
    if rows == 0 or rows != totals["rows"]:
        raise AssertionError(f"selfplay from the export wrote {rows} rows, "
                             f"reported {totals['rows']}")
    log(f"phase selfplay from export: model {Path(latest).name}, {GAMES} "
        f"games x {P8_MOVES} moves at {SP_VISITS} visits in {dt:.2f} s, "
        f"{rows} rows in {shard.relative_to(work)}")
    return {"seconds": dt, "rows": rows, "model": Path(latest).name}


def check_desc_net(bin_gz: str, export: str, shard: Path, dev) -> dict:
    """DescNet on the exported .bin.gz against KataGoModel on the EMA
    weights that were exported, float32 with TF32 off, on DESC_POSITIONS
    positions of phase 6's shard: the largest relative difference of
    each output key (the policy's play and short-term optimistic
    channels, the value, score and error channels, ownership)."""
    from katago_torch.cli import train_cmd as TCMD
    from katago_torch.dataio import trainingwrite as TW
    from katago_torch.models import desc as D
    from katago_torch.train import checkpoint as CK
    from katago_torch.train import train_step as TS

    t0 = time.time()
    desc = D.load_model(bin_gz)
    load_s = time.time() - t0
    net = D.DescNet(desc).to(dev).eval()
    model = TCMD.make_model(SIZE, MODEL, dev, SEED)
    model.load_state_dict(CK.load_params(export, model.state_dict()))
    model.eval()
    rows = TW.read_npz(str(shard), SIZE)
    sp = torch.from_numpy(rows["binaryInputNCHW"][:DESC_POSITIONS]).to(
        dev).permute(0, 2, 3, 1).contiguous()
    gl = torch.from_numpy(rows["globalInputNC"][:DESC_POSITIONS]).to(dev)
    with torch.no_grad(), TS.float32_precision():
        a = model(sp, gl)
        b = net(sp, gl)
    pairs = {"policy_logits": (a["policy_logits"][:, [0, 5]],
                               b["policy_logits"]),
             "value_logits": (a["value_logits"], b["value_logits"]),
             "miscvalue": (a["miscvalue"][:, :4], b["miscvalue"][:, :4]),
             "moremiscvalue": (a["moremiscvalue"][:, :2],
                               b["moremiscvalue"][:, :2]),
             "ownership_pretanh": (a["ownership_pretanh"],
                                   b["ownership_pretanh"])}
    rel = {}
    for k, (x, y) in pairs.items():
        x, y = x.float(), y.float()
        if not torch.isfinite(y).all():
            raise AssertionError(f"DescNet output {k} is not finite")
        rel[k] = float((x - y).abs().max() / x.abs().max().clamp(min=1e-30))
    log(f"phase desc: load_model {desc.name} (version {desc.version}, "
        f"{Path(bin_gz).stat().st_size} B) in {load_s:.2f} s; DescNet vs "
        f"KataGoModel on {DESC_POSITIONS} shard positions, largest relative "
        f"difference per key {json.dumps(rel)} (limit {DESC_RTOL})")
    bad = {k: v for k, v in rel.items() if not v <= DESC_RTOL}
    if bad:
        raise AssertionError(f"DescNet differs from KataGoModel: {bad}")
    return {"load_s": load_s, "rel_err": rel}


class _Lines:
    """GTP input whose reader can be made to wait: yields the script's
    lines, sleeping `idle` seconds before a line "#idle"."""

    def __init__(self, lines, idle=0.0):
        self.lines, self.idle = lines, idle

    def __iter__(self):
        for line in self.lines:
            if line == "#idle":
                time.sleep(self.idle)
                continue
            yield line


def _gtp(engine, lines, idle=0.0) -> list[str]:
    """Run GTP lines through run_gtp; returns the response blocks."""
    import io

    from katago_torch.cli import gtp as G
    out = io.StringIO()
    G.run_gtp(engine, _Lines(lines, idle), out)
    return [b for b in out.getvalue().split("\n\n") if b.strip()]


def _stars() -> list[str]:
    """The four 4-4 points (nearer the edge on small boards) as GTP
    vertices, in the order Q16, D4, Q4, D16."""
    from katago_torch.cli.gtp import loc_to_gtp
    e = 3 if SIZE >= 13 else 2 if SIZE >= 7 else 1
    lo, hi = e, SIZE - 1 - e
    return [loc_to_gtp(y * SIZE + x, SIZE) for x, y in
            ((hi, lo), (lo, hi), (hi, hi), (lo, lo))]


def _raw_nn_numbers(text: str) -> list[float]:
    out = []
    for tok in text.split():
        try:
            out.append(float(tok))
        except ValueError:
            pass
    return out


def run_gtp_phase(bin_gz: str, dev, work: Path) -> dict:
    """Phase 9 (see the module docstring)."""
    import numpy as np

    from katago_torch.cli import gtp as G
    from katago_torch.game import history as H
    from katago_torch.ops import chase as K1
    from katago_torch.ops import labels as K2

    def counts():
        return {"chase_lanes": K1.launches, "connected_labels": K2.launches}

    def ok(blocks, what):
        bad = [b for b in blocks if not b.startswith("=")]
        if bad:
            raise AssertionError(f"GTP {what}: {bad}")

    K1.reset_launches()
    K2.reset_launches()
    t0 = time.time()
    eng = G.GTPEngine(model_path=bin_gz, size=SIZE, visits=GTP_VISITS,
                      device=dev, seed=SEED)
    engine_s = time.time() - t0
    net = eng.net()
    sp1 = torch.zeros((1, SIZE, SIZE, 22), device=dev)
    sp1[..., 0] = 1.0
    gl1 = torch.zeros((1, 19), device=dev)
    with torch.no_grad():
        fwd_ms = event_ms(lambda: net(sp1, gl1), 10)

    s = _stars()
    opening = [f"boardsize {SIZE}", "komi 7.5", "clear_board",
               f"play b {s[0]}", f"play w {s[1]}", f"play b {s[2]}",
               f"play w {s[3]}"]
    ok(_gtp(eng, opening), "opening")
    genmoves = []

    def genmove(color):
        before = H.legal_moves(H.replace_pos(eng.gs, to_move=eng._one(
            1 if color == "b" else 2)), SIZE)[0].cpu().numpy()
        c0 = counts()
        torch.cuda.synchronize()
        t = time.time()
        blocks = _gtp(eng, [f"genmove {color}"])
        torch.cuda.synchronize()
        dt = time.time() - t
        ok(blocks, f"genmove {color}")
        loc = G.gtp_to_loc(blocks[0][2:], SIZE)
        if not before[loc]:
            raise AssertionError(f"genmove {color} chose illegal {loc}")
        c1 = counts()
        genmoves.append({"color": color, "seconds": dt,
                         "move": blocks[0][2:],
                         "visits": int(eng.last_search_result.root_visits[0]),
                         "launches": {k: c1[k] - c0[k] for k in c1}})
        return dt

    genmove("b")
    genmove("w")
    t = time.time()
    an = _gtp(eng, ["kata-analyze interval 0 rootInfo true pvVisits true"])
    analyze_s = time.time() - t
    ok(an, "kata-analyze")
    info_lines = [ln for ln in an[0].splitlines() if ln.startswith("info")]
    if len(info_lines) < 2:
        raise AssertionError(f"kata-analyze streamed {len(info_lines)} "
                             "info lines, want 2")
    ok(_gtp(eng, ["undo"]), "undo")
    t = time.time()
    raw = _gtp(eng, ["kata-raw-nn 0"])
    torch.cuda.synchronize()
    raw_s = time.time() - t
    ok(raw, "kata-raw-nn")
    board = _gtp(eng, ["showboard"])
    ok(board, "showboard")

    # the same position's raw net on the CPU from the same file
    cpu = G.GTPEngine(model_path=bin_gz, size=SIZE, visits=GTP_VISITS,
                      device="cpu", seed=SEED)
    for player, loc in eng.moves:
        cpu.play(player, loc)
    a, b = _raw_nn_numbers(raw[0][1:]), _raw_nn_numbers(cpu.raw_nn())
    if len(a) != len(b) or len(a) != 3 + SIZE * SIZE + 1:
        raise AssertionError(f"kata-raw-nn gave {len(a)} / {len(b)} numbers")
    raw_err = float(np.abs(np.array(a) - np.array(b)).max())
    if raw_err > RAW_NN_ATOL:
        raise AssertionError(f"kata-raw-nn card vs CPU differ by {raw_err}")
    del cpu

    # a genmove under a clock
    ok(_gtp(eng, ["time_settings 60 5 1"]), "time_settings")
    pla = eng.to_move()
    st = eng.stones_np()
    _, rec, _ = eng.time_controls[pla].get_time(
        SIZE * SIZE, int(((st == 1) | (st == 2)).sum()),
        lag_buffer=eng.lag_buffer)
    clock_s = genmove("b" if pla == 1 else "w")
    if clock_s > rec + eng.lag_buffer + 2.0:
        raise AssertionError(f"genmove under time_settings took {clock_s:.2f}"
                             f" s, recommended {rec:.2f} s")
    ok(_gtp(eng, ["kata-time_settings none"]), "kata-time_settings")

    # a ponder turn: genmove, 2 s idle while the ponder searches, stop
    ok(_gtp(eng, ["kata-set-param ponderingEnabled true"]), "ponder on")
    genmove("b" if eng.to_move() == 1 else "w")
    c0 = counts()
    blocks = _gtp(eng, ["#idle", "stop"], idle=2.0)
    ok(blocks, "stop")
    ponder_visits = int(eng._reuse_tree.visits[0, 0])
    if ponder_visits <= 1:
        raise AssertionError(f"the ponder's tree has {ponder_visits} visits")
    c1 = counts()
    ponder_launches = {k: c1[k] - c0[k] for k in c1}
    ok(_gtp(eng, ["kata-set-param ponderingEnabled false", "final_score",
                  "quit"]), "final")

    # one playout at one game: a fresh visit-bounded search
    drv = eng._get_driver()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.synchronize()
    t = time.time()
    res = drv.search(eng.gs, gen, max_visits=GTP_VISITS)
    torch.cuda.synchronize()
    playout_ms = (time.time() - t) / (int(res.root_visits[0]) - 1) * 1e3

    # a second session through main() with a config file
    import io
    cfg = work / "gtp.cfg"
    cfg.write_text(f"maxVisits = {GTP_VISITS // 2}\n"
                   "rootNumSymmetriesToSample = 4\nponderingEnabled = false\n"
                   "numSearchThreads = 8\n")
    out = io.StringIO()
    t = time.time()
    main_eng = G.main(["-model", bin_gz, "-config", str(cfg), "-boardsize",
                       str(SIZE), "-device", dev.type], io.StringIO(f"play b {s[0]}\ngenmove w\n"
                                               "quit\n"), out)
    main_s = time.time() - t
    blocks = [b for b in out.getvalue().split("\n\n") if b.strip()]
    ok(blocks, "main session")
    if main_eng.search_params.root_num_symmetries != 4 or \
            main_eng._get_driver().root_num_symmetries != 4:
        raise AssertionError("the config's rootNumSymmetriesToSample is not "
                             "on the path")
    launches = counts()
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{k} was not launched in phase 9")
    gm = genmoves[:2]
    per = {k: sum(g["launches"][k] for g in gm) / len(gm) for k in launches}
    out = {"engine_s": engine_s, "forward_ms_batch1": fwd_ms,
           "playout_ms": playout_ms, "genmoves": genmoves,
           "genmove_s": [g["seconds"] for g in genmoves],
           "analyze_s": analyze_s, "analyze_info_lines": len(info_lines),
           "raw_nn_s": raw_s, "raw_nn_cpu_max_abs_err": raw_err,
           "clock_genmove_s": clock_s, "clock_recommended_s": rec,
           "ponder_root_visits": ponder_visits,
           "ponder_launches": ponder_launches, "main_session_s": main_s,
           "launches": launches, "launches_per_genmove": per}
    log(f"phase gtp: {SIZE}x{SIZE} {MODEL} desc net, GTP_VISITS "
        f"{GTP_VISITS}; "
        f"forward at batch 1 {fwd_ms:.3f} ms; {playout_ms:.1f} ms per "
        f"playout at one game; genmove s "
        f"{[round(x, 3) for x in out['genmove_s']]}; kata-analyze "
        f"{analyze_s:.2f} s ({len(info_lines)} info lines); kata-raw-nn "
        f"{raw_s:.2f} s (card vs CPU {raw_err:.2e}); genmove under "
        f"time_settings 60 5 1 {clock_s:.2f} s (recommended {rec:.2f} s); "
        f"ponder tree {ponder_visits} visits after 2 s idle; main() session "
        f"with rootNumSymmetriesToSample = 4 {main_s:.2f} s; launches "
        f"{launches}, per genmove {per}")
    log("gtp json " + json.dumps(out))
    return out


def one_game_kernel_times(dev) -> dict:
    """Both kernels at the one-game shape of phases 9-10: K2 on one
    board [1, NN], K1 on the lanes of one game's leaf batch."""
    from katago_torch.game import ladder as LAD
    from katago_torch.ops import cases as CASES
    from katago_torch.ops import chase as K1
    from katago_torch.ops import labels as K2
    board = CASES.random_boards(1, SIZE, SEED + 1).to(dev)
    st, ko = CASES.chase_boards(GAMES, SIZE, SEED + 2)
    st, ko = st[:1].to(dev), ko[:1].to(dev)
    steps = LAD.default_max_steps(SIZE)
    args = LAD.chase_lane_inputs(st, LAD._chase_setup(st, SIZE, 16, ko), 16)
    if not torch.equal(K2.connected_labels(board, SIZE),
                       K2.connected_labels_plain(board, SIZE)):
        raise AssertionError("K2 differs from its plain version at [1, NN]")
    if not torch.equal(K1.chase_lanes(*args, size=SIZE, max_steps=steps),
                       K1.chase_lanes_plain(*args, size=SIZE,
                                            max_steps=steps)):
        raise AssertionError("K1 differs from its plain version on one game")
    out = {
        "k2_ms": device_ms(lambda: K2.connected_labels(board, SIZE), 200),
        "k2_plain_ms": event_ms(
            lambda: K2.connected_labels_plain(board, SIZE), 10),
        "k1_lanes": int(args[0].shape[0]),
        "k1_active": int(args[6].sum()),
        "k1_ms": device_ms(lambda: K1.chase_lanes(
            *args, size=SIZE, max_steps=steps), 50),
        "k1_plain_ms": event_ms(lambda: K1.chase_lanes_plain(
            *args, size=SIZE, max_steps=steps), 3)}
    log(f"one-game kernels: K2 [1, {SIZE * SIZE}] device-only "
        f"{out['k2_ms']:.5f} ms vs plain {out['k2_plain_ms']:.4f} ms; K1 "
        f"{out['k1_lanes']} lanes ({out['k1_active']} active) device-only "
        f"{out['k1_ms']:.5f} ms vs plain {out['k1_plain_ms']:.4f} ms")
    return out


def run_analysis_phase(bin_gz: str, dev) -> dict:
    """Phase 10 (see the module docstring)."""
    import io

    from katago_torch.cli import analysis as AN
    from katago_torch.ops import chase as K1
    from katago_torch.ops import labels as K2

    s = _stars()
    board = {"boardXSize": SIZE, "boardYSize": SIZE}
    q1 = {"id": "turns", "moves": [["B", s[0]], ["W", s[1]], ["B", s[2]]],
          "rules": "tromp-taylor", "komi": 7.5, "analyzeTurns": [1, 2, 3],
          "maxVisits": ANALYSIS_VISITS, **board}
    queries = [
        q1,
        {"id": "avoid", "moves": [["B", s[0]]], "maxVisits": ANALYSIS_VISITS,
         "avoidMoves": [{"player": "W", "moves": s[1:], "untilDepth": 1}],
         "includeOwnership": True, "includeMovesOwnership": True,
         "includePVVisits": True, **board},
        {"id": "stream", "moves": [["B", s[1]]], "maxVisits": ANALYSIS_VISITS,
         "reportDuringSearchEvery": 0.001, **board},
        dict(q1, id="again"),
    ]

    class Stamped(io.StringIO):
        def __init__(self):
            super().__init__()
            self.stamps = []

        def write(self, s):
            self.stamps.append((time.time(), s))
            return super().write(s)

    K1.reset_launches()
    K2.reset_launches()
    eng = AN.AnalysisEngine(bin_gz, device=dev)
    out = Stamped()
    t0 = time.time()
    AN.run_protocol(eng, io.StringIO("\n".join(json.dumps(q)
                                               for q in queries) + "\n"), out)
    torch.cuda.synchronize()
    total_s = time.time() - t0
    launches = {"chase_lanes": K1.launches, "connected_labels": K2.launches}
    resp = [json.loads(x) for x in out.getvalue().splitlines()]
    finals = [r for r in resp if not r.get("isDuringSearch")]
    if len(finals) != 3 + 1 + 1 + 3:
        raise AssertionError(f"{len(finals)} final responses: {finals}")
    for r in finals:
        if "rootInfo" not in r or not r.get("moveInfos"):
            raise AssertionError(f"response without results: {r}")
        if r["rootInfo"]["visits"] != ANALYSIS_VISITS:
            raise AssertionError(f"root visits {r['rootInfo']['visits']}, "
                                 f"want {ANALYSIS_VISITS}")
    if not any(r.get("isDuringSearch") for r in resp):
        raise AssertionError("reportDuringSearchEvery streamed nothing")
    if eng._tree_cache_hits != 3:
        raise AssertionError(f"{eng._tree_cache_hits} tree cache hits, "
                             "want 3")
    first = [r for r in finals if r["id"] == "turns"]
    again = [r for r in finals if r["id"] == "again"]
    if [[m["visits"] for m in r["moveInfos"]] for r in first] != \
            [[m["visits"] for m in r["moveInfos"]] for r in again]:
        raise AssertionError("the cached repeat ran new playouts")
    # seconds per query: from the start to each query's last final answer
    ends = {}
    for t, s in out.stamps:
        for line in s.splitlines():
            r = json.loads(line)
            if not r.get("isDuringSearch"):
                ends[r["id"]] = t
    order = sorted(ends.items(), key=lambda kv: kv[1])
    per_q, prev = {}, t0
    for qid, t in order:
        per_q[qid] = t - prev
        prev = t
    res = {"seconds": total_s, "seconds_per_query": per_q,
           "during_search_responses": sum(bool(r.get("isDuringSearch"))
                                          for r in resp),
           "cache_hits": eng._tree_cache_hits, "launches": launches}
    log(f"phase analysis: 4 queries at {ANALYSIS_VISITS} visits in "
        f"{total_s:.2f} s; seconds per query "
        f"{json.dumps({k: round(v, 3) for k, v in per_q.items()})}; "
        f"{res['during_search_responses']} isDuringSearch responses; 3 "
        f"cache hits; launches {launches}")
    log("analysis json " + json.dumps(res))
    return res


def _kernel_counts() -> dict:
    from katago_torch.ops import chase as K1
    from katago_torch.ops import labels as K2
    return {"chase_lanes": K1.launches, "connected_labels": K2.launches}


def _reset_kernel_counts() -> None:
    from katago_torch.ops import chase as K1
    from katago_torch.ops import labels as K2
    K1.reset_launches()
    K2.reset_launches()


def _need_launches(launches: dict, what: str) -> None:
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{k} was not launched in {what}")


def _export(model, cfg, path: Path) -> float:
    """The port's exporter on model's weights; returns the seconds."""
    from katago_torch.models.export import export_model
    from katago_torch.models.weights import to_flax_params
    t0 = time.time()
    export_model(to_flax_params(model.state_dict()), cfg, str(path),
                 name=path.name.split(".")[0])
    return time.time() - t0


def run_humansl_phase(dev, work: Path) -> dict:
    """Phase 11: humanSL serving. b18c384nbt with the metadata encoder
    (the shape of the public b18c384nbt-humanv0), seeded, exported by the
    port to .bin.gz and served by the GTP engine through desc.load_model
    and DescNet (float32) with humanSLProfile = HUMANSL_PROFILE: plays,
    genmoves at GTP_VISITS, kata-raw-human-nn (card vs CPU within
    RAW_NN_ATOL, and unlike the unconditioned kata-raw-nn), then a genmove
    with avoidRepeatedPatternUtility so the pattern table is probed in
    the tree; one playout at one game timed on a fresh search; then one
    get_model_outputs of humanslnet_server on the same file."""
    import dataclasses
    import io

    import numpy as np

    from katago_torch.cli import gtp as G
    from katago_torch.cli import humanslnet_server as SRV
    from katago_torch.game import history as H
    from katago_torch.models import config as MC
    from katago_torch.models import model as M
    from katago_torch.models import weights as W
    from katago_torch.search import patternbonus as PB

    cfg = dataclasses.replace(MC.get_config(MODEL), metadata_encoder=True)
    model = W.init_weights(M.KataGoModel(cfg, SIZE, torch.float32),
                           seed=SEED + 11)
    bin_gz = work / "humansl-b18c384nbt.bin.gz"
    export_s = _export(model, cfg, bin_gz)
    del model

    def ok(blocks, what):
        bad = [b for b in blocks if not b.startswith("=")]
        if bad:
            raise AssertionError(f"GTP {what}: {bad}")

    _reset_kernel_counts()
    t0 = time.time()
    eng = G.GTPEngine(model_path=str(bin_gz), size=SIZE, visits=GTP_VISITS,
                      device=dev, seed=SEED,
                      human_sl_profile=HUMANSL_PROFILE)
    engine_s = time.time() - t0
    if eng.desc.trunk["meta_encoder"] is None or eng.sgf_meta is None:
        raise AssertionError("the humanSL net or profile is not loaded")
    s = _stars()
    ok(_gtp(eng, [f"boardsize {SIZE}", "komi 7.5", "clear_board",
                  f"play b {s[0]}", f"play w {s[1]}", f"play b {s[2]}",
                  f"play w {s[3]}"]), "opening")
    genmoves = []

    def genmove(color):
        pla = 1 if color == "b" else 2
        legal = H.legal_moves(H.replace_pos(eng.gs, to_move=eng._one(pla)),
                              SIZE)[0].cpu().numpy()
        c0 = _kernel_counts()
        torch.cuda.synchronize()
        t = time.time()
        blocks = _gtp(eng, [f"genmove {color}"])
        torch.cuda.synchronize()
        dt = time.time() - t
        ok(blocks, f"genmove {color}")
        loc = G.gtp_to_loc(blocks[0][2:], SIZE)
        if not legal[loc]:
            raise AssertionError(f"genmove {color} chose illegal {loc}")
        c1 = _kernel_counts()
        genmoves.append({"color": color, "seconds": dt,
                         "move": blocks[0][2:],
                         "visits": int(eng.last_search_result.root_visits[0]),
                         "launches": {k: c1[k] - c0[k] for k in c1}})

    genmove("b")
    genmove("w")
    t = time.time()
    human = _gtp(eng, ["kata-raw-human-nn"])
    torch.cuda.synchronize()
    raw_s = time.time() - t
    plain = _gtp(eng, ["kata-raw-nn"])
    ok(human + plain, "kata-raw-human-nn / kata-raw-nn")
    a = _raw_nn_numbers(human[0][1:])
    if a == _raw_nn_numbers(plain[0][1:]):
        raise AssertionError("kata-raw-human-nn equals the unconditioned "
                             "kata-raw-nn")
    cpu = G.GTPEngine(model_path=str(bin_gz), size=SIZE, visits=GTP_VISITS,
                      device="cpu", seed=SEED,
                      human_sl_profile=HUMANSL_PROFILE)
    for player, loc in eng.moves:
        cpu.play(player, loc)
    b = _raw_nn_numbers(cpu.raw_nn(use_human_profile=True))
    del cpu
    if len(a) != len(b) or len(a) != 3 + SIZE * SIZE + 1:
        raise AssertionError(f"kata-raw-human-nn gave {len(a)} / {len(b)} "
                             "numbers")
    raw_err = float(np.abs(np.array(a) - np.array(b)).max())
    if raw_err > RAW_NN_ATOL:
        raise AssertionError(f"kata-raw-human-nn card vs CPU differ by "
                             f"{raw_err}")

    # a genmove that avoids the mover's own shapes: the pattern table is
    # built from the game and probed at every expansion
    eng.search_params = dataclasses.replace(
        eng.search_params, avoid_repeated_pattern_utility=PATTERN_UTILITY)
    pla = eng.to_move()
    table = eng._pattern_bonus_arrs(pla)
    if table is None:
        raise AssertionError("no pattern-bonus table for the mover")
    probes = [0]
    lookup = PB.lookup

    def counted(*args, **kw):
        probes[0] += 1
        return lookup(*args, **kw)
    PB.lookup = counted
    try:
        genmove("b" if pla == 1 else "w")
    finally:
        PB.lookup = lookup
    if probes[0] == 0:
        raise AssertionError("the pattern table was not probed")

    drv = eng._get_driver()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.synchronize()
    t = time.time()
    res = drv.search(eng.gs, gen, max_visits=GTP_VISITS)
    torch.cuda.synchronize()
    playout_ms = (time.time() - t) / (int(res.root_visits[0]) - 1) * 1e3
    launches = _kernel_counts()
    _need_launches(launches, "phase 11")
    del eng, drv, res

    script = "\n".join(json.dumps(q) for q in [
        {"command": "start", "board_x_size": SIZE, "board_y_size": SIZE},
        {"command": "play", "pla": 1, "loc": G.gtp_to_loc(s[0], SIZE)},
        {"command": "get_model_outputs", "sgfmeta": {
            "inverseBRank": 5, "inverseWRank": 5, "bIsHuman": True,
            "wIsHuman": True, "tcIsByoYomi": True, "source": 2}}]) + "\n"
    out = io.StringIO()
    t = time.time()
    SRV.main(["-model", str(bin_gz), "-device", str(dev)],
             io.StringIO(script), out)
    server_s = time.time() - t
    resp = [json.loads(x) for x in out.getvalue().splitlines()]
    got = resp[-1].get("outputs")
    if not isinstance(got, dict) or not got["moves_and_probs0"]:
        raise AssertionError(f"humanslnet_server answered {resp[-1]}")
    probs = [p for _, p in got["moves_and_probs0"]]
    if not all(math.isfinite(p) and 0.0 < p <= 1.0 for p in probs) or \
            sum(probs) > 1.0 + 1e-4 or abs(sum(got["value"]) - 1.0) > 1e-4:
        raise AssertionError(f"humanslnet_server outputs are off: {got}")
    gm = genmoves[:2]
    per = {k: sum(g["launches"][k] for g in gm) / len(gm) for k in launches}
    res = {"export_s": export_s, "bin_gz_bytes": bin_gz.stat().st_size,
           "engine_s": engine_s, "genmoves": genmoves,
           "genmove_s": [g["seconds"] for g in genmoves],
           "raw_human_nn_s": raw_s, "raw_human_nn_cpu_max_abs_err": raw_err,
           "pattern_table_keys": int((table.bonus != 0).sum()),
           "pattern_probes": probes[0], "playout_ms": playout_ms,
           "server_s": server_s, "server_moves": len(probs),
           "launches": launches, "launches_per_genmove": per}
    log(f"phase humansl: {MODEL} + metadata encoder exported "
        f"({res['bin_gz_bytes']} B in {export_s:.1f} s), loaded in "
        f"{engine_s:.2f} s with humanSLProfile {HUMANSL_PROFILE}; genmove s "
        f"{[round(x, 3) for x in res['genmove_s']]} at {GTP_VISITS} visits "
        f"(the last with avoidRepeatedPatternUtility {PATTERN_UTILITY}: "
        f"{res['pattern_table_keys']} keys, {probes[0]} probe calls); "
        f"{playout_ms:.1f} ms per playout at one game; kata-raw-human-nn "
        f"{raw_s:.2f} s (card vs CPU {raw_err:.2e}); humanslnet_server "
        f"{server_s:.2f} s ({len(probs)} moves); launches {launches}, per "
        f"genmove {per}")
    log("humansl json " + json.dumps(res))
    return res


def run_transformer_phase(dev, work: Path) -> dict:
    """Phase 12: the transformer family at TF_MODEL (trunk 384, mid 192,
    6 heads, FFN 512, five GAB blocks): its forward in bf16 at batch
    GAMES; play_games in bf16 on GAMES 19x19 games with ladders and tree
    reuse at SP_VISITS for TF_MOVES moves, every one a full recorded
    search (run_selfplay_phase: the shard in the pinned schema, both
    kernels launched); run_training on that
    shard in float32 at batch TRAIN_BATCH, one warm-up step and
    TF_TRAIN_STEPS resumed and timed, every loss finite; then one SGD
    step of the small nbttf-GAB net of TF_CHECK_FIELDS (QK-norm GQA, an
    intermediate head) on the card and the CPU."""
    import dataclasses

    from katago_torch.cli import train_cmd as TCMD
    from katago_torch.models import config as MC
    from katago_torch.models import model as M
    from katago_torch.models import weights as W
    from katago_torch.selfplay.playsettings import PlaySettings

    cfg = MC.get_config(TF_MODEL)
    model = W.init_weights(M.KataGoModel(cfg, SIZE, torch.bfloat16),
                           seed=SEED).to(dev).eval()
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    spatial = (torch.rand((GAMES, SIZE, SIZE, 22), generator=gen,
                          device=dev) < 0.2).float()
    spatial[..., 0] = 1.0
    glob = torch.randn((GAMES, 19), generator=gen, device=dev)
    with torch.no_grad():
        out = model(spatial, glob)
        fwd_ms = event_ms(lambda: model(spatial, glob), 10)
    for k, v in out.items():
        if not torch.isfinite(v).all():
            raise AssertionError(f"{TF_MODEL} output {k} is not finite")
    fwd_flops = forward_flops(model, SIZE, GAMES, dev)
    # every move a full, recorded search (no cheap searches), so the few
    # moves give the trainer rows
    ps = dataclasses.replace(PlaySettings.for_selfplay(),
                             cheap_search_prob=0.0)
    sp_out = run_selfplay_phase(model, gen, dev, work, moves=TF_MOVES,
                                tdata_name="tdata_tf",
                                tag="transformer selfplay", play_settings=ps)
    del model, out
    torch.cuda.empty_cache()

    data = work / "tdata_tf"
    lines = []
    common = dict(size=SIZE, config_name=TF_MODEL, batch_size=TRAIN_BATCH,
                  lr=TRAIN_LR, seed=SEED, device=dev, log=lines.append)

    def finite(o, what):
        for i, m in enumerate(o["metrics"]):
            bad = [k for k, v in m.items() if not math.isfinite(v)]
            if bad:
                raise AssertionError(f"{what} step {i}: {bad} not finite")

    warm = TCMD.run_training(str(data), str(work / "ckpt_tf"), None,
                             steps=1, **common)
    finite(warm, "transformer warm-up")
    timings = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    tr = TCMD.run_training(str(data), str(work / "ckpt_tf"), None,
                           steps=TF_TRAIN_STEPS, timings=timings, **common)
    run_s = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    finite(tr, "transformer")
    if tr["steps"] != TF_TRAIN_STEPS:
        raise AssertionError(f"trained {tr['steps']} transformer steps")
    ms = {k: timings[k] / TF_TRAIN_STEPS * 1e3
          for k in ("data_s", "h2d_s", "fwd_bwd_s", "opt_s")}
    step_ms = sum(ms.values())
    train_flops = 3.0 * fwd_flops / GAMES * TRAIN_BATCH

    check_cfg = dataclasses.replace(cfg, **TF_CHECK_FIELDS)
    t0 = time.time()
    check = check_step_card_vs_cpu(next(data.glob("*.npz")), dev, check_cfg)
    check_s = time.time() - t0
    res = {"model": TF_MODEL, "forward_ms_batch": fwd_ms,
           "forward_flops_batch": fwd_flops, "selfplay": sp_out,
           "train_ms_per_step": ms, "train_step_ms": step_ms,
           "train_rows_per_s": TRAIN_BATCH / step_ms * 1e3,
           "train_peak_mem_bytes": peak, "train_run_s": run_s,
           "train_flops_per_step": train_flops,
           "fwd_bwd_tflops": train_flops / (ms["fwd_bwd_s"] / 1e3) / 1e12,
           "losses": [m["loss"] for m in tr["metrics"]],
           "card_vs_cpu": check, "card_vs_cpu_s": check_s}
    log(f"phase transformer: {TF_MODEL} bf16 forward at batch {GAMES} "
        f"{fwd_ms:.3f} ms ({fwd_flops / 1e12:.3f} TFLOP from the shapes); "
        f"selfplay {sp_out['playouts_per_s']:.1f} playouts/s, "
        f"{sp_out['launches']['chase_lanes'] / sp_out['moves']:.1f} K1 and "
        f"{sp_out['launches']['connected_labels'] / sp_out['moves']:.1f} K2 "
        f"launches per move; train float32 batch {TRAIN_BATCH}, ms per "
        f"step: data {ms['data_s']:.2f}, host-to-device {ms['h2d_s']:.2f}, "
        f"forward+backward {ms['fwd_bwd_s']:.2f}, optimizer+EMA "
        f"{ms['opt_s']:.2f} (sum {step_ms:.2f}); "
        f"{res['fwd_bwd_tflops']:.2f} TFLOP/s in the forward+backward; "
        f"peak device memory {peak / 2**30:.2f} GiB; losses "
        f"{[round(x, 4) for x in res['losses']]}; card vs CPU "
        f"({check_cfg.name}, batch {CHECK_BATCH}): loss terms within "
        f"{check['loss_max_rel_err']:.2e} (limit {CHECK_LOSS_RTOL}), "
        f"updates within {check['update_max_rel_err']:.2e} (limit "
        f"{CHECK_UPDATE_REL}; worst {check['update_worst_of_limit']:.3f} of "
        "its limit)")
    log("transformer json " + json.dumps(res))
    return res


def run_families_phase(dev, work: Path) -> dict:
    """Phase 13: B28_MODEL (the kata1 main-run shape) in bf16: forward at
    batch GAMES, and a SearchDriver search of GAMES games at B28_VISITS
    visits with ladders on (both kernels launched, every game at its
    visits); then V17_MODEL exported as a version-17 .bin.gz, loaded by
    desc.load_model and DescNet, and its kata-raw-nn equal on the card
    and the CPU within RAW_NN_ATOL."""
    import numpy as np

    from katago_torch.cli import gtp as G
    from katago_torch.game import history as H
    from katago_torch.game import rules as R
    from katago_torch.models import config as MC
    from katago_torch.models import model as M
    from katago_torch.models import weights as W
    from katago_torch.search.driver import SearchDriver
    from katago_torch.search.params import SearchParams

    model = W.init_weights(M.KataGoModel(MC.get_config(B28_MODEL), SIZE,
                                         torch.bfloat16),
                           seed=SEED).to(dev).eval()
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    spatial = (torch.rand((GAMES, SIZE, SIZE, 22), generator=gen,
                          device=dev) < 0.2).float()
    spatial[..., 0] = 1.0
    glob = torch.randn((GAMES, 19), generator=gen, device=dev)
    with torch.no_grad():
        fwd_ms = event_ms(lambda: model(spatial, glob), 10)
    sp = SearchParams.for_selfplay().to_arr(dev)
    driver = SearchDriver(model, sp, size=SIZE, max_nodes=B28_VISITS + 3,
                          chunk_size=B28_VISITS, with_ladders=True,
                          device=dev)
    roots = H.new_game(SIZE, R.Rules.tromp_taylorish(), 160, g=GAMES,
                       device=dev)
    _reset_kernel_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    res = driver.search(roots, gen, max_visits=B28_VISITS + 1)
    torch.cuda.synchronize()
    search_s = time.time() - t0
    launches = _kernel_counts()
    _need_launches(launches, f"the {B28_MODEL} search")
    if not bool((res.root_visits == B28_VISITS + 1).all()):
        raise AssertionError(f"{B28_MODEL} root visits "
                             f"{int(res.root_visits.min())}.."
                             f"{int(res.root_visits.max())}")
    for k in ("root_winloss", "root_utility", "root_ownership"):
        if not torch.isfinite(getattr(res, k)).all():
            raise AssertionError(f"{B28_MODEL} search {k} is not finite")
    del model, driver, res
    torch.cuda.empty_cache()

    cfg = MC.get_config(V17_MODEL)
    v17 = W.init_weights(M.KataGoModel(cfg, SIZE, torch.float32), seed=SEED)
    bin_gz = work / f"{V17_MODEL}.bin.gz"
    _export(v17, cfg, bin_gz)
    del v17
    engines = {}
    for where in (dev, "cpu"):
        eng = G.GTPEngine(model_path=str(bin_gz), size=SIZE, visits=8,
                          device=where, seed=SEED)
        for color, v in zip("bwb", _stars()):
            eng.play(1 if color == "b" else 2, G.gtp_to_loc(v, SIZE))
        engines[str(where)] = eng
    eng = engines[str(dev)]
    kinds = [b["kind"] for b in eng.desc.trunk["blocks"]]
    if eng.desc.version != 17 or kinds != ["attention", "ffn"] * 7:
        raise AssertionError(f"{V17_MODEL} exported as version "
                             f"{eng.desc.version} with blocks {kinds}")
    t = time.time()
    a = _raw_nn_numbers(eng.raw_nn())
    torch.cuda.synchronize()
    raw_s = time.time() - t
    b = _raw_nn_numbers(engines["cpu"].raw_nn())
    if len(a) != len(b) or len(a) != 3 + SIZE * SIZE + 1:
        raise AssertionError(f"{V17_MODEL} kata-raw-nn gave {len(a)} / "
                             f"{len(b)} numbers")
    raw_err = float(np.abs(np.array(a) - np.array(b)).max())
    if raw_err > RAW_NN_ATOL:
        raise AssertionError(f"{V17_MODEL} kata-raw-nn card vs CPU differ "
                             f"by {raw_err}")
    out = {"b28_forward_ms_batch": fwd_ms, "b28_search_s": search_s,
           "b28_playouts_per_s": GAMES * B28_VISITS / search_s,
           "b28_launches": launches, "v17_raw_nn_s": raw_s,
           "v17_raw_nn_cpu_max_abs_err": raw_err}
    log(f"phase families: {B28_MODEL} bf16 forward at batch {GAMES} "
        f"{fwd_ms:.3f} ms; search {GAMES} games x {B28_VISITS} visits in "
        f"{search_s:.2f} s ({out['b28_playouts_per_s']:.1f} playouts/s), "
        f"launches {launches}; {V17_MODEL} as a v17 .bin.gz through "
        f"DescNet: kata-raw-nn {raw_s:.2f} s, card vs CPU {raw_err:.2e}")
    log("families json " + json.dumps(out))
    return out


def _stdout_of(fn, *args) -> str:
    """What fn(*args) prints to standard output."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue()


def _scripted_input(lines):
    """An input() that answers with `lines` in turn (echoing prompt and
    answer), then raises EOFError."""
    it = iter(lines)

    def fake(prompt=""):
        line = next(it, None)
        if line is None:
            print(prompt)
            raise EOFError
        print(prompt + line)
        return line
    return fake


def run_match_phase(train: dict, dev, work: Path) -> dict:
    """Phase 14: play_match at SIZE, float32, ladders on: phase 7's
    trained net (bot A) against the seeded net it started from,
    MATCH_GAMES games of at most MATCH_MOVES moves at MATCH_VISITS
    visits (each move both bots search every game; the searches are
    counted). The record adds up, its Elo is finite, "finished" holds
    exactly when the games ended before MATCH_MOVES, and both kernels
    were launched. Then run_gatekeeper at GATE_SIZE with an export of
    the seeded net as the champion in models/ and phase 7's export as
    the one candidate, GATE_GAMES games at GATE_VISITS visits cut at
    GATE_MOVES moves: it plays a match and moves the candidate into
    models/ or rejected-models/."""
    import os
    import shutil

    from katago_torch.cli import gatekeeper_cmd as GK
    from katago_torch.cli import train_cmd as TCMD
    from katago_torch.cli.match_cmd import play_match
    from katago_torch.search import mcts
    from katago_torch.train import checkpoint as CK

    seeded = TCMD.make_model(SIZE, MODEL, dev, SEED).eval()
    trained = GK._bot_from_export(train["export"], SIZE, MODEL, dev)
    lines = []
    searches = []
    run_search = mcts.run_search

    def counted(*a, **kw):
        searches.append(1)
        return run_search(*a, **kw)
    mcts.run_search = counted          # play_match's searches, this run
    _reset_kernel_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    try:
        result = play_match(trained, seeded, size=SIZE,
                            num_games=MATCH_GAMES, visits=MATCH_VISITS,
                            max_moves=MATCH_MOVES, seed=SEED, device=dev,
                            log=lines.append)
    finally:
        mcts.run_search = run_search
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = _kernel_counts()
    _need_launches(launches, "phase 14's match")
    moves = len(searches) // 2         # each move searches with both bots
    if result["games"] != MATCH_GAMES or result["a_wins"] + \
            result["a_losses"] + result["draws"] != MATCH_GAMES or \
            not math.isfinite(result["a_elo_diff"]) or moves < 1 or \
            (moves < MATCH_MOVES) != result["finished"]:
        raise AssertionError(f"match record {result} after {moves} moves")
    del seeded, trained
    playouts = 2 * MATCH_GAMES * MATCH_VISITS * moves
    out = {"seconds": dt, "moves": moves,
           "s_per_move": dt / moves, "playouts": playouts,
           "playouts_per_s": playouts / dt, "launches": launches,
           "launches_per_move": {k: v / moves
                                 for k, v in launches.items()},
           "result": result}
    log(f"phase match: {MODEL} float32 trained vs seeded, {MATCH_GAMES} "
        f"games x {moves} moves at {MATCH_VISITS} visits (both bots "
        f"search every game) in {dt:.2f} s: {out['s_per_move']:.3f} s per "
        f"move, {out['playouts_per_s']:.1f} playouts/s; launches per move "
        f"{json.dumps(out['launches_per_move'])}; {lines[-1]}")
    log("match json " + json.dumps(result))

    gate = work / "gate"
    dirs = {n: str(gate / n) for n in ("test-models", "models",
                                       "rejected-models")}
    CK.export_params(dirs["models"], "champion",
                     TCMD.make_model(GATE_SIZE, MODEL, dev, SEED)
                     .state_dict())
    shutil.copytree(train["export"], os.path.join(dirs["test-models"],
                                                  "candidate"))
    _reset_kernel_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    gk = GK.run_gatekeeper(dirs["test-models"], dirs["models"],
                           dirs["rejected-models"], size=GATE_SIZE,
                           config_name=MODEL, games=GATE_GAMES,
                           visits=GATE_VISITS, seed=SEED,
                           max_moves=GATE_MOVES, device=dev,
                           log=lines.append)
    torch.cuda.synchronize()
    gate_s = time.time() - t0
    gate_launches = _kernel_counts()
    if len(gk) != 1 or "win_prop" not in gk[0] or \
            gk[0]["games"] != GATE_GAMES:
        raise AssertionError(f"gatekeeper played no match: {gk}")
    dest = dirs["models" if gk[0]["accepted"] else "rejected-models"]
    if os.listdir(dirs["test-models"]) or \
            "candidate" not in os.listdir(dest):
        raise AssertionError("gatekeeper did not move the candidate")
    _need_launches(gate_launches, "phase 14's gatekeeper")
    out.update(gate_s=gate_s, gate=gk[0], gate_launches=gate_launches)
    log(f"phase gatekeeper: {GATE_SIZE}x{GATE_SIZE} {MODEL}, "
        f"{GATE_GAMES} games at {GATE_VISITS} visits, at most {GATE_MOVES} "
        f"moves, in {gate_s:.2f} s: "
        f"win prop {gk[0]['win_prop']:.2f} -> "
        f"{'accepted' if gk[0]['accepted'] else 'rejected'}; launches "
        f"{gate_launches}")
    return out


def run_loop_phase(dev, work: Path) -> dict:
    """Phase 15: one cycle of run_loop (sync) at LOOP_SIZE with MODEL as
    its config: models/ holds an export of the seeded initial net, so
    the cycle runs every stage: selfplay from that champion
    (LOOP_GAMES games at LOOP_VISITS visits, every move recorded),
    shuffle, LOOP_TRAIN_STEPS train steps at batch LOOP_BATCH, and a
    gatekeeper match of LOOP_GATE_GAMES games; the games and the match
    are cut at LOOP_MOVES moves (the loop's max_moves; the time limit).
    Checks the shards, the checkpoint and the candidate in models/ or
    rejected-models/; reports each stage's seconds and kernel launches
    (the stages are wrapped in timers for this run only)."""
    import functools
    import os

    from katago_torch.cli import loop_cmd as L
    from katago_torch.cli import train_cmd as TCMD
    from katago_torch.train import checkpoint as CK

    base = work / "loop"
    CK.export_params(str(base / "models"), "champion",
                     TCMD.make_model(LOOP_SIZE, MODEL, dev, SEED)
                     .state_dict())
    stages = {"selfplay": "run_selfplay", "shuffle": "shuffle_npz_files",
              "train": "run_training", "gatekeeper": "run_gatekeeper"}
    seconds, launches = {}, {}

    def timed(name, fn):
        @functools.wraps(fn)
        def run(*a, **kw):
            before = _kernel_counts()
            torch.cuda.synchronize()
            t0 = time.time()
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                seconds[name] = time.time() - t0
                launches[name] = {k: v - before[k]
                                  for k, v in _kernel_counts().items()}
        return run

    orig = {attr: getattr(L, attr) for attr in stages.values()}
    for name, attr in stages.items():
        setattr(L, attr, timed(name, orig[attr]))
    lines = []
    _reset_kernel_counts()
    t0 = time.time()
    try:
        summary = L.run_loop(
            str(base), cycles=1, size=LOOP_SIZE, config_name=MODEL,
            games_per_cycle=LOOP_GAMES, visits=LOOP_VISITS,
            train_steps=LOOP_TRAIN_STEPS, batch_size=LOOP_BATCH,
            lr=TRAIN_LR, gate_games=LOOP_GATE_GAMES, seed=SEED,
            max_moves=LOOP_MOVES, device=dev, log=lines.append)
    finally:
        for attr, fn in orig.items():
            setattr(L, attr, fn)
    dt = time.time() - t0
    total = _kernel_counts()
    _need_launches(total, "phase 15's cycle")
    (cycle,) = summary
    shards = list((base / "selfplay" / "champion" / "tdata").glob("*.npz"))
    shuffled = list((base / "shuffleddata" / "c0000").glob("*.npz"))
    sp = cycle["selfplay"]
    if not shards or not shuffled or sp["games"] != LOOP_GAMES or \
            sp["rows"] <= 0:
        raise AssertionError(f"loop selfplay/shuffle wrote {shards}, "
                             f"{shuffled}; {sp}")
    ckpt = CK.latest_checkpoint(str(base / "ckpts"))
    if ckpt is None or CK.load_metadata(ckpt)["global_step"] != \
            LOOP_TRAIN_STEPS or cycle["train"]["steps"] != LOOP_TRAIN_STEPS:
        raise AssertionError(f"loop training left checkpoint {ckpt}")
    (gk,) = cycle["gatekeeper"]
    cand = f"{MODEL}-s{LOOP_TRAIN_STEPS}"
    dest = base / ("models" if gk["accepted"] else "rejected-models")
    if gk["candidate"] != cand or "win_prop" not in gk or \
            not (dest / cand).is_dir() or os.listdir(base / "test-models"):
        raise AssertionError(f"loop gatekeeper: {gk}, "
                             f"{sorted(dest.iterdir())}")
    out = {"seconds": dt, "stage_s": seconds, "stage_launches": launches,
           "launches": total, "selfplay": sp, "gate": gk,
           "first_loss": cycle["train"].get("first_loss"),
           "final_loss": cycle["train"].get("final_loss")}
    log(f"phase loop: one sync cycle at {LOOP_SIZE}x{LOOP_SIZE}, {MODEL}, "
        f"{LOOP_GAMES} games of at most {LOOP_MOVES} moves at "
        f"{LOOP_VISITS} visits ({sp['rows']} rows, "
        f"{len(shuffled)} shuffled shards), {LOOP_TRAIN_STEPS} steps at "
        f"batch {LOOP_BATCH}, gate {LOOP_GATE_GAMES} games -> "
        f"{'accepted' if gk['accepted'] else 'rejected'} (win prop "
        f"{gk['win_prop']:.2f}) in {dt:.2f} s; seconds per stage "
        f"{json.dumps({k: round(v, 2) for k, v in seconds.items()})}; "
        f"launches per stage {json.dumps(launches)}")
    return out


def run_tools_phase(train: dict, dev, work: Path) -> dict:
    """Phase 16: the tools through their mains on the card. benchmark_cmd
    over BENCH_BATCHES games at BENCH_VISITS visits (one timed search
    each) and -train at batch BENCH_TRAIN_BATCH; genconfig_cmd
    -benchmark on phase 7's .bin.gz, its config loaded by gtp -config for
    one genmove; forward_cmd on the .bin.gz at turn TOOLS_TURN of phase
    6's first game, on the card and on the CPU, every number within
    RAW_NN_ATOL; evalsgf there at EVALSGF_VISITS; play_cmd with input()
    scripted for three turns; checkpoint_tools show and clean -bin-gz of
    phase 7's checkpoint, the cleaned .bin.gz held against its export by
    check_desc_net."""
    import io
    import re

    import numpy as np

    from katago_torch.cli import benchmark_cmd as BEN
    from katago_torch.cli import checkpoint_tools_cmd as CT
    from katago_torch.cli import forward_cmd as FWD
    from katago_torch.cli import genconfig_cmd as GEN
    from katago_torch.cli import gtp as G
    from katago_torch.cli import play_cmd as PLAY
    from katago_torch.cli import sgf_cmds as SGF
    from katago_torch.train import checkpoint as CK

    bin_gz = train["bin_gz"]
    sgfs = str(next(work.glob("tdata_*.sgfs")))
    on = ["-device", str(dev)]
    seconds = {}
    _reset_kernel_counts()

    def clock(name, fn, *args):
        torch.cuda.synchronize()
        t0 = time.time()
        res = fn(*args)
        torch.cuda.synchronize()
        seconds[name] = time.time() - t0
        return res

    bench = clock("benchmark", _stdout_of, BEN.main, [
        "-config", MODEL, "-size", str(SIZE), "-visits", str(BENCH_VISITS),
        "-batches", BENCH_BATCHES, "-iters", "1"] + on)
    bench = json.loads(bench.splitlines()[-1])
    rows = bench["results"]
    if [r["games_per_batch"] for r in rows] != \
            [int(b) for b in BENCH_BATCHES.split(",")] or \
            bench["device"] != BEN.device_name(dev) or \
            not all(r["playouts_per_s"] > 0 for r in rows):
        raise AssertionError(f"benchmark output {bench}")
    tbench = clock("benchmark_train", _stdout_of, BEN.main, [
        "-train", "-config", MODEL, "-size", str(SIZE), "-batches",
        str(BENCH_TRAIN_BATCH), "-steps", str(BENCH_TRAIN_STEPS)] + on)
    tbench = json.loads(tbench.splitlines()[-1])
    if not tbench["train_results"][0]["rows_per_s"] > 0:
        raise AssertionError(f"train benchmark output {tbench}")
    log("benchmark json " + json.dumps(bench))
    log("benchmark train json " + json.dumps(tbench))

    cfg = work / "genconfig.cfg"
    clock("genconfig", _stdout_of, GEN.main, [
        "-output", str(cfg), "-benchmark", "-model", bin_gz, "-boardsize",
        str(SIZE)] + on)
    max_visits = int(re.search(r"maxVisits = (\d+)",
                               cfg.read_text()).group(1))
    out = io.StringIO()
    clock("gtp_genmove", G.main, ["-model", bin_gz, "-config", str(cfg),
                                  "-boardsize", str(SIZE), "-seed", "0"]
          + on,
          io.StringIO("genmove b\nquit\n"), out)
    if not re.match(r"= ([A-HJ-T]\d+|pass)\n", out.getvalue()):
        raise AssertionError(f"genmove on the generated config: "
                             f"{out.getvalue()!r}")

    fwd_args = ["-model", bin_gz, "-sgf", sgfs, "-turn", str(TOOLS_TURN),
                "-full"]
    card = json.loads(clock("forward", _stdout_of, FWD.main,
                            fwd_args + on))
    cpu = json.loads(clock("forward_cpu", _stdout_of, FWD.main,
                           fwd_args + ["-device", "cpu"]))
    fwd_err = 0.0
    for k, v in cpu.items():
        a, b = card[k], v
        if k == "topPolicy":
            a, b = [p["prob"] for p in a], [p["prob"] for p in b]
        if isinstance(b, (float, list)):
            fwd_err = max(fwd_err, float(np.max(np.abs(
                np.asarray(a, np.float64) - np.asarray(b, np.float64)))))
        elif a != b:
            raise AssertionError(f"forward {k}: card {a} != cpu {b}")
    if not fwd_err <= RAW_NN_ATOL:
        raise AssertionError(f"forward card vs CPU differs by {fwd_err}")

    text = clock("evalsgf", _stdout_of, SGF.main, [
        "evalsgf", sgfs, "-model", bin_gz, "-visits", str(EVALSGF_VISITS),
        "-move-num", str(TOOLS_TURN)] + on)
    if f"visits: {EVALSGF_VISITS + 1}" not in text:
        raise AssertionError(f"evalsgf output {text!r}")

    PLAY.input = _scripted_input([_stars()[0], "genmove", "policy"])
    try:
        play = clock("play", _stdout_of, PLAY.main, [
            "-model", bin_gz, "-size", str(SIZE), "-visits",
            str(PLAY_VISITS)] + on)
    finally:
        del PLAY.input
    if play.count("engine plays") != 2 or "for you" not in play or \
            not re.search(r"[A-HJ-T]\d+:0\.\d{3}", play):
        raise AssertionError(f"play transcript {play!r}")
    launches = _kernel_counts()
    _need_launches(launches, "phase 16's tools")

    ckpt = CK.latest_checkpoint(str(work / "ckpt"))
    shown = json.loads(_stdout_of(CT.main, ["show", "-ckpt", ckpt]))
    if shown["step"] != TRAIN_WARMUP + TRAIN_STEPS:
        raise AssertionError(f"checkpoint show {shown}")
    cleaned = json.loads(clock("clean", _stdout_of, CT.main, [
        "clean", "-ckpt", ckpt, "-out", str(work / "clean"), "-name",
        "cleaned", "-config", MODEL, "-size", str(SIZE), "-bin-gz"]))
    desc = check_desc_net(cleaned["bin_gz"], cleaned["export"],
                          next((work / "tdata").glob("*.npz")), dev)
    res = {"seconds": seconds, "benchmark": bench, "train_benchmark": tbench,
           "genconfig_max_visits": max_visits, "forward_max_abs_err": fwd_err,
           "checkpoint_show": shown, "clean": cleaned,
           "clean_desc_rel_err": desc["rel_err"], "launches": launches}
    log(f"phase tools: benchmark playouts/s "
        f"{[round(r['playouts_per_s'], 1) for r in rows]} at batches "
        f"{BENCH_BATCHES} ({BENCH_VISITS} visits), recommended "
        f"{bench['recommended']}; train {tbench['train_results']}; "
        f"genconfig maxVisits {max_visits}; forward card vs CPU within "
        f"{fwd_err:.2e} (limit {RAW_NN_ATOL}); evalsgf, play, show and "
        f"clean ok; seconds "
        f"{json.dumps({k: round(v, 2) for k, v in seconds.items()})}; "
        f"launches {launches}")
    log("evalsgf text " + json.dumps(text))
    return res


def _launches_of(fn, *args, **kw):
    """(fn's result, the kernel launches it made, its seconds with the
    device synchronised at both ends)."""
    before = _kernel_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    res = fn(*args, **kw)
    torch.cuda.synchronize()
    return res, {k: v - before[k] for k, v in _kernel_counts().items()}, \
        time.time() - t0


def _check_npz_schema(arrays: dict, size: int, what: str) -> None:
    schema = json.loads((REF_DIR / "npz_schema.json").read_text())[
        "per_row"][str(size)]
    if sorted(arrays) != sorted(schema):
        raise AssertionError(f"{what}: keys {sorted(arrays)}")
    for k, (dtype, shape) in schema.items():
        if str(arrays[k].dtype) != dtype or \
                list(arrays[k].shape[1:]) != shape:
            raise AssertionError(f"{what}: {k} is {arrays[k].dtype} "
                                 f"{arrays[k].shape}")


def random_sgf_games(dev, n: int, moves: int, seed: int) -> list:
    """n games of `moves` random legal board moves at SIZE, played in
    lockstep on the port's engine, as SGF texts with their area result."""
    from katago_torch.dataio import sgf as S
    from katago_torch.game import history as H
    from katago_torch.game import rules as R

    rules = R.Rules.tromp_taylorish()
    games = H.new_game(SIZE, rules, moves + 8, g=n, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    nn = SIZE * SIZE
    played = []
    for _ in range(moves):
        legal = H.legal_moves(games, SIZE)[:, :nn]
        u = torch.rand(legal.shape, generator=gen, device=dev)
        loc = torch.argmax(torch.where(legal, u, -1.0), dim=1)
        loc = torch.where(legal.any(1), loc, nn)
        played.append((games.pos.to_move.clone(), loc))
        games, _ = H.step(games, loc, SIZE)
    _, score = H.final_score(games, SIZE)
    out = []
    for g in range(n):
        sc = float(score[g])
        result = f"W+{sc:g}" if sc > 0 else f"B+{-sc:g}" if sc < 0 else "0"
        out.append(S.write_sgf([(int(p[g]), int(l[g])) for p, l in played],
                               SIZE, SIZE, komi=rules.komi, result=result,
                               black_name="random-b", white_name="random-w"))
    return out


def run_sgftools_phase(train: dict, dev, work: Path) -> dict:
    """Phase 17: the SGF tools on phase 6's records (its .sgfs, and its
    first SGF17_RECORDS records as .sgf files), SGF17_GAMES random legal
    games of SGF17_MOVES moves (random_sgf_games) and phase 7's .bin.gz
    (DescNet): summarize_sgfs; startposes and samplesgfs, the latter
    viewed by viewstartposes; writetrainingdata of WTD_MAX_ROWS rows (V7,
    exact ladders), read back in the pinned npz schema; dataminesgfs in
    game mode at DATAMINE_VISITS visits (tiers /5 and /25) from turn
    DATAMINE_MIN_TURN (the random games' positions); checksgfhintpolicy
    on startposes' hints. Each
    command's seconds and kernel launches."""
    import numpy as np

    from katago_torch.cli import sgf_cmds as SGF
    from katago_torch.cli import summarize_sgfs_cmd as SUM

    bin_gz = train["bin_gz"]
    sgfs = next(work.glob("tdata_*.sgfs"))
    d = work / "sgf17"
    d.mkdir()
    lines = [ln for ln in sgfs.read_text().splitlines() if ln.strip()]
    for i, line in enumerate(lines[:SGF17_RECORDS]):
        (d / f"g{i:03d}.sgf").write_text(line + "\n")
    for i, text in enumerate(random_sgf_games(dev, SGF17_GAMES,
                                              SGF17_MOVES, SEED)):
        (d / f"r{i:03d}.sgf").write_text(text + "\n")
    out = work / "sgf17_out"
    on = ["-device", str(dev)]
    seconds, launches, printed = {}, {}, {}

    def run(name, fn, argv):
        text, launches[name], seconds[name] = _launches_of(
            _stdout_of, fn, argv)
        printed[name] = text
        return text

    summary = run("summarize", SUM.main, [str(sgfs)])
    if not summary.startswith(f"{len(lines)} games, "):
        raise AssertionError(f"summarize_sgfs: {summary!r}")
    poses = out / "poses.jsonl"
    out.mkdir()
    run("startposes", SGF.main, ["startposes", "-sgf-dir", str(d),
                                 "-output", str(poses), "-sample-prob",
                                 str(SGF17_SAMPLE_PROB)] + on)
    sampled = json.loads(run("samplesgfs", SGF.main, [
        "samplesgfs", "--sgfdir", str(d), "--outdir", str(out / "samples"),
        "--sample-prob", str(SGF17_SAMPLE_PROB)] + on).splitlines()[-1])
    files = sorted((out / "samples").glob("startposes.*.txt"))
    view = json.loads(run("viewstartposes", SGF.main, [
        "viewstartposes"] + [a for f in files for a in (
            "--start-poses-file", str(f))] + ["--check-legality"] + on
    ).splitlines()[-1])
    # a record holds the recorded moves only (phase 6 mixes cheap and
    # full searches), so its replay may meet illegal context moves
    if sampled["kept"] <= 0 or view["poses"] != sampled["kept"]:
        raise AssertionError(f"samplesgfs {sampled}, view {view}")
    wtd = json.loads(run("writetrainingdata", SGF.main, [
        "writetrainingdata", "-sgf-dir", str(d), "-output",
        str(out / "rows.npz"), "-size", str(SIZE), "-max-rows",
        str(WTD_MAX_ROWS)] + on).splitlines()[-1])
    with np.load(out / "rows.npz") as z:
        arrays = {k: z[k] for k in z.files}
    _check_npz_schema(arrays, SIZE, "writetrainingdata")
    if arrays["globalTargetsNC"].shape[0] != wtd["rows"] or \
            not 0 < wtd["rows"] <= WTD_MAX_ROWS:
        raise AssertionError(f"writetrainingdata {wtd}")
    mined = json.loads(run("dataminesgfs", SGF.main, [
        "dataminesgfs", "--sgfdir", str(d), "--outdir", str(out / "mined"),
        "--model", bin_gz, "--size", str(SIZE), "--game-mode", "--visits",
        str(DATAMINE_VISITS), "--min-turn", str(DATAMINE_MIN_TURN)] + on
    ).splitlines()[-1])
    if mined["candidates"] <= 0 or mined.get("searched", 0) <= 0:
        raise AssertionError(f"dataminesgfs {mined}")
    hint = json.loads(run("checksgfhintpolicy", SGF.main, [
        "checksgfhintpolicy", "--start-poses-file", str(poses), "--model",
        bin_gz] + on).splitlines()[-1])
    if hint["hints"] <= 0 or not 0.0 <= hint["meanPolicy"] <= 1.0:
        raise AssertionError(f"checksgfhintpolicy {hint}")
    _need_launches({"connected_labels":
                    launches["dataminesgfs"]["connected_labels"],
                    "chase_lanes": launches["dataminesgfs"]["chase_lanes"]},
                   "phase 17's dataminesgfs")
    res = {"seconds": seconds, "launches": launches, "summary": summary,
           "samplesgfs": sampled, "writetrainingdata": wtd,
           "dataminesgfs": mined, "checksgfhintpolicy": hint}
    log(f"phase sgf tools: {len(lines)} games summarized, samplesgfs "
        f"{sampled['kept']} poses ({view['illegal']} with an illegal "
        f"context move), writetrainingdata "
        f"{wtd['rows']} rows in the pinned schema, dataminesgfs {mined} "
        f"at {DATAMINE_VISITS} visits, checksgfhintpolicy {hint}; seconds "
        f"{json.dumps({k: round(v, 2) for k, v in seconds.items()})}; "
        f"launches {json.dumps(launches)}")
    return res


def run_genposes_phase(train: dict, dev, work: Path) -> dict:
    """Phase 18: genposes of GENPOSES_N clumpy positions at SIZE scored
    by phase 7's .bin.gz; genboard_cmd train at its defaults (8 blocks x
    96 channels, batch 16) for GENBOARD_STEPS steps on phase 17's games,
    then run filling a SIZE x SIZE board; the trained GenBoard's forward
    on the card and on the CPU within GENBOARD_ATOL."""
    import random

    from katago_torch.cli import genboard_cmd as GBC
    from katago_torch.cli import genposes_cmd as GP

    on = ["-device", str(dev)]
    out = work / "genposes.jsonl"
    printed, gp_launches, gp_s = _launches_of(_stdout_of, GP.main, [
        "-out", str(out), "-n", str(GENPOSES_N), "-size", str(SIZE),
        "-mode", "clumpy", "-model", train["bin_gz"]] + on)
    gp = json.loads(printed.splitlines()[-1])
    poses = [json.loads(ln) for ln in out.read_text().splitlines()]
    if gp["generated"] != GENPOSES_N or gp["kept"] != len(poses) or \
            not poses or any(p["xSize"] != SIZE for p in poses):
        raise AssertionError(f"genposes {gp}")
    _need_launches({"connected_labels": gp_launches["connected_labels"]},
                   "phase 18's genposes")
    pt = work / "genboard.pt"
    printed, gb_launches, train_s = _launches_of(_stdout_of, GBC.main, [
        "train", "-sgf-dir", str(work / "sgf17"), "-out", str(pt), "-size",
        str(SIZE), "-steps", str(GENBOARD_STEPS)] + on)
    trained = json.loads(printed.splitlines()[-1])
    # its examples come from SGF replays on the card
    _need_launches({"connected_labels": gb_launches["connected_labels"]},
                   "phase 18's genboard train")
    nn = SIZE * SIZE
    board = "X" + "." * (SIZE - 1) + "O" + "?" * (nn - SIZE - 1)
    t0 = time.time()
    text = _stdout_of(GBC.main, ["run", "-model", str(pt), "-board", board,
                                 "-batchsize", "2"] + on)
    torch.cuda.synchronize()
    run_s = time.time() - t0
    boards = [b.split() for b in text.split("\n\n") if b.strip()]
    if len(boards) != 2 or any(len(b) != nn or b[:SIZE + 1] != [
            "X"] + ["."] * (SIZE - 1) + ["O"] or not set(b) <= set(".XO")
            for b in boards):
        raise AssertionError(f"genboard run printed {text!r}")
    card, _ = GBC.load_model(str(pt), dev)
    cpu, _ = GBC.load_model(str(pt), "cpu")
    games = GBC.read_games(str(work / "sgf17"), SIZE)
    ex = GBC.make_examples(games, SIZE, 16, random.Random(SEED), device=dev)
    x_cpu, _, _ = GBC.batch_inputs(ex, SIZE, "cpu")
    with torch.no_grad():
        pc, ac = card(x_cpu.to(dev))
        pp, ap = cpu(x_cpu)
    err = max(float((pc.cpu() - pp).abs().max()),
              float((ac.cpu() - ap).abs().max()))
    if not err <= GENBOARD_ATOL:
        raise AssertionError(f"GenBoard card vs CPU differs by {err}")
    res = {"genposes": gp, "genposes_s": gp_s,
           "genposes_launches": gp_launches, "genboard_train": trained,
           "genboard_train_s": train_s, "genboard_launches": gb_launches, "genboard_run_s": run_s,
           "genboard_max_abs_err": err}
    log(f"phase genposes/genboard: genposes {gp} in {gp_s:.2f} s "
        f"(launches {gp_launches}); genboard train {GENBOARD_STEPS} steps "
        f"(8x96, batch 16) in {train_s:.2f} s (launches {gb_launches}), run of a {SIZE}x{SIZE} "
        f"board (2 fills, {nn} points) in {run_s:.2f} s; forward card vs "
        f"CPU within {err:.2e} (limit {GENBOARD_ATOL})")
    return res


def run_book_phase(train: dict, dev, work: Path) -> dict:
    """Phase 19: book_cmd genbook at SIZE on phase 7's .bin.gz (DescNet),
    BOOK_ROUNDS rounds of BOOK_NODES nodes at BOOK_VISITS visits (its
    searches run without ladder planes, so only K2 launches); the saved
    book loads back equal; then booktoposes (replaying each node's line
    on the card), findbookbottlenecks and writebook (one HTML page per
    node and an index)."""
    from katago_torch.book.book import Book
    from katago_torch.cli import book_cmd as BC

    path = work / "book.json"
    printed, launches, gen_s = _launches_of(_stdout_of, BC.main, [
        "genbook", "-book", str(path), "-model", train["bin_gz"], "-size",
        str(SIZE), "-visits", str(BOOK_VISITS), "-rounds", str(BOOK_ROUNDS),
        "-nodes-per-round", str(BOOK_NODES), "-device", str(dev)])
    gen = json.loads(printed.splitlines()[-1])
    rounds = printed.count("book round")
    if gen["nodes"] <= BOOK_ROUNDS or rounds != BOOK_ROUNDS:
        raise AssertionError(f"genbook: {printed!r}")
    _need_launches({"connected_labels": launches["connected_labels"]},
                   "phase 19's book")
    book = Book.load(str(path), dev)
    book.save(str(work / "book2.json"))
    if json.loads((work / "book2.json").read_text()) != \
            json.loads(path.read_text()):
        raise AssertionError("the saved book does not load back equal")
    on = ["-device", str(dev)]
    printed, poses_launches, poses_s = _launches_of(_stdout_of, BC.main, [
        "booktoposes", "-book", str(path), "-out-dir", str(work / "bposes"),
        "-enable-hints"] + on)
    poses = json.loads(printed)
    # booktoposes replays every node's line on the card
    _need_launches({"connected_labels": poses_launches["connected_labels"]},
                   "phase 19's booktoposes")
    t0 = time.time()
    necks = json.loads(_stdout_of(BC.main, [
        "findbookbottlenecks", "-book", str(path), "-out",
        str(work / "necks.jsonl")] + on))
    html = json.loads(_stdout_of(BC.main, [
        "writebook", "-book", str(path), "-out-dir", str(work / "html")]
        + on))
    host_s = time.time() - t0
    pages = len(list((work / "html").glob("*.html")))
    if poses["poses"] != gen["nodes"] or pages != gen["nodes"] + 1 or \
            html["nodes"] != gen["nodes"]:
        raise AssertionError(f"book tools: {poses}, {necks}, {pages} pages")
    res = {"nodes": gen["nodes"], "gen_s": gen_s, "host_s": host_s,
           "launches": launches,
           "launches_per_round": {k: v / BOOK_ROUNDS
                                  for k, v in launches.items()},
           "booktoposes_s": poses_s, "booktoposes_launches": poses_launches,
           "bottlenecks": necks["bottlenecks"]}
    log(f"phase book: genbook {BOOK_ROUNDS} rounds x {BOOK_NODES} nodes at "
        f"{BOOK_VISITS} visits -> {gen['nodes']} nodes in {gen_s:.2f} s "
        f"(launches {launches}); loads back equal; booktoposes "
        f"{poses['poses']} in {poses_s:.2f} s (launches {poses_launches}); "
        f"bottlenecks {necks['bottlenecks']} and {pages} html pages in "
        f"{host_s:.2f} s")
    return res


def run_contribute_phase(train: dict, dev, work: Path) -> dict:
    """Phase 20: contribute_cmd.main for one task against a stub server
    on 127.0.0.1 (a thread) that serves phase 7's .bin.gz with its
    sha256: download, verify, CONTRIB_GAMES selfplay games at
    CONTRIB_VISITS visits cut at CONTRIB_MOVES moves, upload; the server
    holds the uploaded npz to the pinned schema."""
    import base64
    import hashlib
    import io
    import threading
    from http.server import BaseHTTPRequestHandler, HTTPServer

    import numpy as np

    from katago_torch.cli import contribute_cmd as CC

    model = Path(train["bin_gz"]).read_bytes()
    digest = hashlib.sha256(model).hexdigest()
    uploads = []

    class Stub(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, body, ctype="application/json"):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.end_headers()
            self.wfile.write(body if isinstance(body, bytes)
                             else json.dumps(body).encode())

        def do_GET(self):
            if self.path == "/models/m.bin.gz":
                self._send(model, "application/octet-stream")
            else:
                self._send({"username": "smoke"})

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n)) if n else {}
            if self.path == "/api/tasks/":
                self._send({"id": "smoke-1", "kind": "selfplay",
                            "run": {"name": "smoke"}, "network": {
                                "name": "m", "model_file": "/models/m.bin.gz",
                                "model_file_sha256": digest}})
                return
            with np.load(io.BytesIO(base64.b64decode(body["npz_b64"]))) as z:
                arrays = {k: z[k] for k in z.files}
            _check_npz_schema(arrays, SIZE, "the uploaded npz")
            uploads.append((body, arrays["globalTargetsNC"].shape[0]))
            self._send({"ok": True})

    srv = HTTPServer(("127.0.0.1", 0), Stub)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        printed, launches, sec = _launches_of(_stdout_of, CC.main, [
            "-server", f"http://127.0.0.1:{srv.server_port}", "-username",
            "u", "-password", "p", "-base-dir", str(work / "contribute"),
            "-size", str(SIZE), "-visits", str(CONTRIB_VISITS),
            "-games-per-task", str(CONTRIB_GAMES), "-max-tasks", "1",
            "-max-moves", str(CONTRIB_MOVES), "-device", str(dev)])
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    from katago_torch.dataio import sgf as S
    if len(uploads) != 1 or uploads[0][1] != uploads[0][0]["num_rows"] or \
            uploads[0][1] <= 0 or json.loads(printed.splitlines()[-1]) != \
            {"tasks_completed": 1} or len(S.parse_sgf(
                uploads[0][0]["sgf"])[0].moves()) != CONTRIB_MOVES:
        raise AssertionError(f"contribute: {printed!r}")
    _need_launches(launches, "phase 20's contribute task")
    log(f"phase contribute: one task ({CONTRIB_GAMES} games x "
        f"{CONTRIB_MOVES} moves at {CONTRIB_VISITS} visits, "
        f"{uploads[0][1]} rows uploaded in the pinned schema) in {sec:.2f} "
        f"s; launches {launches}")
    return {"seconds": sec, "rows": uploads[0][1], "launches": launches}


def run_parallel_phase(dev, work: Path) -> dict:
    """Phase 21: train_cmd -multi-host at world size 1 on NCCL against
    the plain train_cmd: one step each of MODEL at batch TRAIN_BATCH on
    phase 6's shard, loss within CHECK_LOSS_RTOL and updates within
    CHECK_UPDATE_REL of the largest update; play_games(mesh=...) at world
    size 1 (MESH_GAMES games, MESH_MOVES moves at MESH_VISITS visits);
    then the fused actor-learner at bench.py main_fused's shape
    (FUSED_GAMES games, MODEL in bf16, FUSED_MOVES moves a chunk, learner
    batch FUSED_BATCH, SGD with momentum), visits cut to FUSED_VISITS,
    one step, the first at this shape (phase 22 times two more, warm):
    env-steps/s, playouts/s, the ring's filled, a finite loss and the
    step's launches."""
    from katago_torch.cli import selfplay_cmd as SP
    from katago_torch.cli import train_cmd as TCMD
    from katago_torch.parallel import mesh as PM
    from katago_torch.search.params import SearchParams
    from katago_torch.selfplay import fused as FU
    from katago_torch.selfplay.loop import play_games
    from katago_torch.selfplay.playsettings import PlaySettings
    from katago_torch.train import checkpoint as CK

    args = ["-data-dir", str(work / "tdata"), "-size", str(SIZE), "-config",
            MODEL, "-batch-size", str(TRAIN_BATCH), "-steps", "1", "-lr",
            str(TRAIN_LR), "-device", str(dev)]
    out = {}
    for name, extra in (("plain", []), ("multi_host", ["-multi-host"])):
        torch.cuda.synchronize()
        t0 = time.time()
        printed = _stdout_of(TCMD.main, args + ["-ckpt-dir",
                                                str(work / f"p21_{name}")]
                             + extra)
        out[name] = (json.loads(printed.splitlines()[-1]),
                     CK.load_state_tree(CK.latest_checkpoint(
                         str(work / f"p21_{name}")))["params"],
                     time.time() - t0)
    init = TCMD.make_model(SIZE, MODEL, "cpu", 0).state_dict()
    (s1, p1, t1), (s2, p2, t2) = out["plain"], out["multi_host"]
    loss_rel = abs(s2["final_loss"] - s1["final_loss"]) / \
        abs(s1["final_loss"])
    upd = max(float((p1[k].cpu() - init[k]).abs().max()) for k in init)
    upd_err = max(float((p2[k].cpu() - p1[k].cpu()).abs().max())
                  for k in init) / upd
    if not (loss_rel <= CHECK_LOSS_RTOL and upd_err <= CHECK_UPDATE_REL):
        raise AssertionError(f"-multi-host vs plain: loss {loss_rel:.2e}, "
                             f"updates {upd_err:.2e}")
    log(f"phase 21 multi-host: world size 1 on NCCL vs plain, loss within "
        f"{loss_rel:.2e} (limit {CHECK_LOSS_RTOL}), updates within "
        f"{upd_err:.2e} of the largest (limit {CHECK_UPDATE_REL}); "
        f"{t2:.2f} s vs {t1:.2f} s")

    model = SP.make_model(SIZE, MODEL, torch.bfloat16, dev, SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    mesh = PM.initialize_multihost(None, 1, 0, dev)
    try:
        (data, stats), mesh_launches, mesh_s = _launches_of(
            play_games, model, size=SIZE, num_games=MESH_GAMES,
            visits=MESH_VISITS, max_moves=MESH_MOVES, gen=gen,
            search_params=SearchParams.for_selfplay(),
            play_settings=PlaySettings.for_testing(MESH_VISITS), mesh=mesh)
    finally:
        PM.shutdown()
    if data.spatial.shape[0] != MESH_GAMES * MESH_MOVES or \
            stats["moves_per_game"].shape != (MESH_GAMES,):
        raise AssertionError(f"play_games(mesh) rows {data.spatial.shape}")
    _need_launches(mesh_launches, "phase 21's play_games(mesh)")
    log(f"phase 21 mesh: play_games at world size 1, {MESH_GAMES} games x "
        f"{MESH_MOVES} moves at {MESH_VISITS} visits, "
        f"{data.spatial.shape[0]} rows in {mesh_s:.2f} s; launches "
        f"{mesh_launches}")

    opt = torch.optim.SGD(model.parameters(), lr=1e-3, momentum=0.9)
    step = FU.make_fused_step(model, opt, size=SIZE, visits=FUSED_VISITS,
                              batch_size=FUSED_BATCH,
                              moves_per_chunk=FUSED_MOVES)
    games = FU.new_games(SIZE, FUSED_GAMES, device=dev)
    ring = FU.ReplayRing.create(max(4 * FUSED_GAMES * FUSED_MOVES, 4096),
                                SIZE, dev)
    _reset_kernel_counts()
    (games, metrics), launches, dt = _launches_of(step, games, ring, gen)
    loss = float(metrics["loss"])
    filled = int(ring.filled)
    if filled != FUSED_MOVES * FUSED_GAMES or not math.isfinite(loss):
        raise AssertionError(f"fused: filled {filled} (want "
                             f"{FUSED_MOVES * FUSED_GAMES}), loss {loss}")
    _need_launches(launches, "phase 21's fused step")
    env = FUSED_GAMES * FUSED_MOVES / dt
    res = {"multi_host_loss_rel": loss_rel, "multi_host_update_rel": upd_err,
           "mesh_s": mesh_s, "mesh_launches": mesh_launches,
           "fused_step_s": dt, "env_steps_per_s": env,
           "playouts_per_s": env * FUSED_VISITS, "filled": filled,
           "loss": loss, "fused_launches_per_step": launches}
    log(f"phase 21 fused: {FUSED_GAMES} games, {MODEL} bf16, "
        f"{FUSED_MOVES} moves a chunk at {FUSED_VISITS} visits, learner "
        f"batch {FUSED_BATCH}: one step (the first at this shape) in "
        f"{dt:.2f} s, {env:.2f} env-steps/s, {env * FUSED_VISITS:.1f} "
        f"playouts/s, ring filled {filled}, loss {loss:.4f}, launches "
        f"{launches}")
    return res


def _fused_mesh_vs_plain(dev) -> dict:
    """Phase 22's fused step with a mesh at world size 1 (NCCL) and the
    plain step, each one step of phase 21's shape from the same weights,
    games, empty ring and generator seed, with cuDNN deterministic: the
    rings, cursors and games equal exactly, the losses within
    FUSED22_LOSS_RTOL, the parameters within FUSED22_UPDATE_REL of the
    largest update; each step's seconds, env-steps/s and K1/K2 launches
    (counts set to 0 before each step and read after it). The mesh's
    first collective, which sets up the NCCL communicator once per
    process group, is made and timed before its step."""
    from katago_torch.cli import selfplay_cmd as SP
    from katago_torch.parallel import mesh as PM
    from katago_torch.selfplay import fused as FU

    model = SP.make_model(SIZE, MODEL, torch.bfloat16, dev, SEED)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    cap = max(4 * FUSED_GAMES * FUSED_MOVES, 4096)
    runs = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name in ("plain", "mesh"):
            model.load_state_dict(init)
            opt = torch.optim.SGD(model.parameters(), lr=1e-3, momentum=0.9)
            mesh = PM.initialize_multihost(None, 1, 0, dev) \
                if name == "mesh" else None
            try:
                if mesh is not None:
                    t0 = time.time()
                    PM.all_reduce_sum([torch.zeros(1, device=dev)], mesh)
                    torch.cuda.synchronize()
                    nccl_setup_s = time.time() - t0
                step = FU.make_fused_step(
                    model, opt, size=SIZE, visits=FUSED_VISITS,
                    batch_size=FUSED_BATCH, moves_per_chunk=FUSED_MOVES,
                    mesh=mesh)
                games = FU.new_games(SIZE, FUSED_GAMES, device=dev,
                                     mesh=mesh)
                ring = FU.ReplayRing.create(cap, SIZE, dev, mesh)
                gen = torch.Generator(device=dev).manual_seed(SEED + 22)
                _reset_kernel_counts()
                torch.cuda.synchronize()
                t0 = time.time()
                games, metrics = step(games, ring, gen)
                torch.cuda.synchronize()
                secs = time.time() - t0
                launches = _kernel_counts()
            finally:
                if mesh is not None:
                    PM.shutdown()
            _need_launches(launches, f"phase 22's {name} fused step")
            runs[name] = {
                "ring": ring, "stones": games.pos.board.stones,
                "loss": float(metrics["loss"]), "seconds": secs,
                "launches": launches,
                "params": {k: v.detach().clone()
                           for k, v in model.state_dict().items()}}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    plain, mesh = runs["plain"], runs["mesh"]
    for k in FU.RING_FIELDS:
        if not torch.equal(plain["ring"].rows(k), mesh["ring"].rows(k)):
            raise AssertionError(f"phase 22: ring {k} differs")
    if int(plain["ring"].cursor) != int(mesh["ring"].cursor) or \
            int(plain["ring"].filled) != int(mesh["ring"].filled) or \
            not torch.equal(plain["stones"], mesh["stones"]):
        raise AssertionError("phase 22: cursor, filled or games differ")
    loss_rel = abs(mesh["loss"] - plain["loss"]) / abs(plain["loss"])
    upd = max(float((plain["params"][k].float() - init[k].float()).abs()
                    .max()) for k in init)
    upd_err = max(float((mesh["params"][k].float() -
                         plain["params"][k].float()).abs().max())
                  for k in init) / upd
    if not (loss_rel <= FUSED22_LOSS_RTOL and upd_err <= FUSED22_UPDATE_REL
            and math.isfinite(plain["loss"])):
        raise AssertionError(f"phase 22: mesh vs plain loss {loss_rel:.2e}, "
                             f"updates {upd_err:.2e}")
    filled = int(mesh["ring"].filled)
    out = {"fused22_filled": filled, "fused22_loss_rel": loss_rel,
           "fused22_update_rel": upd_err,
           "fused22_nccl_setup_s": nccl_setup_s}
    for name, r in runs.items():
        env = FUSED_GAMES * FUSED_MOVES / r["seconds"]
        out[f"fused22_{name}"] = {
            "seconds": r["seconds"], "env_steps_per_s": env,
            "playouts_per_s": env * FUSED_VISITS, "launches": r["launches"],
            "loss": r["loss"]}
        log(f"phase 22 fused {name}: {FUSED_GAMES} games, {MODEL} bf16, "
            f"{FUSED_MOVES} moves at {FUSED_VISITS} visits, batch "
            f"{FUSED_BATCH}: {r['seconds']:.2f} s, {env:.2f} env-steps/s, "
            f"launches {r['launches']}")
    log(f"phase 22 fused: mesh at world size 1 (NCCL, its first "
        f"collective {nccl_setup_s:.2f} s before the step) vs plain, ring "
        f"({filled} rows), cursor and games equal, loss within "
        f"{loss_rel:.2e} (limit {FUSED22_LOSS_RTOL}), parameters within "
        f"{upd_err:.2e} of the largest update (limit {FUSED22_UPDATE_REL})")
    del runs, model, init
    torch.cuda.empty_cache()
    return out


def _jax_import_on_card(dev, work: Path) -> dict:
    """Phase 22's import of a JAX trainer's checkpoint: the SGD run of
    tests/data/torch_ref/jax_ckpt.npz (its tools/jax_checkpoint_to_npz.py
    arrays and metadata, and the shards it trained on) through
    checkpoint_tools_cmd import-jax, then one train_cmd step on the card
    (float32, TF32 off): parameters within JAX_IMPORT_ATOL of the JAX
    step's, the loss within JAX_IMPORT_ATOL relative."""
    import numpy as np

    from katago_torch.cli import checkpoint_tools_cmd as CT
    from katago_torch.cli import train_cmd as TCMD
    from katago_torch.models import weights as W
    from katago_torch.train import checkpoint as CK

    with np.load(REF_DIR / "jax_ckpt.npz") as z:
        ref = {k: z[k] for k in z.files}
    meta = json.loads(str(ref.pop("meta")))
    run, tr = meta["runs"]["sgd"], meta["run_training"]
    d = work / "p22_jax"
    data = d / "data"
    data.mkdir(parents=True)
    for i in range(len(meta["shards"])):
        pre = f"shard{i:03d}/"
        np.savez_compressed(data / f"shard{i:03d}.npz", **{
            k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)})
    npz = d / "sgd.npz"
    np.savez(npz, **{k[len("sgd/npz/"):]: v for k, v in ref.items()
                     if k.startswith("sgd/npz/")})
    (d / "sgd.npz.json").write_text(json.dumps(run["metadata"]))
    ckpt = d / "ckpt"
    t0 = time.time()
    _stdout_of(CT.main, ["import-jax", "-npz", str(npz), "-ckpt-dir",
                         str(ckpt), "-config", tr["config_name"], "-size",
                         str(tr["size"]), "-optimizer", "sgd", "-data-dir",
                         str(data)])
    import_s = time.time() - t0
    t0 = time.time()
    printed = _stdout_of(TCMD.main, [
        "-data-dir", str(data), "-ckpt-dir", str(ckpt), "-size",
        str(tr["size"]), "-config", tr["config_name"], "-batch-size",
        str(tr["batch_size"]), "-steps", "1", "-lr", str(tr["lr"]),
        "-device", str(dev)])
    resume_s = time.time() - t0
    latest = CK.latest_checkpoint(str(ckpt))
    if CK.load_metadata(latest)["global_step"] != run["next_global_step"]:
        raise AssertionError(f"phase 22 import: resumed to {latest}")
    got = W.to_flax_params(CK.load_state_tree(latest)["params"])
    err = 0.0
    for key, want in ref.items():
        if not key.startswith("sgd/next/params/"):
            continue
        node = got
        for name in key.split("/")[3:]:
            node = node[name]
        err = max(err, float(np.abs(node - want).max()))
    loss = json.loads(printed.splitlines()[-1])["final_loss"]
    loss_rel = abs(loss - run["next_metrics"]["loss"]) / \
        abs(run["next_metrics"]["loss"])
    if not (err <= JAX_IMPORT_ATOL and loss_rel <= JAX_IMPORT_ATOL):
        raise AssertionError(f"phase 22 import: parameters within {err:.2e},"
                             f" loss within {loss_rel:.2e} of JAX's step")
    log(f"phase 22 import: a JAX orbax checkpoint ({tr['config_name']} at "
        f"{tr['size']}x{tr['size']}, SGD, step {run['metadata']['global_step']}"
        f") imported in {import_s:.2f} s, one train_cmd step on the card in "
        f"{resume_s:.2f} s: parameters within {err:.2e}, loss within "
        f"{loss_rel:.2e} of the JAX step (limit {JAX_IMPORT_ATOL})")
    return {"import_s": import_s, "import_resume_s": resume_s,
            "import_param_err": err, "import_loss_rel": loss_rel}


def _host_libraries(work: Path) -> dict:
    """Phase 22's C++ host libraries (built in phase 1): the scanner on
    every record of phase 17 (its .sgf files and phase 6's .sgfs) equal to
    the parser, summarize_sgfs through each equal, the time per game of
    each; the 7 symmetries of phase 7's batch (TRAIN_BATCH rows of phase
    6's shard: planes and policy rows) equal to numpy, ms per call of
    each."""
    import numpy as np

    from katago_torch.cli import summarize_sgfs_cmd as SUM
    from katago_torch.dataio import native as NV
    from katago_torch.dataio import sgfscan as SC
    from katago_torch.dataio import trainingwrite as TW

    files = sorted((work / "sgf17").glob("*.sgf")) + \
        sorted(work.glob("tdata_*.sgfs"))
    records = [ln.strip() for f in files for ln in f.read_text().split("\n")
               if ln.strip()]
    for r in records:
        if SC.scan_sgf(r) != SC.scan_sgf_plain(r):
            raise AssertionError(f"phase 22: the scanner differs on {r!r}")
    per_game = {}
    for name, fn in (("scanner", SC.scan_sgf), ("parser", SC.scan_sgf_plain)):
        t0 = time.perf_counter()
        for _ in range(SCAN_REPEATS):
            for r in records:
                fn(r)
        per_game[name] = (time.perf_counter() - t0) / SCAN_REPEATS / \
            len(records) * 1e3
    summary = _stdout_of(SUM.main, [str(work / "sgf17")])
    SUM.scan_sgf = SC.scan_sgf_plain
    try:
        plain_summary = _stdout_of(SUM.main, [str(work / "sgf17")])
    finally:
        SUM.scan_sgf = SC.scan_sgf
    if summary != plain_summary:
        raise AssertionError("phase 22: summarize_sgfs differs")

    shard = next((work / "tdata").glob("*.npz"))
    with np.load(shard) as z:
        rows = TW.decode_rows({k: z[k][:TRAIN_BATCH] for k in z.files},
                              SIZE)
    planes = np.ascontiguousarray(rows["binaryInputNCHW"])
    policy = np.ascontiguousarray(
        rows["policyTargetsNCMove"].reshape(-1, SIZE * SIZE + 1))
    cases = {"planes": (planes, NV.apply_symmetry_planes,
                        NV.apply_symmetry_planes_plain, ()),
             "policy": (policy, NV.apply_symmetry_policy,
                        NV.apply_symmetry_policy_plain, (SIZE,))}
    sym_ms = {}
    for name, (x, lib, plain, extra) in cases.items():
        for sym in range(1, 8):
            if not np.array_equal(lib(x, *extra, sym), plain(x, *extra, sym)):
                raise AssertionError(f"phase 22: {name} symmetry {sym}")
        for tag, fn in (("library", lib), ("numpy", plain)):
            t0 = time.perf_counter()
            for _ in range(SYM_REPEATS):
                for sym in range(1, 8):
                    fn(x, *extra, sym)
            sym_ms[f"{name}_{tag}"] = (time.perf_counter() - t0) / \
                SYM_REPEATS / 7 * 1e3
    log(f"phase 22 host: the scanner equals the parser on {len(records)} "
        f"records (summarize_sgfs too): {per_game['scanner']:.4f} vs "
        f"{per_game['parser']:.4f} ms per game; symmetries of "
        f"{planes.shape} planes and {policy.shape} policy rows equal numpy, "
        f"ms per call {json.dumps({k: round(v, 4) for k, v in sym_ms.items()})}")
    return {"scan_records": len(records), "scan_ms_per_game": per_game,
            "symmetry_ms": sym_ms}


def run_slice9_phase(dev, work: Path) -> dict:
    """Phase 22: the fused step across ranks against the plain step, the
    JAX checkpoint import resumed on the card, and the C++ host
    libraries against their plain versions."""
    out = _fused_mesh_vs_plain(dev)
    out.update(_jax_import_on_card(dev, work))
    out.update(_host_libraries(work))
    log("phase 22 json " + json.dumps(out))
    return out


def run_m12_phases(train: dict, dev, work: Path, which=None) -> dict:
    """Phases 17-22 (or the ones named in which), each timed; returns
    their results by number."""
    phases = {"17": lambda: run_sgftools_phase(train, dev, work),
              "18": lambda: run_genposes_phase(train, dev, work),
              "19": lambda: run_book_phase(train, dev, work),
              "20": lambda: run_contribute_phase(train, dev, work),
              "21": lambda: run_parallel_phase(dev, work),
              "22": lambda: run_slice9_phase(dev, work)}
    out = {}
    for name, run in phases.items():
        if which is not None and name not in which:
            continue
        t0 = time.time()
        out[name] = run()
        torch.cuda.empty_cache()
        out[name]["phase_s"] = time.time() - t0
        log(f"phase {name} in {out[name]['phase_s']:.1f} s")
    return out


def _m12_launches(m12: dict, kernel: str) -> dict:
    """The kernels line's counts of phases 17-21 for one kernel."""
    return {
        "launches_sgftools_per_datamine":
            m12["17"]["launches"]["dataminesgfs"][kernel],
        "launches_writetrainingdata":
            m12["17"]["launches"]["writetrainingdata"][kernel],
        "launches_genposes_per_batch":
            m12["18"]["genposes_launches"][kernel],
        "launches_genboard_train": m12["18"]["genboard_launches"][kernel],
        "launches_book_per_round": m12["19"]["launches_per_round"][kernel],
        "launches_booktoposes": m12["19"]["booktoposes_launches"][kernel],
        "launches_contribute_per_task": m12["20"]["launches"][kernel],
        "launches_mesh_play_games": m12["21"]["mesh_launches"][kernel],
        "launches_fused_per_step":
            m12["21"]["fused_launches_per_step"][kernel],
        "launches_fused_mesh_step":
            m12["22"]["fused22_mesh"]["launches"][kernel]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path, default=None)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from katago_torch.game import history as H
    from katago_torch.game import ladder as LAD
    from katago_torch.game import rules as R
    from katago_torch.models import config as MC
    from katago_torch.models import model as M
    from katago_torch.models import weights as W
    from katago_torch.ops import cases as CASES
    from katago_torch.ops import chase as K1
    from katago_torch.ops import labels as K2
    from katago_torch.search import mcts
    from katago_torch.search.driver import SearchDriver
    from katago_torch.search.params import SearchParams

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    log(f"card: {smi}")
    dev = torch.device("cuda")
    nn = SIZE * SIZE
    old = {}

    # ---- 1. build ----
    t, t_host = build_everything()
    log(f"phase build: both kernels built in {t:.1f} s, both host "
        f"libraries in {t_host:.1f} s (in parallel)")
    if opts.baseline is not None:
        old, t = build_baseline(opts.baseline)
        log(f"phase build: old kernels from {opts.baseline} built in "
            f"{t:.1f} s")

    # ---- 2. K2 vs plain ----
    k2_err = 0
    for name, vals in CASES.label_cases(SIZE, GAMES, SEED).items():
        vals = vals.to(dev)
        got = K2.connected_labels(vals, SIZE)
        ref = K2.connected_labels_plain(vals, SIZE)
        k2_err = max(k2_err, int((got - ref).abs().max()))
        if not torch.equal(got, ref):
            raise AssertionError(f"K2 differs from its plain version on "
                                 f"{name} ({int((got != ref).sum())} points)")
        if old:
            launch, out = old_labels(old["labels"], vals)
            launch()
            if not torch.equal(out, ref):
                raise AssertionError(f"the old K2 differs on {name}")
    # main-path shape: the boards of one leaf batch
    boards = CASES.random_boards(GAMES, SIZE, SEED + 1).to(dev)

    def k2_call():
        K2.connected_labels(boards, SIZE)
    k2_ms = device_ms(k2_call, 200)
    k2_host = host_us(k2_call, 1000)
    k2_plain_ms = event_ms(lambda: K2.connected_labels_plain(boards, SIZE),
                           10)
    k2_bytes = 2 * GAMES * nn * 4
    k2_ops = 5 * GAMES * nn          # compare, link and find per point
    k2_bound = max(k2_bytes / HBM_BYTES_PER_S, k2_ops / INT_OPS_PER_S) * 1e3
    log(f"phase K2: exact on every case; device-only {k2_ms:.5f} ms/call "
        f"vs plain {k2_plain_ms:.4f} ms at [{GAMES}, {nn}], bound "
        f"{k2_bound:.5f} ms")
    log(f"host K2: wrapper {k2_host:.2f} us/call (host clock over 1000 "
        f"calls, no sync)")
    if old:
        o, n = in_turns(old_labels(old["labels"], boards)[0], k2_call, 200)
        log(f"turns K2 device-only ms/call: old {o[0]:.5f}, new "
            f"{n[0]:.5f}, new {n[1]:.5f}, old {o[1]:.5f}")

    # ---- 3. K1 vs plain ----
    steps = LAD.default_max_steps(SIZE)
    st, ko = CASES.chase_boards(GAMES, SIZE, SEED + 2)
    st, ko = st.to(dev), ko.to(dev)
    ctx = LAD._chase_setup(st, SIZE, 16, ko)
    lane_args = LAD.chase_lane_inputs(st, ctx, 16)
    lanes = lane_args[0].shape[0]
    k1_cases = [("main", lane_args, steps)]
    for name, (cst, cko, mx) in CASES.chase_cases(SIZE, GAMES, SEED + 3,
                                                  steps).items():
        cst = cst.to(dev)
        cctx = LAD._chase_setup(cst, SIZE, 16, cko.to(dev))
        k1_cases.append((name, LAD.chase_lane_inputs(cst, cctx, 16), mx))
    # each branch of K1.EVENTS must be driven by the case built for it
    k1_need = {"dense": K1.EVENTS[:4], "ladder_cut": ("max_steps",)}
    k1_err = 0
    plain_stats = {}
    for name, args, mx in k1_cases:
        got = K1.chase_lanes(*args, size=SIZE, max_steps=mx)
        stats = {}
        ref = K1.chase_lanes_plain(*args, size=SIZE, max_steps=mx,
                                   stats=stats)
        k1_err = max(k1_err, int((got.int() - ref.int()).abs().max()))
        if not torch.equal(got, ref):
            raise AssertionError(f"K1 differs from its plain version on "
                                 f"{name} ({int((got != ref).sum())} lanes)")
        missed = [e for e in k1_need.get(name, ()) if not stats["events"][e]]
        if missed:
            raise AssertionError(f"K1 case {name} did not reach {missed}")
        if old:
            launch, out = old_chase(old["chase"], args, mx)
            launch()
            if not torch.equal(out != 0, ref):
                raise AssertionError(f"the old K1 differs on {name}")
        if name == "main":
            plain_stats = stats
            n_captured = int(ref.sum())
        log(f"K1 case {name}: exact on {args[0].shape[0]} lanes "
            f"({int(args[6].sum())} active, max_steps {mx}), "
            f"{stats['lane_plies']} lane-plies, longest lane "
            f"{stats['max_lane_plies']} plies, events {stats['events']}")
    n_active = int(lane_args[6].sum())

    def k1_call():
        K1.chase_lanes(*lane_args, size=SIZE, max_steps=steps)
    k1_ms = device_ms(k1_call, 20)
    k1_host = host_us(k1_call, 50)
    k1_plain_ms = event_ms(lambda: K1.chase_lanes_plain(
        *lane_args, size=SIZE, max_steps=steps), 3)
    # what the function needs: the active lanes' stones and rep, defender
    # and premove (labels and hlibs are the stones' analysis, which the
    # kernel recomputes), active read and out written for every lane
    k1_bytes = n_active * (nn + 3) * 4 + 2 * lanes
    # lower bound: two passes over the board's rows (one 32-bit op per
    # row) per lane-ply actually played
    k1_ops = 2 * SIZE * plain_stats["lane_plies"]
    k1_bound = max(k1_bytes / HBM_BYTES_PER_S, k1_ops / INT_OPS_PER_S) * 1e3
    k1_bound_by = "bytes" if k1_bytes / HBM_BYTES_PER_S >= \
        k1_ops / INT_OPS_PER_S else "operations"
    log(f"phase K1: exact on {lanes} lanes ({n_active} active, "
        f"{n_captured} captured, {plain_stats['lane_plies']} lane-plies, "
        f"longest lane {plain_stats['max_lane_plies']} plies); device-only "
        f"{k1_ms:.5f} ms/call vs plain {k1_plain_ms:.4f} ms, bound "
        f"{k1_bound:.5f} ms ({k1_bound_by}: {k1_bytes} B, {k1_ops} ops)")
    log(f"host K1: wrapper {k1_host:.2f} us/call (host clock over 50 "
        f"calls, no sync)")
    if old:
        o, n = in_turns(old_chase(old["chase"], lane_args, steps)[0],
                        k1_call, 20)
        log(f"turns K1 device-only ms/call: old {o[0]:.5f}, new "
            f"{n[0]:.5f}, new {n[1]:.5f}, old {o[1]:.5f}")
    if old:
        log("baseline: phases 4-6 skipped, no result line")
        return 0

    # ---- 4. net forward ----
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cfg = MC.get_config(MODEL)
    model = W.init_weights(M.KataGoModel(cfg, SIZE, torch.bfloat16),
                           seed=SEED).to(dev).eval()
    spatial = (torch.rand((GAMES, SIZE, SIZE, 22), generator=gen,
                          device=dev) < 0.2).float()
    spatial[..., 0] = 1.0
    glob = torch.randn((GAMES, 19), generator=gen, device=dev)
    with torch.no_grad():
        out = model(spatial, glob)
    for k, v in out.items():
        if not torch.isfinite(v).all():
            raise AssertionError(f"net output {k} is not finite")
    assert out["policy_logits"].shape == (GAMES, 6, nn + 1)
    with torch.no_grad():
        net_ms = event_ms(lambda: model(spatial, glob), 10)
    log(f"phase net: {MODEL} bf16 batch {GAMES} finite; {net_ms:.3f} ms "
        f"per forward")

    # ---- 5. search ----
    sp = SearchParams.for_selfplay().to_arr(dev)
    driver = SearchDriver(model, sp, size=SIZE, max_nodes=VISITS + 3,
                          chunk_size=CHUNK, with_ladders=True, device=dev)
    roots = H.new_game(SIZE, R.Rules.tromp_taylorish(), 160, g=GAMES,
                       device=dev)
    K1.reset_launches()
    K2.reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    res = driver.search(roots, gen, max_visits=VISITS + 1)
    torch.cuda.synchronize()
    dt1 = time.time() - t0
    launches = {"chase_lanes": K1.launches, "connected_labels": K2.launches}
    rv = res.root_visits
    if not bool((rv == VISITS + 1).all()):
        raise AssertionError(f"root visits {rv.min().item()}..."
                             f"{rv.max().item()}, want {VISITS + 1}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched by the search")
    for k in ("root_winloss", "root_utility", "root_ownership"):
        if not torch.isfinite(getattr(res, k)).all():
            raise AssertionError(f"{k} is not finite")
    log(f"phase search 1: {GAMES} games x {VISITS} visits in {dt1:.2f} s "
        f"({GAMES * VISITS / dt1:.1f} playouts/s), launches {launches}")
    moves = mcts.choose_moves(res, sp, roots.pos.move_num, gen)
    if not bool(H.legal_moves(roots, SIZE).gather(1, moves[:, None]).all()):
        raise AssertionError("a chosen move is illegal")

    # ---- 6-8. selfplay, the trainer on its shard, selfplay from the export
    check_exact_ladders(dev)
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        sp_out = run_selfplay_phase(model, gen, dev, work)
        del model, driver, res
        torch.cuda.empty_cache()
        train = run_train_phase(work, dev)
        run_models_dir_phase(work, dev)
        torch.cuda.empty_cache()

        # ---- 9-10. the GTP and analysis engines on the exported net ----
        log(f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
            f"cudnn={torch.backends.cudnn.allow_tf32} (DescNet runs with "
            "both off)")
        check_desc_net(train["bin_gz"], train["export"],
                       next((work / "tdata").glob("*.npz")), dev)
        gtp_out = run_gtp_phase(train["bin_gz"], dev, work)
        one = one_game_kernel_times(dev)
        an_out = run_analysis_phase(train["bin_gz"], dev)
        torch.cuda.empty_cache()

        # ---- 11-13. humanSL serving, the transformer family, the others
        hsl = run_humansl_phase(dev, work)
        torch.cuda.empty_cache()
        tfo = run_transformer_phase(dev, work)
        torch.cuda.empty_cache()
        fam = run_families_phase(dev, work)
        torch.cuda.empty_cache()

        # ---- 14-16. the match and gatekeeper, the loop, the tools ----
        match = run_match_phase(train, dev, work)
        torch.cuda.empty_cache()
        loop = run_loop_phase(dev, work)
        torch.cuda.empty_cache()
        tools = run_tools_phase(train, dev, work)
        torch.cuda.empty_cache()

        # ---- 17-22. the SGF tools, genposes and genboard, the book,
        # contribute, data parallelism and the fused actor-learner, the
        # fused step across ranks, the JAX import, the host libraries ----
        m12 = run_m12_phases(train, dev, work)

    # ---- 23. report ----
    log(f"playouts_per_s {GAMES * VISITS / dt1:.1f} (search 1), "
        f"{sp_out['playouts_per_s']:.1f} (selfplay, {SP_VISITS} visits, "
        f"tree reuse), {1e3 / gtp_out['playout_ms']:.1f} (one GTP game), "
        f"{1e3 / hsl['playout_ms']:.1f} (one humanSL GTP game), "
        f"{tfo['selfplay']['playouts_per_s']:.1f} ({TF_MODEL} selfplay), "
        f"{fam['b28_playouts_per_s']:.1f} ({B28_MODEL} search, "
        f"{B28_VISITS} visits), {match['playouts_per_s']:.1f} (match, "
        f"{MATCH_GAMES} games, {MATCH_VISITS} visits, float32), "
        f"{m12['21']['playouts_per_s']:.1f} (fused actor-learner, "
        f"{FUSED_GAMES} games, {FUSED_VISITS} visits)")
    kernels = [
        {"name": "chase_lanes", "route": "cuda",
         "source": "katago_torch/ops/csrc/chase.cu",
         "replaces": "katago_tpu/ops/chase_pallas.py:456",
         "launches": launches["chase_lanes"],
         "launches_selfplay": sp_out["launches"]["chase_lanes"],
         "launches_gtp": gtp_out["launches"]["chase_lanes"],
         "launches_analysis": an_out["launches"]["chase_lanes"],
         "launches_humansl_per_genmove":
             hsl["launches_per_genmove"]["chase_lanes"],
         "launches_transformer_selfplay_per_move":
             tfo["selfplay"]["launches"]["chase_lanes"]
             / tfo["selfplay"]["moves"],
         "launches_b28_search": fam["b28_launches"]["chase_lanes"],
         "launches_match_per_move":
             match["launches_per_move"]["chase_lanes"],
         "launches_gatekeeper": match["gate_launches"]["chase_lanes"],
         "launches_loop_cycle": loop["launches"]["chase_lanes"],
         "launches_tools": tools["launches"]["chase_lanes"],
         **_m12_launches(m12, "chase_lanes"),
         "ms_one_game": one["k1_ms"], "plain_ms_one_game": one["k1_plain_ms"],
         "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_bound_by, "library_ms": None},
        {"name": "connected_labels", "route": "cuda",
         "source": "katago_torch/ops/csrc/labels.cu",
         "replaces": "katago_tpu/ops/labels_pallas.py:138",
         "launches": launches["connected_labels"],
         "launches_selfplay": sp_out["launches"]["connected_labels"],
         "launches_gtp": gtp_out["launches"]["connected_labels"],
         "launches_analysis": an_out["launches"]["connected_labels"],
         "launches_humansl_per_genmove":
             hsl["launches_per_genmove"]["connected_labels"],
         "launches_transformer_selfplay_per_move":
             tfo["selfplay"]["launches"]["connected_labels"]
             / tfo["selfplay"]["moves"],
         "launches_b28_search": fam["b28_launches"]["connected_labels"],
         "launches_match_per_move":
             match["launches_per_move"]["connected_labels"],
         "launches_gatekeeper": match["gate_launches"]["connected_labels"],
         "launches_loop_cycle": loop["launches"]["connected_labels"],
         "launches_tools": tools["launches"]["connected_labels"],
         **_m12_launches(m12, "connected_labels"),
         "ms_one_game": one["k2_ms"], "plain_ms_one_game": one["k2_plain_ms"],
         "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
         "bound_by": "bytes" if k2_bytes / HBM_BYTES_PER_S >=
         k2_ops / INT_OPS_PER_S else "operations", "library_ms": None},
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
