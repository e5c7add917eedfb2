"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):
  1. build both CUDA kernels from katago_torch/ops/csrc (one nvcc each,
     in parallel) and print the build time;
  2. K2 connected_labels vs its plain torch version on 128 random 19x19
     boards plus a snake and an empty board — exact equality;
  3. K1 chase_lanes vs its plain torch version on the 4096 lanes that
     _chase_setup builds from 128 random mid-game 19x19 positions (ko and
     atari boards included) — exact equality;
  4. the b18c384nbt net in bfloat16 at batch 128 — finite outputs;
  5. SearchDriver.search at 19x19, b18c384nbt, bf16, 128 games,
     SearchParams.for_selfplay(), ladder planes on, chunks of 200, 600
     visits: every game reaches visits+1 and both kernels' launch counters
     rise during the search; then each game plays its chosen move and a
     second search runs from the new position;
  6. report: the card's name and power limit, each kernel's time beside
     its plain version's and its bound, launches per search, playouts/s,
     a `kernels` JSON line, and the result line last.

Weights are random (seeded); the bound of a kernel is the larger of its
bytes (each input read once, each output written once) over 3.35 TB/s
and a lower bound of its integer operations over 67 Tops/s (the H100
SXM's non-tensor 32-bit rate).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

SIZE = 19
GAMES = 128
VISITS = 600
CHUNK = 200
MODEL = "b18c384nbt"
SEED = 0
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12


def log(*a):
    print(*a, flush=True)


def gpu_time_ms(fn, reps):
    """Median of per-call CUDA-event times (after one warm-up call)."""
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


def remove_dead(st):
    """Clear libertyless chains so boards are reachable positions."""
    from katago_torch.game import board as B
    from katago_torch.game import ladder as LAD
    lab = LAD._stone_labels(st, SIZE)
    libs = B.chain_liberties(st, lab, SIZE)
    return torch.where((st > 0) & (libs == 0), 0, st).to(torch.int32)


def random_boards(g, seed, dev):
    """Seeded random mid-game boards (15-60% of points occupied)."""
    gen = torch.Generator().manual_seed(seed)
    nn = SIZE * SIZE
    dens = torch.rand((g, 1), generator=gen) * 0.45 + 0.15
    u = torch.rand((g, nn), generator=gen)
    st = torch.where(u < dens / 2, 1, torch.where(u < dens, 2, 0))
    return remove_dead(st.to(torch.int32).to(dev))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from katago_torch.game import history as H
    from katago_torch.game import ladder as LAD
    from katago_torch.game import rules as R
    from katago_torch.models import config as MC
    from katago_torch.models import model as M
    from katago_torch.models import weights as W
    from katago_torch.ops import _build
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
    dev = torch.device("cuda")
    nn = SIZE * SIZE

    # ---- 1. build ----
    t = _build.build_all()
    log(f"phase build: both kernels built in {t:.1f} s")

    # ---- 2. K2 vs plain ----
    gen = torch.Generator(device=dev).manual_seed(SEED)
    vals = torch.randint(0, 3, (GAMES, nn), generator=gen, device=dev,
                         dtype=torch.int32)
    extra = torch.stack([torch.ones(nn, dtype=torch.int32, device=dev),
                         torch.zeros(nn, dtype=torch.int32, device=dev)])
    vals_all = torch.cat([vals, extra])
    got = K2.connected_labels(vals_all, SIZE)
    ref = K2.connected_labels_plain(vals_all, SIZE)
    k2_err = int((got - ref).abs().max())
    if not torch.equal(got, ref):
        raise AssertionError(f"K2 differs from its plain version "
                             f"({int((got != ref).sum())} points)")
    # main-path shape: the boards of one leaf batch
    boards = random_boards(GAMES, SEED + 1, dev)
    k2_ms = gpu_time_ms(lambda: K2.connected_labels(boards, SIZE), 50)
    k2_plain_ms = gpu_time_ms(lambda: K2.connected_labels_plain(boards, SIZE),
                              10)
    k2_bytes = 2 * GAMES * nn * 4
    k2_ops = 5 * GAMES * nn          # one propagate + jump sweep per point
    k2_bound = max(k2_bytes / HBM_BYTES_PER_S, k2_ops / INT_OPS_PER_S) * 1e3
    log(f"phase K2: exact on {GAMES}+2 boards; {k2_ms:.4f} ms/call vs plain "
        f"{k2_plain_ms:.4f} ms at [{GAMES}, {nn}], bound {k2_bound:.5f} ms")

    # ---- 3. K1 vs plain ----
    st = random_boards(GAMES, SEED + 2, dev)
    # ko / atari boards: a lone stone in atari inside a ko mouth
    for i in range(0, 8):
        b = st[i].reshape(SIZE, SIZE)
        y, x = 3 + 2 * i, 3 + i
        b[y - 1:y + 2, x - 1:x + 2] = 0
        b[y, x] = 2
        b[y - 1, x] = b[y, x - 1] = b[y, x + 1] = 1
    st = remove_dead(st)
    ko = torch.full((GAMES,), -1, dtype=torch.int64, device=dev)
    ko[8:16] = torch.arange(8, 16, device=dev) * 7
    ctx = LAD._chase_setup(st, SIZE, 16, ko)
    k2x = 32
    i32 = torch.int32
    lane_args = (
        st.repeat_interleave(k2x, 0),
        ctx["labels"].to(i32).repeat_interleave(k2x, 0),
        ctx["libs"].to(i32).repeat_interleave(k2x, 0),
        ctx["reps"].reshape(-1).to(i32), ctx["defenders"].reshape(-1).to(i32),
        ctx["premoves"].reshape(-1).to(i32), ctx["active"].reshape(-1))
    steps = LAD.default_max_steps(SIZE)
    lanes = lane_args[0].shape[0]
    got = K1.chase_lanes(*lane_args, size=SIZE, max_steps=steps)
    plain_stats = {}
    ref = K1.chase_lanes_plain(*lane_args, size=SIZE, max_steps=steps,
                               stats=plain_stats)
    k1_err = int((got.int() - ref.int()).abs().max())
    if not torch.equal(got, ref):
        raise AssertionError(f"K1 differs from its plain version "
                             f"({int((got != ref).sum())} lanes)")
    n_active = int(lane_args[6].sum())
    k1_ms = gpu_time_ms(lambda: K1.chase_lanes(*lane_args, size=SIZE,
                                               max_steps=steps), 30)
    k1_plain_ms = gpu_time_ms(lambda: K1.chase_lanes_plain(
        *lane_args, size=SIZE, max_steps=steps), 3)
    k1_bytes = 3 * lanes * nn * 4 + 3 * lanes * 4 + 2 * lanes
    # lower bound: two board scans per lane-ply actually played
    k1_ops = 2 * nn * plain_stats["lane_plies"]
    k1_bound = max(k1_bytes / HBM_BYTES_PER_S, k1_ops / INT_OPS_PER_S) * 1e3
    k1_bound_by = "bytes" if k1_bytes / HBM_BYTES_PER_S >= \
        k1_ops / INT_OPS_PER_S else "operations"
    log(f"phase K1: exact on {lanes} lanes ({n_active} active, "
        f"{int(ref.sum())} captured, {plain_stats['lane_plies']} lane-plies); "
        f"{k1_ms:.4f} ms/call vs plain {k1_plain_ms:.4f} ms, bound "
        f"{k1_bound:.5f} ms ({k1_bound_by})")

    # ---- 4. net forward ----
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
        net_ms = gpu_time_ms(lambda: model(spatial, glob), 10)
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
    legal = H.legal_moves(roots, SIZE)
    if not bool(legal.gather(1, moves[:, None]).all()):
        raise AssertionError("a chosen move is illegal")
    roots2, _ = H.step(roots, moves, SIZE)
    K1.reset_launches()
    K2.reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    res2 = driver.search(roots2, gen, max_visits=VISITS + 1)
    torch.cuda.synchronize()
    dt2 = time.time() - t0
    if not bool((res2.root_visits == VISITS + 1).all()):
        raise AssertionError("second search did not reach visits+1")
    if K1.launches <= 0 or K2.launches <= 0:
        raise AssertionError("second search did not launch both kernels")
    log(f"phase search 2 (after one move): {dt2:.2f} s "
        f"({GAMES * VISITS / dt2:.1f} playouts/s), launches "
        f"chase_lanes={K1.launches} connected_labels={K2.launches}")

    # ---- 6. report ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    log(f"playouts_per_s {GAMES * VISITS / dt1:.1f} "
        f"(search 1), {GAMES * VISITS / dt2:.1f} (search 2)")
    kernels = [
        {"name": "chase_lanes", "route": "cuda",
         "source": "katago_torch/ops/csrc/chase.cu",
         "replaces": "katago_tpu/ops/chase_pallas.py:456",
         "launches": launches["chase_lanes"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_bound_by, "library_ms": None},
        {"name": "connected_labels", "route": "cuda",
         "source": "katago_torch/ops/csrc/labels.cu",
         "replaces": "katago_tpu/ops/labels_pallas.py:138",
         "launches": launches["connected_labels"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
         "bound_by": "bytes" if k2_bytes / HBM_BYTES_PER_S >=
         k2_ops / INT_OPS_PER_S else "operations", "library_ms": None},
    ]
    print(smi.stdout.strip(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
