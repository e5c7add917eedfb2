"""Data parallelism of the port over torch.distributed
(katago_torch/parallel/mesh.py and its hooks: train_step / run_training /
train_cmd -multi-host, play_games(mesh=...), run_selfplay), on the CPU
with gloo.

Two CPU processes at world size 2 must give:
  * the data-parallel train step equal, within 1e-6, to the world-1 step
    on the whole batch (parameters, EMA and every metric), and
    train_cmd -multi-host's checkpoint equal within 1e-6 to the plain
    run's;
  * play_games with a mesh the world-1 rows and stats exactly, at
    temperature 0 with no root noise (every rank returns all games);
  * with root noise on, the two ranks' games draw different noise: the
    first searches of two games that differ only in their rank differ,
    and are equal with the noise off.
A batch or a game count that does not divide by the ranks raises as the
JAX package's does (tests/test_multichip.py).
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp

import numpy as np
import pytest
import torch

from katago_torch.cli import train_cmd as TCMD
from katago_torch.parallel import mesh as PM
from katago_torch.search.params import SearchParams
from katago_torch.selfplay import loop as LOOP
from katago_torch.selfplay.playsettings import PlaySettings
from katago_torch.train import checkpoint as TCK
from katago_torch.train import train_step as TSTEP

from tests import test_torch_common as C

SIZE = 5
BATCH = 16
GAMES = 4
TRAIN_ARGS = ["-size", str(SIZE), "-config", "b1c6", "-batch-size",
              str(BATCH), "-steps", "2", "-device", "cpu"]


def _batch():
    from katago_torch.dataio import trainingwrite as TTW
    rows = C.random_rows(SIZE, BATCH, 7)
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in
            TTW.decode_rows(rows, SIZE).items()}


def _step(mesh, batch):
    """One SGD step of the b1c6 net on batch (this rank's slice with a
    mesh): (params, ema, metrics) as numpy."""
    model = TCMD.make_model(SIZE, "b1c6", "cpu", seed=3)
    opt = TSTEP.make_optimizer(lr=1e-2, kind="sgd")
    state = TSTEP.init_train_state(dict(model.named_parameters()), opt)
    step = TSTEP.make_train_step(model, opt, mesh=mesh)
    if mesh is not None:
        row0, rows = PM.process_batch_slice(BATCH, mesh)
        batch = {k: v[row0:row0 + rows] for k, v in batch.items()}
    state, metrics = step(state, batch)
    return ({k: v.detach().numpy() for k, v in state.params.items()},
            {k: v.detach().numpy() for k, v in state.ema_params.items()},
            {k: float(v) for k, v in metrics.items()})


def _games_setup():
    sp = dataclasses.replace(SearchParams.for_selfplay(),
                             root_noise_enabled=False, **C.TEMPERATURE_ZERO)
    return dict(size=SIZE, num_games=GAMES, visits=4, max_moves=6,
                search_params=sp, play_settings=PlaySettings.for_testing(4),
                device="cpu")


def _play(mesh):
    data, stats = LOOP.play_games(C.ref_model(SIZE), mesh=mesh,
                                  gen=torch.Generator().manual_seed(2),
                                  **_games_setup())
    return dataclasses.asdict(data), stats


def _first_search_visits(mesh, noise: bool):
    """The child visits of the first search of both games of a one-move
    play_games, one game per rank (the same komi, the same generator)."""
    sp = dataclasses.replace(SearchParams.for_selfplay(),
                             root_noise_enabled=noise,
                             **C.TEMPERATURE_ZERO)
    data, _ = LOOP.play_games(C.ref_model(SIZE), mesh=mesh, size=SIZE,
                              num_games=2, visits=16, max_moves=1,
                              search_params=sp,
                              play_settings=PlaySettings.for_testing(16),
                              gen=torch.Generator().manual_seed(2),
                              device="cpu")
    return data.q_visits[np.argsort(data.game_idx)]


def _rank_main(rank, urls, data_dir, ckpt, queue):
    # the trainer through its CLI (its own group): rank 0 alone writes
    # the checkpoint
    TCMD.main(["-data-dir", data_dir, "-ckpt-dir", ckpt, "-multi-host",
               "-dist-url", urls[0], "-world-size", "2", "-rank",
               str(rank)] + TRAIN_ARGS)
    mesh = PM.initialize_multihost(urls[1], 2, rank, "cpu")
    try:
        step = _step(mesh, _batch())
        played = _play(mesh)
        noise = {n: _first_search_visits(mesh, n) for n in (True, False)}
    finally:
        PM.shutdown()
    queue.put((rank, (step, played, noise)))


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """The two ranks' results: {rank: (step, play_games)} and the
    -multi-host checkpoint directory; the data directory."""
    tmp = tmp_path_factory.mktemp("dist")
    C.write_shards(tmp / "data", SIZE, [24, 20], 3)
    ports = {PM.free_port()}
    while len(ports) < 2:
        ports.add(PM.free_port())
    urls = [f"tcp://127.0.0.1:{p}" for p in sorted(ports)]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(
        r, urls, str(tmp / "data"), str(tmp / "ckpt2"), queue))
        for r in range(2)]
    for p in procs:
        p.start()
    try:
        results = dict(queue.get(timeout=300) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    assert [p.exitcode for p in procs] == [0, 0]
    return results, tmp


def test_data_parallel_step_equals_the_whole_batch_step(world2):
    results, _ = world2
    params, ema, metrics = _step(None, _batch())
    for rank in (0, 1):
        p2, e2, m2 = results[rank][0]
        for k in params:
            np.testing.assert_allclose(p2[k], params[k], rtol=0, atol=1e-6,
                                       err_msg=k)
            np.testing.assert_allclose(e2[k], ema[k], rtol=0, atol=1e-6)
        for k, v in metrics.items():
            assert abs(m2[k] - v) <= 1e-6 * max(1.0, abs(v)), k


def test_multi_host_checkpoint_equals_the_plain_run(world2, tmp_path):
    _, tmp = world2
    TCMD.main(["-data-dir", str(tmp / "data"), "-ckpt-dir",
               str(tmp_path / "ckpt1")] + TRAIN_ARGS)
    one = TCK.load_state_tree(TCK.latest_checkpoint(str(tmp_path / "ckpt1")))
    two = TCK.load_state_tree(TCK.latest_checkpoint(str(tmp / "ckpt2")))
    for k, v in one["params"].items():
        np.testing.assert_allclose(two["params"][k].numpy(), v.numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)


def test_sharded_play_games_gives_the_world1_rows(world2):
    results, _ = world2
    data, stats = _play(None)
    for rank in (0, 1):
        d2, s2 = results[rank][1]
        for k, v in data.items():
            assert np.array_equal(d2[k], v), k
        for k, v in stats.items():
            assert np.array_equal(np.asarray(s2[k]), np.asarray(v)), k


def test_ranks_draw_their_own_root_noise(world2):
    results, _ = world2
    for rank in (0, 1):
        noise = results[rank][2]
        assert noise[True].shape[0] == 2
        assert np.array_equal(noise[False][0], noise[False][1])
        assert not np.array_equal(noise[True][0], noise[True][1])
    assert np.array_equal(results[0][2][True], results[1][2][True])


def test_a_batch_that_does_not_divide_raises(tmp_path):
    mesh = PM.Mesh(rank=0, world_size=2, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="not divisible"):
        LOOP.play_games(C.ref_model(SIZE), mesh=mesh,
                        **dict(_games_setup(), num_games=3))
    (tmp_path / "x.npz").write_bytes(b"")
    with pytest.raises(ValueError, match="not divisible"):
        TCMD.run_training(str(tmp_path), str(tmp_path / "c"), None,
                          size=SIZE, config_name="b1c6", batch_size=7,
                          steps=1, lr=1e-3, mesh=mesh, log=lambda *a: None)
    with pytest.raises(ValueError, match="not divisible"):
        TCMD.main(["-data-dir", str(tmp_path), "-ckpt-dir",
                   str(tmp_path / "c"), "-multi-host", "-world-size", "2",
                   "-batch-size", "7", "-device", "cpu"])
    assert not (tmp_path / "c").exists()


def test_process_batch_slice_and_world1_group():
    assert PM.process_batch_slice(16) == (0, 16)
    assert PM.process_batch_slice(
        16, PM.Mesh(1, 4, torch.device("cpu"))) == (4, 4)
    with pytest.raises(ValueError, match="init_method"):
        PM.initialize_multihost(None, world_size=2, rank=0, device="cpu")
