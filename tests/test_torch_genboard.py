"""The port's GenBoard (katago_torch/models/genboard.py,
cli/genboard_cmd.py) and genposes (cli/genposes_cmd.py) against the JAX
package's, on the CPU.

The JAX side is the saved `genboard` and `genposes` references
(tools/make_torch_fixtures.py). The JAX modules draw from JAX keys; the
fixtures hold those draws (the fill's permutation and Gumbel noise, the
genposes moves' Gumbel noise) and the port takes them in place of its
generator's.

Tolerances: the GenBoard forward and loss on carried-over Flax weights
within 1e-5; the training run's parameters within 1e-5 of JAX's after
its steps; make_examples, sample_fill, the genposes games and the
written poses exact; the genposes leads within 1e-5.
"""

from __future__ import annotations

import contextlib
import io
import json
import random
import re

import numpy as np
import pytest
import torch

from katago_torch.cli import genboard_cmd as TGBC
from katago_torch.cli import genposes_cmd as TGP
from katago_torch.models import desc as TD
from katago_torch.models import genboard as TGB
from katago_torch.models import weights as TW

from tests import test_torch_common as C

GB, GB_META = C.load_ref("genboard")
GP, GP_META = C.load_ref("genposes")
MODEL = str(C.REF_DIR / "b1c6_s3.bin.gz")
NET = C.GENBOARD_NET


def stdout_of(fn, *args) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue()


def port_model(prefix: str, channels: int, blocks: int):
    model = TGB.GenBoardModel(num_channels=channels, num_blocks=blocks)
    model.load_state_dict(TW.from_flax_params(C.flax_tree(GB, prefix)))
    return model.eval()


def test_genboard_names_are_the_flax_tree():
    model = TGB.GenBoardModel(NET["channels"], NET["blocks"])
    want = {k[2:].replace("/", ".") for k in GB if k.startswith("p/")}
    assert set(model.state_dict()) == want


def test_genboard_forward_and_loss_on_carried_weights():
    model = port_model("p", NET["channels"], NET["blocks"])
    inp = C.genboard_inputs(NET["size"], NET["batch"], NET["seed"])
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    x = TGB.build_inputs(t["stones"], t["known"], t["points"], t["turn"],
                         t["stdev"], t["source"], NET["size"])
    np.testing.assert_array_equal(x.numpy(), GB["inputs"])
    with torch.no_grad():
        pl, al = model(x)
        main, aux = TGB.genboard_loss(pl, al, t["labels"], t["stones"], x)
    np.testing.assert_allclose(pl.numpy(), GB["point_logits"], atol=1e-5)
    np.testing.assert_allclose(al.numpy(), GB["aux_logits"], atol=1e-5)
    assert abs(float(main) - float(GB["main"])) <= 1e-5
    assert abs(float(aux) - float(GB["aux"])) <= 1e-5


def test_sample_fill_with_the_jax_draws():
    model = port_model("p", NET["channels"], NET["blocks"])
    stones, known = C.genboard_pattern(NET["size"], NET["fill_batch"])
    out = TGB.sample_fill(
        model, torch.from_numpy(stones), torch.from_numpy(known),
        size=NET["size"], gen=None, turn=30.0, turn_stdev=5.0, source=0.0,
        order=torch.from_numpy(GB["fill/order"]),
        gumbel=torch.from_numpy(GB["fill/gumbel"]))
    np.testing.assert_array_equal(out.numpy(), GB["fill/out"])
    assert (out.numpy()[known] == stones[known]).all()


def _corpus_games(tmp_path, size):
    d = tmp_path / "sgf"
    d.mkdir()
    corpus = C.sgf_corpus()
    for name, text in corpus.items():
        (d / name).write_text(text)
    (d / "more.sgfs").write_text(
        "\n".join([corpus["g0.sgf"], corpus["g3.sgf"]]) + "\n")
    return d, TGBC.read_games(str(d), size)


def test_make_examples_equal_jax(tmp_path):
    t = C.GENBOARD_TRAIN
    _, games = _corpus_games(tmp_path, t["size"])
    ex = TGBC.make_examples(games, t["size"], t["batch"],
                            random.Random(t["seed"]), device="cpu")
    for k, v in zip(("stones", "known", "pts", "labels", "aux", "turns",
                     "stds"), ex):
        want = GB[f"examples/{k}"]
        assert np.array_equal(np.asarray(v), want), k


def test_training_steps_equal_jax(tmp_path):
    """cmd_train's steps from JAX's initial params: the same examples,
    SGD with momentum, the same parameters within 1e-5."""
    t = C.GENBOARD_TRAIN
    _, games = _corpus_games(tmp_path, t["size"])
    model = port_model("init", t["channels"], t["blocks"])
    opt = torch.optim.SGD(model.parameters(), lr=t["lr"], momentum=0.9)
    rand = random.Random(t["seed"])
    replays: dict = {}
    losses = []
    for _ in range(t["steps"]):
        inputs, labels, aux = TGBC.batch_inputs(TGBC.make_examples(
            games, t["size"], t["batch"], rand, replays, "cpu"), t["size"],
            "cpu")
        losses.append([float(v) for v in TGBC.train_step(
            model, opt, inputs, labels, aux)])
    want = [[float(x) for x in re.findall(r"=(\S+)", line)]
            for line in GB_META["train_stdout"].splitlines()
            if line.strip().startswith("step")]
    np.testing.assert_allclose(losses, want, atol=1e-4)
    path = tmp_path / "jax.npz"
    np.savez(path, **{k[len("trained/"):]: v for k, v in GB.items()
                      if k.startswith("trained/")})
    jax_model, size = TGBC.load_model(str(path), "cpu")
    assert size == t["size"]
    for k, v in jax_model.state_dict().items():
        np.testing.assert_allclose(model.state_dict()[k].detach().numpy(),
                                   v.numpy(), atol=1e-5, err_msg=k)


def test_genboard_cli_train_and_run(tmp_path):
    d, _ = _corpus_games(tmp_path, 7)
    out = tmp_path / "gb.pt"
    printed = stdout_of(TGBC.main, [
        "train", "-sgf-dir", str(d), "-out", str(out), "-size", "7",
        "-channels", "8", "-blocks", "3", "-steps", "2", "-batch", "4",
        "-device", "cpu"])
    # g0-g4 and the two games of more.sgfs (g5 is 9x9)
    assert json.loads(printed.splitlines()[-1])["games"] == 7
    board = "X" + "." * 7 + "?" * 41
    text = stdout_of(TGBC.main, ["run", "-model", str(out), "-board",
                                 board, "-batchsize", "2", "-device",
                                 "cpu"])
    boards = [b for b in text.split("\n\n") if b.strip()]
    assert len(boards) == 2
    for b in boards:
        cells = b.split()
        assert len(cells) == 49 and cells[0] == "X"
        assert set(cells) <= set(".XO") and cells[1:8] == ["."] * 7


@pytest.mark.parametrize("mode", ["random", "clumpy"])
def test_genposes_equal_jax_with_its_draws(mode, tmp_path):
    a = GP_META["args"]
    size, n = a["size"], a["n"]
    budget = np.random.default_rng(a["seed"]).integers(
        a["min_moves"], a["max_moves"] + 1, size=n)
    np.testing.assert_array_equal(budget, GP[f"{mode}/budget"])
    games = TGP.generate_positions(
        n, size, a["max_moves"], None, budget, clumpy=(mode == "clumpy"),
        device="cpu", gumbel=torch.from_numpy(GP[f"{mode}/gumbel"]))
    np.testing.assert_array_equal(games.pos.board.stones.numpy(),
                                  GP[f"{mode}/stones"])
    np.testing.assert_array_equal(games.pos.to_move.numpy(),
                                  GP[f"{mode}/to_move"])
    np.testing.assert_array_equal(games.pos.move_num.numpy(),
                                  GP[f"{mode}/move_num"])
    net = TD.load_net(MODEL, "cpu")
    with torch.no_grad():
        lead = TGP.lead_white(net, games, size)
    want = np.where(GP[f"{mode}/to_move"] == 2, GP[f"{mode}/lead_mover"],
                    -GP[f"{mode}/lead_mover"])
    np.testing.assert_allclose(lead, want, atol=1e-5)
    # the fairness filter on the same host draws writes JAX's poses
    host_rng = np.random.default_rng(a["seed"])
    host_rng.integers(a["min_moves"], a["max_moves"] + 1, size=n)
    samples = TGP.fair_samples(games, lead, size, host_rng,
                               max_score=a["max_score"],
                               pickiness=a["pickiness"], mode=mode)
    got = "".join(s.to_json_line() + "\n" for s in samples)
    assert got == GP_META["outputs"][mode]["poses"]


def test_genposes_cli_writes_fair_poses(tmp_path):
    out = tmp_path / "poses.jsonl"
    printed = stdout_of(TGP.main, C.genposes_argv(str(out), MODEL, "clumpy")
                        + ["-device", "cpu"])
    res = json.loads(printed.splitlines()[-1])
    lines = out.read_text().splitlines()
    assert res["generated"] == C.GENPOSES_ARGS["n"]
    assert res["kept"] == len(lines) > 0
    for line in lines:
        pose = json.loads(line)
        assert pose["xSize"] == 7 and pose["metadata"] == "genposes-clumpy"
