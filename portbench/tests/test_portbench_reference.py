"""The plain reference against the program on tiny inputs on the CPU:
rules (seeded openings replayed by the port give the same boards),
labels, chase ladders, the V7 planes, the forward and a training step."""

import numpy as np
import pytest
import torch

from portbench.reference import board as RB
from portbench.reference import chase as RC
from portbench.reference import go as RG
from portbench.reference import net as NET
from portbench.reference import rows as ROWS
from portbench.reference import train as RT

from _tiny import CFG, register_preset


@pytest.mark.parametrize("size", [9, 19])
def test_openings_replay_alike(size):
    from katago_torch._tensortree import where as tree_where
    from katago_torch.game import history as H
    from katago_torch.game import rules as R
    games, boards = RG.random_games(6, size, 2 ** 31 + 5, 60)
    assert any(len(m) > 30 for m in games)
    gs = H.new_game(size, R.Rules.tromp_taylorish(), 80, g=6, device="cpu")
    for ply in range(max(len(m) for m in games)):
        loc = torch.tensor([m[ply] if ply < len(m) else -1 for m in games])
        gs = tree_where(loc >= 0, H.step(gs, loc.clamp(min=0), size)[0], gs)
    assert np.array_equal(gs.pos.board.stones.numpy(), boards)


@pytest.mark.parametrize("size", [9, 19])
def test_labels_and_ladders(size):
    from katago_torch.game import ladder as LAD
    from katago_torch.ops import cases
    from katago_torch.ops import labels as K2
    boards = cases.random_boards(32, size, 11).long()
    assert torch.equal(RB.labels(boards, size),
                       K2.connected_labels_plain(boards.int(), size).long())
    ko = torch.full((32,), -1)
    got = LAD.ladder_map_chase_batch(boards, size, ko_loc=ko)
    want = RC.ladder_map(boards, size, ko)
    assert torch.equal(got.laddered, want[0])
    assert torch.equal(got.working_vs_black, want[1])
    assert torch.equal(got.working_vs_white, want[2])
    assert int(want[0].sum()) > 0


def test_features_of_played_positions():
    from katago_torch._tensortree import where as tree_where
    from katago_torch.game import history as H
    from katago_torch.game import rules as R
    from katago_torch.models import features as F
    size = 9
    games, _ = RG.random_games(8, size, 77, 50)
    gs = H.new_game(size, R.Rules.tromp_taylorish(), 80, g=8, device="cpu")
    for ply in range(max(len(m) for m in games)):
        loc = torch.tensor([m[ply] if ply < len(m) else -1 for m in games])
        gs = tree_where(loc >= 0, H.step(gs, loc.clamp(min=0), size)[0], gs)
    sp, gl = F.fill_features(gs, size, F.FeatureParams.default("cpu"),
                             H.legal_moves(gs, size), ladder_mode="chase")
    replays = []
    for m in games:
        game = RG.Game(size)
        assert all(game.play(loc) for loc in m)
        replays.append(game)
    ref = RG.leaf_inputs(replays, "cpu")
    p = gs.pos
    assert torch.equal(ref["stones"], p.board.stones.long())
    assert torch.equal(ref["simple_ko_loc"], p.simple_ko_loc)
    ref_sp, ref_gl = RG.features_v7(
        ref["stones"], ref["to_move"], ref["recent_moves"], ref["move_num"],
        ref["turns_this_phase"], ref["consec_passes"], ref["game_over"],
        ref["simple_ko_loc"], size, prev=ref["prev"])
    assert not torch.isnan(ref_sp[..., 15:17]).any()
    assert float(ref_sp[..., 14:17].sum()) > 0
    assert RG.check_features(sp, gl, ref_sp, ref_gl, p.board.stones,
                             p.simple_ko_loc, p.game_over) == 0
    for plane in (3, 15):
        bad = sp.clone()
        bad[0, 0, plane] = 1.0 - bad[0, 0, plane]
        assert RG.check_features(bad, gl, ref_sp, ref_gl, p.board.stones,
                                 p.simple_ko_loc, p.game_over) == 1


def test_forward_matches_the_program():
    from katago_torch.models import model as M
    w = NET.make_weights(CFG, 2 ** 31 + 9, "cpu")
    model = M.KataGoModel(register_preset(), 9, torch.float32)
    model.load_state_dict(w)
    x = (torch.rand(5, 9, 9, 22) < 0.3).float()
    g = torch.randn(5, 19)
    got, want = model(x, g), NET.forward(CFG, w, x, g)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=1e-5, atol=1e-5)
    q = NET.forward(CFG, w, x, g, quant=torch.float8_e4m3fn)
    assert not torch.allclose(q["value_logits"], want["value_logits"])


def test_train_step_matches_the_program():
    from katago_torch.models import model as M
    from katago_torch.train import train_step as TS
    w = NET.make_weights(CFG, 3, "cpu")
    model = M.KataGoModel(register_preset(), 9, torch.float32)
    model.load_state_dict(w)
    opt = {"lr": 6e-5, "momentum": 0.9, "weight_decay": 3e-5,
           "grad_clip": 1e6}
    batch = {k: torch.from_numpy(v) for k, v in ROWS.decode(
        ROWS.make_rows(8, 9, 5), 9).items()}
    optimizer = TS.make_optimizer(lr=opt["lr"])
    state = TS.init_train_state(dict(model.named_parameters()), optimizer)
    state, metrics = TS.make_train_step(model, optimizer)(state, batch)
    params = {k: v.clone() for k, v in w.items()}
    trace = {k: torch.zeros_like(v) for k, v in w.items()}
    seki = (torch.tensor(0.0), torch.tensor(0.001))
    params, trace, loss, _, _ = RT.sgd_step(CFG, params, trace, batch, seki,
                                            opt)
    ema = RT.ema_step(w, params, 0.999)
    assert float(metrics["loss"]) == pytest.approx(float(loss), rel=1e-6)
    for k in params:
        torch.testing.assert_close(state.params[k], params[k], rtol=1e-5,
                                   atol=1e-8)
        torch.testing.assert_close(state.ema_params[k], ema[k], rtol=1e-6,
                                   atol=1e-9)


def test_symmetries_match_the_program():
    from katago_torch.dataio import native as NV
    rows = ROWS.decode(ROWS.make_rows(6, 9, 1), 9)
    for sym in range(8):
        want = ROWS.symmetry(rows, 9, sym)
        assert np.array_equal(want["binaryInputNCHW"],
                              NV.apply_symmetry_planes_plain(
                                  rows["binaryInputNCHW"], sym))
        p = rows["policyTargetsNCMove"]
        got = NV.apply_symmetry_policy_plain(p.reshape(12, -1), 9, sym)
        assert np.array_equal(want["policyTargetsNCMove"].reshape(12, -1),
                              got)
