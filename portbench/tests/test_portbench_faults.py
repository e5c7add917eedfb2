"""Each fault a cell can have, planted under the timed path of a whole run
on the CPU (the look for a card skipped), turns `correct` false: a step
that leaves its state unchanged, half of the batch left out, an answer
altered where it is produced, and the trainer's weight EMA left
unchanged."""

import json

import pytest
import torch

from _tiny import fake_card, load_run, scratch_copy


def _unchanged_search(monkeypatch):
    from katago_torch.search import mcts
    monkeypatch.setattr(mcts, "insert_and_backup", lambda *a, **k: None)


def _half_batch_net(monkeypatch):
    from katago_torch.models import model as M
    real = M.KataGoModel.forward

    def forward(self, spatial, global_in, *a, **k):
        h = max(1, spatial.shape[0] // 2)
        out = real(self, spatial[:h], global_in[:h], *a, **k)
        idx = torch.arange(spatial.shape[0]) % h
        return {key: v[idx] for key, v in out.items()}
    monkeypatch.setattr(M.KataGoModel, "forward", forward)


def _altered(module, attr, change):
    def plant(monkeypatch):
        mod = __import__(module, fromlist=[attr])
        real = getattr(mod, attr)
        monkeypatch.setattr(mod, attr,
                            lambda *a, **k: change(real(*a, **k)))
    return plant


def _flip_plane(out):
    sp, gl = out
    sp = sp.clone()
    sp[:, :, 1] = 1.0 - sp[:, :, 1]
    return sp, gl


def _flip_ladder_plane(out):
    """Plane 15, the laddered stones of the board one move back."""
    sp, gl = out
    sp = sp.clone()
    sp[:, :, 15] = 1.0 - sp[:, :, 15]
    return sp, gl


def _uncaptured(out):
    """Each leaf keeps an opponent stone on its first empty point, as a
    capture left undone would."""
    leaf_pos, kh, leaf_gs = out
    board = leaf_gs.pos.board
    stones = board.stones.clone()
    gi = torch.arange(stones.shape[0])
    first = (stones == 0).int().argmax(dim=1)
    stones[gi, first] = (3 - leaf_gs.pos.to_move).to(stones.dtype)
    board.stones = stones
    return leaf_pos, kh, leaf_gs


def _relabel_last(out):
    """The last point takes the first point's label (still in range)."""
    out = out.clone()
    out[:, -1] = out[:, 0]
    return out


def _unchanged_train(monkeypatch):
    from katago_torch.train import train_step as TS
    real = TS.make_train_step

    def make(*a, **k):
        step = real(*a, **k)
        return lambda state, batch: (state, step(state, batch)[1])
    monkeypatch.setattr(TS, "make_train_step", make)


def _unchanged_ema(monkeypatch):
    from katago_torch.train import train_step as TS
    real = TS.make_train_step

    def make(*a, **k):
        step = real(*a, **k)

        def frozen(state, batch):
            new, metrics = step(state, batch)
            new.ema_params = state.ema_params
            return new, metrics
        return frozen
    monkeypatch.setattr(TS, "make_train_step", make)


def _half_batch_train(monkeypatch):
    from katago_torch.train import train_step as TS
    real = TS.make_train_step

    def make(*a, **k):
        step = real(*a, **k)

        def half(state, batch):
            n = next(iter(batch.values())).shape[0] // 2
            return step(state, {key: v[:n] for key, v in batch.items()})
        return half
    monkeypatch.setattr(TS, "make_train_step", make)


def _scaled_loss(monkeypatch):
    from katago_torch.train import train_step as TS
    real = TS.compute_losses

    def losses(*a, **k):
        total, metrics, ema = real(*a, **k)
        metrics = dict(metrics, loss=metrics["loss"] * 1.01)
        return total * 1.01, metrics, ema
    monkeypatch.setattr(TS, "compute_losses", losses)


FAULTS = {
    "search_state_unchanged": ("selfplay.tinynbt", _unchanged_search),
    "search_half_batch": ("selfplay.tinynbt", _half_batch_net),
    "features_altered": ("selfplay.tinynbt", _altered(
        "katago_torch.models.features", "fill_features", _flip_plane)),
    "ladder_plane_altered": ("selfplay.tinynbt", _altered(
        "katago_torch.models.features", "fill_features", _flip_ladder_plane)),
    "leaf_capture_undone": ("selfplay.tinynbt", _altered(
        "katago_torch.search.mcts", "make_leaf_gamestate", _uncaptured)),
    "k1_altered": ("selfplay.tinynbt", _altered(
        "katago_torch.ops.chase", "chase_lanes", lambda out: ~out)),
    "k2_altered": ("selfplay.tinynbt", _altered(
        "katago_torch.ops.labels", "connected_labels", _relabel_last)),
    "train_state_unchanged": ("train.tinynbt", _unchanged_train),
    "train_half_batch": ("train.tinynbt", _half_batch_train),
    "train_ema_unchanged": ("train.tinynbt", _unchanged_ema),
    "train_loss_altered": ("train.tinynbt", _scaled_loss),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(fault, tmp_path, monkeypatch, capsys):
    cell, plant = FAULTS[fault]
    fake_card(monkeypatch)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    run = load_run(scratch_copy(tmp_path / "copy"))
    plant(monkeypatch)
    run.main(["--workload", cell, "--seed", str(2 ** 31 + 11), "--seconds",
              "1", "--trace", "0"], device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is False, line["compared"]
