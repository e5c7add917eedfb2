"""The port's selfplay CLI with the trainer's exports, on the CPU:
-models-dir loads the newest export and names the output after it, and
-switch-nets lets a newer export take over at move 16 (the JAX package's
selfplay_cmd semantics: the output stays under the starting model's
name, and the caller's net keeps its weights)."""

from __future__ import annotations

import os

import numpy as np
import torch

from katago_torch.cli import selfplay_cmd as SP
from katago_torch.models import config as TC
from katago_torch.models import model as TM
from katago_torch.models import weights as TWT
from katago_torch.search import mcts
from katago_torch.train import checkpoint as TCK


def _export(models_dir, name, seed, mtime):
    model = TWT.init_weights(TM.KataGoModel(TC.get_config("b1c6"), 5,
                                            torch.float32), seed=seed)
    path = TCK.export_params(str(models_dir), name, model.state_dict())
    os.utime(path, (mtime, mtime))
    return model.state_dict()["Conv_0.Conv_0.kernel"]


def test_models_dir_loads_newest_export_and_switch_nets_at_move_16(
        tmp_path, monkeypatch):
    models = tmp_path / "models"
    _export(models, "b1c6-s1", 3, 1e9)
    # seed 1: the game is still on at move 16 (at 2 visits)
    first = _export(models, "b1c6-s2", 1, 2e9)
    used = []
    real = mcts.run_search

    def recording(model, *a, **kw):
        used.append(model.state_dict()["Conv_0.Conv_0.kernel"].clone())
        if len(used) == 16:
            # a newer export appears while move 15 is searched
            used.append(_export(models, "b1c6-s3", 2, 3e9))
        return real(model, *a, **kw)

    monkeypatch.setattr(mcts, "run_search", recording)
    logs = []
    totals = SP.run_selfplay(
        str(tmp_path / "out"), str(models), size=5, games_per_batch=1,
        visits=2, max_batches=1, config_name="b1c6", data_quality="test",
        switch_nets=True, device="cpu", max_moves=17, log=logs.append)
    newer = used.pop(16)
    assert len(used) == 17, len(used)
    assert all(torch.equal(u, first) for u in used[:16])
    assert all(torch.equal(u, newer) for u in used[16:])
    assert not torch.equal(first, newer)
    assert any("switching to net b1c6-s3" in line for line in logs)
    assert any("model=b1c6-s2" in line for line in logs)
    shard = tmp_path / "out" / "b1c6-s2" / "tdata" / "batch000000_0_s5.npz"
    with np.load(shard) as z:
        assert z["globalInputNC"].shape[0] == totals["rows"] == 17


def test_empty_models_dir_runs_random_init(tmp_path):
    os.makedirs(tmp_path / "models")
    totals = SP.run_selfplay(
        str(tmp_path / "out"), str(tmp_path / "models"), size=5,
        games_per_batch=2, visits=4, max_batches=1, config_name="b1c6",
        data_quality="test", device="cpu", max_moves=2,
        log=lambda *_: None)
    assert totals["rows"] == 4
    assert (tmp_path / "out" / "random-init" / "tdata").is_dir()
