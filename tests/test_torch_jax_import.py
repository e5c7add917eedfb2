"""Resuming a JAX trainer's orbax checkpoint in the port
(tools/jax_checkpoint_to_npz.py, katago_torch/train/checkpoint.py::
import_jax_state, checkpoint_tools_cmd import-jax, train_cmd), on the CPU.

The JAX side is the saved `jax_ckpt` reference (tools/make_torch_fixtures.py):
2 steps of the JAX run_training at 5x5 on b1c6 (batch 16, lr 0.01) with
SGD and with normuon (Newton-Schulz in float32), each checkpoint written
by orbax and flattened by tools/jax_checkpoint_to_npz.py, then one more
JAX step from it; the shards it trained on.

Exact: the imported state against the flattened tree, key for key. After
import-jax and one train_cmd step: SGD within 1e-6 of JAX's next step
(parameters, EMA, SWA, seki EMA and the metrics line); normuon with
Newton-Schulz in float32 on both sides within test_torch_train.py's
tolerance (1e-5 of each tree, the zero-gradient score-belief bias bounded,
not compared). A tree with a key missing, extra or of the wrong shape is
refused by name, and nothing is written.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np
import pytest
import torch

from katago_torch.cli import checkpoint_tools_cmd as TCT
from katago_torch.cli import train_cmd as TCMD
from katago_torch.models import config as TC
from katago_torch.models import model as TM
from katago_torch.models import weights as TW
from katago_torch.train import checkpoint as TCK
from katago_torch.train import muon as TMUON
from katago_torch.train import train_step as TSTEP

from tests import test_torch_common as C
from tests.test_torch_train import ZERO_GRAD_PARAMS, _close, _sub

REF, META = C.load_ref("jax_ckpt")
RUN = META["run_training"]
SIZE = RUN["size"]
KINDS = ("sgd", "normuon")
FIELDS = {"params": "params", "ema": "ema_params", "swa": "swa_params"}


def _npz(kind: str) -> dict:
    """tools/jax_checkpoint_to_npz.py's arrays of the kind's run."""
    prefix = f"{kind}/npz/"
    return {k[len(prefix):]: v for k, v in REF.items()
            if k.startswith(prefix)}


def _template(kind: str) -> TSTEP.TrainState:
    model = TM.KataGoModel(TC.get_config("b1c6"), SIZE, torch.float32)
    return TSTEP.init_train_state(
        {k: v.detach() for k, v in model.named_parameters()},
        TSTEP.make_optimizer(kind=kind))


def _flat(tree: dict, field: str) -> dict:
    """A port tensor dict as {keystr path under field: Flax-layout array}."""
    out = {}
    for k, v in C.flat_flax(tree, "x").items():
        names = k.split("/")[1:]
        out[field + "['params']" + "".join(f"['{n}']" for n in names)] = v
    return out


def _state_as_jax_tree(state, kind: str) -> dict:
    opt = state.opt_state
    tree = {**_flat(state.params, ".params"),
            **_flat(state.ema_params, ".ema_params"),
            **_flat(state.swa_params, ".swa_params"),
            ".step": state.step, ".seki_ema.sum": state.seki_ema.sum,
            ".seki_ema.weight": state.seki_ema.weight}
    if kind == "sgd":
        tree.update(_flat(opt["trace"], ".opt_state[2][0].trace"))
        tree[".opt_state[2][1].count"] = opt["count"]
        return tree
    muon = ".opt_state[1].inner_states['muon'].inner_state"
    adam = ".opt_state[1].inner_states['adam'].inner_state"
    for part, prefix in (("momentum", f"{muon}[0].momentum"),
                         ("normuon_v", f"{muon}[0].normuon_v"),
                         ("mu", f"{adam}[0].mu"), ("nu", f"{adam}[0].nu")):
        tree.update(_flat(opt[part], prefix))
    for path in (f"{muon}[2].count", f"{adam}[0].count",
                 f"{adam}[2].count"):
        tree[path] = opt["count"]
    return tree


@pytest.mark.parametrize("kind", KINDS)
def test_imported_state_equals_the_jax_tree_key_for_key(kind):
    npz = _npz(kind)
    state = TCK.import_jax_state(npz, _template(kind))
    got = _state_as_jax_tree(state, kind)
    assert sorted(got) == sorted(npz)
    for k, want in npz.items():
        g = got[k]
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.shape == want.shape, k
        np.testing.assert_array_equal(g, want.astype(g.dtype), err_msg=k)
    assert state.step == META["runs"][kind]["metadata"]["global_step"]


def _write_shards(data) -> None:
    data.mkdir()
    for i in range(len(META["shards"])):
        prefix = f"shard{i:03d}/"
        np.savez_compressed(data / f"shard{i:03d}.npz", **{
            k[len(prefix):]: v for k, v in REF.items()
            if k.startswith(prefix)})


def _import(tmp_path, kind: str, npz: dict | None = None) -> tuple:
    """The kind's npz and metadata written out and imported by
    checkpoint_tools_cmd import-jax into tmp_path/ckpt (data paths moved
    to tmp_path/data); returns (data dir, ckpt dir)."""
    data, ckpt = tmp_path / "data", tmp_path / "ckpt"
    if not data.exists():
        _write_shards(data)
    path = str(tmp_path / f"{kind}.npz")
    np.savez(path, **(_npz(kind) if npz is None else npz))
    with open(path + ".json", "w") as f:
        json.dump(META["runs"][kind]["metadata"], f)
    TCT.main(["import-jax", "-npz", path, "-ckpt-dir", str(ckpt),
              "-config", "b1c6", "-size", str(SIZE), "-optimizer", kind,
              "-data-dir", str(data)])
    return str(data), str(ckpt)


@pytest.mark.parametrize("kind", KINDS)
def test_train_cmd_resumes_an_imported_run_as_jax_does(tmp_path,
                                                       monkeypatch, kind):
    if kind != "sgd":
        monkeypatch.setattr(TMUON, "NS_DTYPE", torch.float32)
    data, ckpt = _import(tmp_path, kind)
    run = META["runs"][kind]
    meta = TCK.load_metadata(TCK.latest_checkpoint(ckpt))
    assert meta["global_step"] == run["metadata"]["global_step"]
    assert meta["data_serve_state"]["old_train_data_dirs"] == [data]
    TCMD.main(["-data-dir", data, "-ckpt-dir", ckpt, "-size", str(SIZE),
               "-config", "b1c6", "-batch-size", str(RUN["batch_size"]),
               "-steps", "1", "-lr", str(RUN["lr"]), "-optimizer", kind,
               "-device", "cpu"])
    latest = TCK.latest_checkpoint(ckpt)
    assert TCK.load_metadata(latest)["global_step"] == \
        run["next_global_step"]
    state = TCK.restore_checkpoint(latest, _template(kind))
    with open(os.path.join(ckpt, "metrics.json")) as f:
        line = [json.loads(x) for x in f][-1]
    want_line = run["next_metrics"]
    assert sorted(line) == sorted(want_line)
    tol = 1e-6 if kind == "sgd" else 1e-5
    for k, v in want_line.items():
        assert abs(line[k] - v) <= tol * max(1.0, abs(v)), k
    for part, field in FIELDS.items():
        got = C.flat_flax(getattr(state, field), part)
        want = _sub(REF, f"{kind}/next/{part}")
        want = {part + k[len(f"{kind}/next/{part}"):]: v
                for k, v in want.items()}
        if kind == "sgd":
            assert sorted(got) == sorted(want)
            for k, w in want.items():
                np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-6,
                                           err_msg=k)
            continue
        # the bias moves by at most one step of lr from where it started
        start = TCK.import_jax_state(_npz(kind), _template(kind))
        start = TW.to_flax_params(getattr(start, FIELDS[part]))
        for name in ZERO_GRAD_PARAMS:
            node = start
            for n in name.split("/"):
                node = node[n]
            for side in (got, want):
                moved = np.abs(side.pop(f"{part}/{name}") - node).max()
                assert moved <= RUN["lr"] * 1.01, (part, name, moved)
        _close(got, want, tol, part)
    np.testing.assert_allclose(
        [state.seki_ema.sum.item(), state.seki_ema.weight.item()],
        REF[f"{kind}/next/seki"], rtol=tol)


def test_a_mismatched_tree_is_refused_by_name(tmp_path):
    npz = _npz("sgd")
    template = _template("sgd")
    gone = ".params['params']['Conv_0']['Conv_0']['kernel']"
    with pytest.raises(ValueError, match=re.escape(gone)):
        TCK.import_jax_state({k: v for k, v in npz.items() if k != gone},
                             template)
    bad = ".opt_state[2][0].trace['params']['Dense_0']['kernel']"
    with pytest.raises(ValueError, match=re.escape(bad)):
        TCK.import_jax_state({**npz, bad: npz[bad].T}, template)
    with pytest.raises(ValueError, match=re.escape(".extra")):
        TCK.import_jax_state({**npz, ".extra": np.zeros(1)}, template)
    # another optimizer's tree
    with pytest.raises(ValueError, match="missing"):
        TCK.import_jax_state(_npz("normuon"), template)
    # nothing is written by a refused import-jax
    with pytest.raises(ValueError, match=re.escape(gone)):
        _import(tmp_path, "sgd", {k: v for k, v in npz.items()
                                  if k != gone})
    assert not (tmp_path / "ckpt").exists()


def test_the_converter_round_trips_a_jax_checkpoint(tmp_path, capsys):
    """tools/jax_checkpoint_to_npz.py on a state saved by
    katago_tpu.train.checkpoint.save_checkpoint (no compiled step): every
    leaf and the metadata come back, and the port imports them."""
    import jax

    from katago_tpu.models import config as JC
    from katago_tpu.models.model import KataGoModel
    from katago_tpu.train import checkpoint as JCK
    from katago_tpu.train import schedules as JSCH
    from katago_tpu.train import train_step as JSTEP
    from tools import jax_checkpoint_to_npz as J2N
    params = C.flax_params(KataGoModel(JC.get_config("b1c6"), pos_len=SIZE),
                           SIZE, 4)
    state = JSTEP.init_train_state(params, JSTEP.make_optimizer(
        lr=JSCH.make_lr_schedule(0.01, 16), kind="sgd"))
    state = state._replace(step=np.int32(7))
    meta = {"global_step": 7, "data_serve_state": {"data_files_used": []}}
    path = JCK.save_checkpoint(str(tmp_path / "jax"), state, 7,
                               metadata=meta)
    out = str(tmp_path / "state.npz")
    assert J2N.main(["-ckpt", path, "-config", "b1c6", "-size", str(SIZE),
                     "-optimizer", "sgd", "-out", out]) == 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["step"] == 7
    with np.load(out) as z:
        got = {k: z[k] for k in z.files}
    want = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(state)[0]}
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    with open(out + ".json") as f:
        assert json.load(f) == meta
    imported = TCK.import_jax_state(got, _template("sgd"))
    want_params = TW.from_flax_params(
        jax.tree.map(np.asarray, params["params"]))
    for k, v in want_params.items():
        assert torch.equal(imported.params[k], v), k
    assert imported.step == 7 and imported.opt_state["count"] == 0
