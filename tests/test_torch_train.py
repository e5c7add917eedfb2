"""The port's trainer (katago_torch/train, cli/train_cmd.py) against the
JAX package's, on the CPU.

The JAX side of every loss, gradient, optimizer step and run_training
comparison is a saved reference (tests/data/torch_ref/train*.npz, written
by tools/make_torch_fixtures.py with its seeds in `meta`), so no test
compiles the JAX train step. Schedules and SWA run live (eager numpy-size
JAX, nothing compiled).

Tolerances, float32: loss terms within 1e-5 relative (1e-6 absolute);
gradients, updated params, EMA/SWA and optimizer state within 1e-5 of
the largest entry of their tensor plus 1e-6 of the largest entry of
the whole tree (a gradient that is zero in exact arithmetic, such as
the score-belief mixture bias that log_softmax cancels, is rounding noise
on both sides). The Muon family orthogonalizes in bfloat16 and the
Newton-Schulz iteration amplifies rounding (XLA keeps excess precision
between bf16 ops, PyTorch rounds each): on the b1c6 net's small matrices
single updates differ far beyond 1e-2. So the Muon steps and the
normuon run_training are held with Newton-Schulz in float32 on both
sides (the fixtures' ns_float32, the port's muon.NS_DTYPE) within 1e-3
of each update's largest entry; in bfloat16 the orthogonalizers are held
on seeded matrices up to 864x96 by direction (cosine >= 0.98) and norm
(within 5%), and the Muon steps' gradient-only state (momentum, Adam
moments, counts) within 1e-5. The learning rate, the Muon/Adam split
and the state shapes are exact.

The net families (tests/data/torch_ref/nets_train.npz): an nbttf-GAB net
with QK-norm GQA and a mid-trunk intermediate head, its loss terms (the
intermediate set included) within 1e-5 relative, its gradients as
above, and one sgd and one normuon step (Newton-Schulz in float32) held
by the new parameters: each update within 1e-5 (sgd) or 1e-3 (normuon)
of its tensor's largest update plus 1e-6 of the net's largest, plus one
float32 spacing of the parameter (an RMSNorm scale near 1 rounds its
small update).
"""

from __future__ import annotations

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from katago_tpu.dataio import trainingwrite as JTW
from katago_tpu.train import schedules as JSCH
from katago_torch.cli import train_cmd as TCMD
from katago_torch.models import config as TMC
from katago_torch.models import model as TM
from katago_torch.models import weights as TWT
from katago_torch.train import checkpoint as TCK
from katago_torch.train import losses as TL
from katago_torch.train import schedules as TSCH
from katago_torch.train import muon as TMUON
from katago_torch.train import train_step as TSTEP
from katago_torch.train.muon import as_matrix

from tests import test_torch_common as C

SIZE, BATCH = 5, 16
RUN = {"size": SIZE, "config_name": "b1c6", "batch_size": BATCH,
       "lr": 0.01, "seed": 0}


def _close(got: dict, ref: dict, rel: float, what: str):
    """Every array of ref equal in got within rel of its largest entry
    plus 1e-6 of the largest entry of all of ref."""
    assert sorted(got) == sorted(ref), what
    tree_max = max(float(np.abs(r).max()) for r in ref.values() if r.size)
    for k, r in ref.items():
        g = np.asarray(got[k])
        assert g.shape == r.shape, (what, k, g.shape, r.shape)
        if not r.size:
            continue
        err = float(np.abs(g - r).max())
        tol = rel * float(np.abs(r).max()) + 1e-6 * tree_max
        assert err <= tol, (what, k, err, tol)


def _sub(arrays: dict, prefix: str) -> dict:
    """Fixture arrays under prefix/, keyed as flat_flax keys them."""
    out = {}
    for k, v in arrays.items():
        if not k.startswith(prefix + "/"):
            continue
        rest = k[len(prefix) + 1:]
        if rest.startswith("params/"):
            rest = rest[len("params/"):]
        out[f"{prefix}/{rest}"] = v
    return out


def _batch():
    rows = C.random_rows(SIZE, BATCH, 7)
    return {k: torch.from_numpy(v) for k, v in
            JTW.decode_rows(rows, SIZE).items()}


def _losses(model, batch, is_training, seki_in):
    raw = model(batch["binaryInputNCHW"].permute(0, 2, 3, 1),
                batch["globalInputNC"])
    return TL.compute_losses(raw, batch, seki_ema=seki_in,
                             is_training=is_training)


@pytest.mark.parametrize("is_training", [True, False],
                         ids=["train", "eval"])
def test_loss_terms_and_seki_ema_match_jax(is_training):
    arrays, meta = C.load_ref("train_losses")
    model = C.ref_model(SIZE, seed=3)
    seki_in = TL.SekiEma(torch.tensor(meta["seki_in"][0]),
                         torch.tensor(meta["seki_in"][1]))
    total, metrics, ema = _losses(model, _batch(), is_training, seki_in)
    tag = "train" if is_training else "eval"
    ref = {k.split("/", 1)[1]: v for k, v in arrays.items()
           if k.startswith(f"m_{tag}/")}
    assert sorted(metrics) == sorted(ref)
    for k, r in ref.items():
        np.testing.assert_allclose(metrics[k].detach().numpy(), r,
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(total.detach().numpy(), ref["loss"],
                               rtol=1e-5)
    np.testing.assert_allclose([ema.sum.item(), ema.weight.item()],
                               arrays[f"seki_{tag}"], rtol=1e-6)
    if not is_training:
        assert ema is seki_in


def _net_train():
    """The NET_TRAIN net (nbttf-GAB, QK-norm GQA, a mid-trunk
    intermediate head) with the nets_train fixture's weights."""
    arrays, meta = C.load_ref("nets_train")
    model = TM.KataGoModel(C.net_config(TMC, "net_train", C.NET_TRAIN),
                           SIZE, torch.float32)
    model.load_state_dict(TWT.from_flax_params(C.flax_tree(arrays, "w")))
    return model.eval(), arrays, meta


def test_intermediate_head_losses_raise():
    """The intermediate-head term set (once refused): the NET_TRAIN net's
    loss terms, the intermediate metrics and the seki EMA against JAX
    compute_losses (tests/data/torch_ref/nets_train.npz)."""
    model, arrays, meta = _net_train()
    seki_in = TL.SekiEma(torch.tensor(meta["seki_in"][0]),
                         torch.tensor(meta["seki_in"][1]))
    total, metrics, ema = _losses(model, _batch(), True, seki_in)
    ref = {k.split("/", 1)[1]: v for k, v in arrays.items()
           if k.startswith("m/")}
    assert {"intermediate_loss", "intermediate_policy_loss",
            "intermediate_value_loss"} <= set(ref)
    assert sorted(metrics) == sorted(ref)
    for k, r in ref.items():
        np.testing.assert_allclose(metrics[k].detach().numpy(), r,
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(total.detach().numpy(), ref["loss"],
                               rtol=1e-5)
    np.testing.assert_allclose([ema.sum.item(), ema.weight.item()],
                               arrays["seki"], rtol=1e-6)


def test_net_family_gradients_match_jax():
    """Gradients of the NET_TRAIN total loss (both heads) by every
    parameter, the transformer projections, RMSNorm scales, GAB freqs
    and intermediate heads included, within the module's tolerance."""
    model, arrays, meta = _net_train()
    seki_in = TL.SekiEma(torch.tensor(meta["seki_in"][0]),
                         torch.tensor(meta["seki_in"][1]))
    total, _, _ = _losses(model, _batch(), True, seki_in)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(total, [p for _, p in
                                        model.named_parameters()])
    _close(C.flat_flax(dict(zip(names, grads)), "grad"),
           _sub(arrays, "grad"), 1e-5, "grad")


@pytest.mark.parametrize("kind", ["sgd", "normuon"])
def test_net_family_optimizer_step_matches_jax(kind, monkeypatch):
    """One step from the NET_TRAIN weights with the JAX gradients: the
    sgd loop and normuon (Newton-Schulz in float32 on both sides) take
    the 2-D projections and 1-D leaves as the JAX optimizers do."""
    model, arrays, meta = _net_train()
    if kind != "sgd":
        monkeypatch.setattr(TMUON, "NS_DTYPE", torch.float32)
    params = dict(model.state_dict())
    grads = TWT.from_flax_params(C.flax_tree(arrays, "grad"))
    opt = TSTEP.make_optimizer(lr=meta["lr"], kind=kind)
    upd, _ = opt.update(grads, opt.init(params), params)
    got = C.flat_flax({k: v + upd[k] for k, v in params.items()}, "p")
    start = C.flat_flax(params, "p")
    tag = kind if kind == "sgd" else f"{kind}_f32"
    want = {"p/" + k.split("/", 2)[2]: v
            for k, v in _sub(arrays, f"{tag}/p0").items()}
    # updates within rel of each tensor's largest update plus 1e-6 of the
    # largest of all, and one float32 spacing of the parameter itself (a
    # parameter near 1, such as an RMSNorm scale, rounds its update)
    rel = 1e-5 if kind == "sgd" else 1e-3
    assert sorted(got) == sorted(want)
    upd_ref = {k: w - start[k] for k, w in want.items()}
    tree_max = max(float(np.abs(u).max()) for u in upd_ref.values())
    for k, w in want.items():
        tol = rel * float(np.abs(upd_ref[k]).max()) + 1e-6 * tree_max + \
            float(np.spacing(np.abs(w).max().astype(np.float32)))
        err = float(np.abs(got[k] - w).max())
        assert err <= tol, (kind, k, err, tol)


def test_gradients_of_total_loss_match_jax():
    arrays, meta = C.load_ref("train_losses")
    model = C.ref_model(SIZE, seed=3)
    seki_in = TL.SekiEma(torch.tensor(meta["seki_in"][0]),
                         torch.tensor(meta["seki_in"][1]))
    total, _, _ = _losses(model, _batch(), True, seki_in)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(total, [p for _, p in
                                        model.named_parameters()])
    got = C.flat_flax(dict(zip(names, grads)), "grad")
    _close(got, _sub(arrays, "grad"), 1e-5, "grad")


def _opt_run(kind):
    """Two optimizer steps of kind from the weights-3 params with the
    fixture's JAX gradients (x1, then x0.5): ([params after each step],
    final state, the starting params)."""
    arrays, meta = C.load_ref("train_losses")
    params = dict(C.ref_model(SIZE, seed=3).state_dict())
    grads = TWT.from_flax_params(C.flax_tree(arrays, "grad"))
    sched = TSCH.make_lr_schedule(meta["lr"], BATCH,
                                  lr_schedule_str=meta["lr_schedule"])
    opt = TSTEP.make_optimizer(lr=sched, kind=kind)
    state = opt.init(params)
    p = params
    steps = []
    for scale in meta["grad_scales"]:
        g = {k: v * scale for k, v in grads.items()}
        upd, state = opt.update(g, state, p)
        p = {k: v + upd[k] for k, v in p.items()}
        steps.append(p)
    return steps, state, params, arrays


def _state_of(arrays, tag):
    return {k.split("/", 2)[2]: v for k, v in arrays.items()
            if k.startswith(f"{tag}/state/")}


def _check_state(state, st, v_rel):
    assert state["count"] == int(st["count"]) == 2
    if "trace" in state:
        _close(C.flat_flax(state["trace"], "trace"), _sub(st, "trace"),
               1e-5, "trace")
        return
    assert int(st["adam_count"]) == int(st["adam_sched_count"]) == 2
    for part in ("mu", "nu", "momentum"):
        _close(C.flat_flax(state[part], part), _sub(st, part), 1e-5, part)
    if v_rel is not None:
        v_got = {"normuon_v/" + k.replace(".", "/"): v.numpy()
                 for k, v in state["normuon_v"].items()}
        _close(v_got, _sub(st, "normuon_v"), v_rel, "normuon_v")


def _updates(p, prev):
    return {k: v - prev[k] for k, v in p.items()}


@pytest.mark.parametrize("kind", ["sgd", "muon", "normuon", "polar"])
def test_optimizer_steps_match_jax(kind, monkeypatch):
    """Two steps from the same params and gradients; the Muon kinds with
    Newton-Schulz in float32 on both sides (module docstring)."""
    tag = kind if kind == "sgd" else f"{kind}_f32"
    if kind != "sgd":
        monkeypatch.setattr(TMUON, "NS_DTYPE", torch.float32)
    steps, state, params, arrays = _opt_run(kind)
    prev_ref = C.flat_flax(params, "u")
    for i, p in enumerate(steps):
        ref = {"u/" + k.split("/", 2)[2]: v
               for k, v in _sub(arrays, f"{tag}/p{i}").items()}
        # each step's update from the JAX package's previous params
        got = C.flat_flax(_updates(p, steps[i - 1] if i else params), "u")
        want = {k: v - prev_ref[k] for k, v in ref.items()}
        _close(got, want, 1e-5 if kind == "sgd" else 1e-3,
               f"{kind} step {i}")
        prev_ref = ref
    _check_state(state, _state_of(arrays, tag),
                 None if kind == "sgd" else 1e-3)


@pytest.mark.parametrize("kind", ["muon", "normuon", "polar"])
def test_muon_bf16_steps_keep_gradient_state_and_counts(kind):
    """In bfloat16 (the default) the state that does not pass through
    Newton-Schulz equals the JAX package's, and the steps stay finite."""
    steps, state, _, arrays = _opt_run(kind)
    _check_state(state, _state_of(arrays, kind), None)
    assert all(torch.isfinite(v).all() for p in steps for v in p.values())


@pytest.mark.parametrize("fn", ["ns5", "polar"])
def test_orthogonalizers_in_bf16_match_jax_in_direction_and_norm(fn):
    arrays, meta = C.load_ref("train_losses")
    port = {"ns5": TMUON.zeropower_newtonschulz5,
            "polar": TMUON.zeropower_polar_express}[fn]
    for rows, cols in meta["ns_shapes"]:
        name = f"{rows}x{cols}"
        got = port(torch.from_numpy(arrays[f"ns_in/{name}"])).numpy()
        want = arrays[f"{fn}/{name}"]
        assert got.dtype == np.float32 and got.shape == want.shape
        cos = float((got * want).sum() / np.linalg.norm(got)
                    / np.linalg.norm(want))
        assert cos >= 0.98, (name, cos)
        assert abs(np.linalg.norm(got) / np.linalg.norm(want) - 1) <= 0.05


def test_muon_split_and_normuon_rows_follow_flax_layout():
    """The Muon/Adam split equals the JAX package's, and each normuon_v
    has one entry per row of the weight's Flax matrix
    ([kh*kw*cin, cout], [in, out]) — not of the port's OIHW view."""
    _, state, params, arrays = _opt_run("normuon")
    st = _state_of(arrays, "normuon")
    muon_keys = {k.replace(".", "/") for k in state["momentum"]}
    adam_keys = {k.replace(".", "/") for k in state["mu"]}
    assert muon_keys == {k.split("/", 1)[1] for k in _sub(st, "momentum")}
    assert adam_keys == {k.split("/", 1)[1] for k in _sub(st, "mu")}
    assert not muon_keys & adam_keys
    assert muon_keys | adam_keys == {k.replace(".", "/") for k in params}
    v_ref = _sub(st, "normuon_v")
    for k, v in state["normuon_v"].items():
        ref = v_ref["normuon_v/" + k.replace(".", "/")]
        assert tuple(v.shape) == ref.shape == (as_matrix(params[k]).shape[0],)
    conv = "ResBlock_0.NormActConv_1.Conv_0.Conv_0.kernel"
    cout, cin, kh, kw = params[conv].shape
    assert state["normuon_v"][conv].shape == (kh * kw * cin,)


def _table_lr(mode, samples):
    """The learning rate of the auto tables at samples, from the JAX
    package's tables (first row whose bound exceeds samples)."""
    table, factor = {"auto": (JSCH.LR_SCALE_AUTO, 1.0),
                     "auto2": (JSCH.LR_SCALE_AUTO2, 1.5)}[mode]
    scale = next(s for b, s in table if np.float32(b) > np.float32(samples))
    return np.float32(6e-5 * factor) * np.float32(scale)


@pytest.mark.parametrize("mode", ["schedule", "auto", "auto2", "constant"])
def test_lr_schedule_matches_jax_around_every_breakpoint(mode):
    per_step = 256
    kw = {"schedule": {"lr_schedule_str": "(0,12.0),(20M,9.0),(40.5M,6.0)"},
          "auto": {"lr_scale_auto": True},
          "auto2": {"lr_scale_auto2": 1.5},
          "constant": {"lr_scale": 0.7}}[mode]
    bounds = {"schedule": [0, 20e6, 40.5e6],
              "auto": [b for b, _ in JSCH.LR_SCALE_AUTO[:-1]],
              "auto2": [b for b, _ in JSCH.LR_SCALE_AUTO2[:-1]],
              "constant": [0, 1e6]}[mode]
    for start in (0, 3 * per_step):
        j = JSCH.make_lr_schedule(6e-5, per_step, start_samples=start, **kw)
        t = TSCH.make_lr_schedule(6e-5, per_step, start_samples=start, **kw)
        for b in bounds:
            c0 = int((b - start) // per_step)
            for count in (c0 - 1, c0, c0 + 1, c0 + 2):
                if count < 0:
                    continue
                got = t(count)
                assert isinstance(got, np.float32)
                if start + count * per_step < 2 ** 31:
                    want = np.float32(np.asarray(j(jnp.int32(count))))
                    assert got == want, (mode, start, count, got, want)
                else:
                    # the JAX schedule counts samples in int32 and wraps
                    # past 2**31 (ROADMAP Queue 3); the port counts in
                    # Python ints and follows its table
                    assert got == _table_lr(mode, start + count * per_step)
    with pytest.raises(ValueError):
        TSCH.make_lr_schedule(1.0, 1, lr_scale=1.0, lr_scale_auto=True)
    for bad in ("(5,1.0)", "(0,1.0),(0,2.0)"):
        with pytest.raises(ValueError):
            TSCH.parse_lr_schedule(bad)
    assert TSCH.parse_suffixed_count("2.5K") == \
        JSCH.parse_suffixed_count("2.5K") == 2500


def test_swa_tracker_matches_jax():
    rng = np.random.default_rng(3)
    jt = JSCH.SwaTracker(100, 4.0, accum=30.0)
    tt = TSCH.SwaTracker(100, 4.0, accum=30.0)
    for n in rng.integers(10, 90, 40):
        assert jt.step(int(n)) == tt.step(int(n))
        assert jt.accum == tt.accum
    big = (JSCH.SwaTracker(10, 2.0), TSCH.SwaTracker(10, 2.0))
    assert big[0].step(35) == big[1].step(35) and \
        big[0].accum == big[1].accum == 0.0
    swa = {"a": rng.standard_normal((3, 4)).astype(np.float32)}
    cur = {"a": rng.standard_normal((3, 4)).astype(np.float32)}
    want = np.asarray(jt.update({k: jnp.asarray(v) for k, v in swa.items()},
                                {k: jnp.asarray(v) for k, v in cur.items()
                                 })["a"])
    got = tt.update({k: torch.from_numpy(v) for k, v in swa.items()},
                    {k: torch.from_numpy(v) for k, v in cur.items()})["a"]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def _start(tmp_path, name, kind="sgd"):
    """The fixture's shards in tmp_path/data and a step-0 checkpoint of
    its initial (JAX-initialized) params in tmp_path/ckpt."""
    arrays, meta = C.load_ref(name)
    data = tmp_path / "data"
    C.write_shards(data, SIZE, meta["shards"], meta["data_seed"])
    params = TWT.from_flax_params(C.flax_tree(arrays, "init"))
    state = TSTEP.init_train_state(params, TSTEP.make_optimizer(
        lr=RUN["lr"], kind=kind))
    ckpt = tmp_path / "ckpt"
    TCK.save_checkpoint(str(ckpt), state, 0, metadata={"global_step": 0})
    return arrays, meta, str(data), str(ckpt)


def _metric_lines(ckpt):
    with open(os.path.join(ckpt, "metrics.json")) as f:
        return [json.loads(x) for x in f]


def _check_lines(got, ref, rel):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
        assert g["step"] == r["step"]
        for k in r:
            np.testing.assert_allclose(g[k], r[k], rtol=rel, atol=1e-6,
                                       err_msg=f"step {r['step']} {k}")


# The score-belief mixture bias: sv3 = Dense_7(sv2) is log_softmaxed over
# the score axis, along which the bias is constant, so its gradient is zero
# in exact arithmetic. Adam (the Muon kinds' fallback, eps 1e-10) turns
# that rounding noise into steps of about lr each, whose signs no two
# implementations share.
ZERO_GRAD_PARAMS = ("ValueHead_0/Dense_7/bias",)


def _check_final(ckpt, arrays, rel, kind="sgd", steps=0, lr=0.0):
    state = TCK.restore_checkpoint(
        TCK.latest_checkpoint(ckpt),
        TSTEP.init_train_state(TWT.from_flax_params(
            C.flax_tree(arrays, "init")), TSTEP.make_optimizer(kind=kind)))
    init = _sub(arrays, "init")
    for part, tree in (("params", state.params), ("ema", state.ema_params),
                       ("swa", state.swa_params)):
        got, want = C.flat_flax(tree, part), _sub(arrays, part)
        if kind != "sgd":
            for name in ZERO_GRAD_PARAMS:
                start = init[f"init/{name}"]
                for side in (got, want):
                    moved = np.abs(side.pop(f"{part}/{name}") - start).max()
                    assert moved <= steps * lr * 1.01, (part, name, moved)
        _close(got, want, rel, part)
    np.testing.assert_allclose([state.seki_ema.sum.item(),
                                state.seki_ema.weight.item()],
                               arrays["seki"], rtol=1e-5)
    return state


@pytest.mark.parametrize("name,kind", [("train", "sgd"),
                                       ("train_muon", "normuon")])
def test_run_training_matches_jax_run(tmp_path, monkeypatch, name, kind):
    """The slice as a whole: the port resumes a step-0 checkpoint of the
    JAX run's initial params and trains the same steps on the same
    shards; every metrics line and the final params, EMA and SWA agree
    (normuon with Newton-Schulz in float32 on both sides)."""
    arrays, meta, data, ckpt = _start(tmp_path, name, kind)
    if meta.get("ns_dtype") == "float32":
        monkeypatch.setattr(TMUON, "NS_DTYPE", torch.float32)
    kw = dict(meta["run_training"])
    steps = kw.pop("steps")
    logs = []
    out = TCMD.run_training(data, ckpt, str(tmp_path / "export"),
                            steps=steps, device="cpu", log=logs.append,
                            **kw)
    assert out["steps"] == steps and out["export"].endswith(f"-s{steps}")
    _check_lines(_metric_lines(ckpt), meta["metrics"], 1e-4)
    _check_final(ckpt, arrays, 1e-5, kind, steps, kw["lr"])
    served = TCK.load_metadata(TCK.latest_checkpoint(ckpt))
    assert served["swa_sample_accum"] == meta["swa_sample_accum"]
    assert {k: [os.path.basename(f) for f in v]
            for k, v in served["data_serve_state"].items()
            if k != "old_train_data_dirs"} == meta["serve_state"]
    exported = TCK.load_params(out["export"])
    last = TCK.restore_checkpoint(TCK.latest_checkpoint(ckpt), TSTEP.
                                  init_train_state(exported, TSTEP.
                                                   make_optimizer(kind=kind)))
    want = last.swa_params if kw.get("swa_period_samples") else \
        last.ema_params
    assert all(torch.equal(exported[k], want[k]) for k in want)


def test_resumed_run_counts_samples_as_jax_does(tmp_path):
    """3 steps, then a resume for 3 under an -lr-schedule. The JAX package
    adds start_samples to the restored optimizer count's samples, so the
    resumed steps run at the schedule's value for 96, 112 and 128
    samples where 48, 64 and 80 were trained (ROADMAP Queue 3); the port
    does the same."""
    arrays, meta, data, ckpt = _start(tmp_path, "train_resume")
    kw = dict(meta["run_training"])
    steps = kw.pop("steps")
    TCMD.run_training(data, ckpt, None, steps=steps, device="cpu",
                      log=lambda *_: None, **kw)
    _check_lines(_metric_lines(ckpt), meta["metrics_first"], 1e-4)
    first = TCK.restore_checkpoint(
        TCK.latest_checkpoint(ckpt), TSTEP.init_train_state(
            TWT.from_flax_params(C.flax_tree(arrays, "init")),
            TSTEP.make_optimizer()))
    assert first.opt_state["count"] == meta["restored_count"] == 3
    sched = TSCH.make_lr_schedule(kw["lr"], BATCH,
                                  lr_schedule_str=kw["lr_schedule"],
                                  start_samples=3 * BATCH)
    assert [float(sched(first.opt_state["count"] + i)) for i in range(3)] \
        == meta["resumed_lrs"]
    TCMD.run_training(data, ckpt, None, steps=steps, device="cpu",
                      log=lambda *_: None, **kw)
    _check_lines(_metric_lines(ckpt), meta["metrics_resumed"], 1e-4)
    state = _check_final(ckpt, arrays, 1e-5)
    assert state.step == meta["global_step"] == 6


@pytest.mark.parametrize("kind", ["sgd", "normuon"])
def test_checkpoint_round_trip(tmp_path, kind):
    model = C.ref_model(SIZE, seed=3)
    opt = TSTEP.make_optimizer(lr=0.01, kind=kind)
    state = TSTEP.init_train_state(dict(model.state_dict()), opt)
    step = TSTEP.make_train_step(model, opt)
    for _ in range(2):
        state, _ = step(state, _batch())
    ckpt = str(tmp_path / "ckpt")
    paths = [TCK.save_checkpoint(ckpt, state, s, keep=3,
                                 metadata={"global_step": s})
             for s in (1, 2, 3, 4)]
    assert sorted(os.listdir(ckpt)) == [os.path.basename(p)
                                        for p in paths[1:]]
    assert TCK.latest_checkpoint(ckpt) == os.path.join(
        ckpt, "step_000000000004")
    assert TCK.load_metadata(paths[-1]) == {"global_step": 4}
    assert TCK.load_metadata(str(tmp_path)) == {}
    template = TSTEP.init_train_state(dict(model.state_dict()), opt)
    back = TCK.restore_checkpoint(paths[-1], template)
    assert back.step == state.step == 2

    def same(a, b):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b)
            return all(same(a[k], b[k]) for k in a)
        if isinstance(a, torch.Tensor):
            return torch.equal(a, b)
        return a == b
    for f in ("params", "opt_state", "ema_params", "swa_params"):
        assert same(getattr(state, f), getattr(back, f)), f
    assert torch.equal(back.seki_ema.sum, state.seki_ema.sum)
    other = TSTEP.init_train_state(dict(model.state_dict()),
                                   TSTEP.make_optimizer(
                                       kind="normuon" if kind == "sgd"
                                       else "sgd"))
    with pytest.raises(ValueError):
        TCK.restore_checkpoint(paths[-1], other)
    lt = TCK.maybe_save_longterm(ckpt, state, 4, every_s=3600.0)
    assert lt and os.path.exists(os.path.join(lt, TCK.STATE_FILE))
    assert TCK.maybe_save_longterm(ckpt, state, 5, every_s=3600.0) is None
    exports = str(tmp_path / "exports")
    e1 = TCK.export_params(exports, "b1c6-s1", state.params)
    e2 = TCK.export_params(exports, "b1c6-s2", state.ema_params)
    os.utime(e1, (1e9, 1e9))
    os.utime(e2, (2e9, 2e9))
    assert TCK.find_latest_model(exports) == e2
    assert TCK.find_latest_model(str(tmp_path / "none")) is None
    got = TCK.load_params(e2, dict(model.state_dict()))
    assert all(torch.equal(got[k], state.ema_params[k]) for k in got)
    assert not [d for d in os.listdir(exports) if d.startswith(".tmp")]


def test_train_cli_raises_without_cuda_or_for_multi_host(monkeypatch,
                                                         tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    C.write_shards(tmp_path / "data", SIZE, [20], 0)
    args = ["-data-dir", str(tmp_path / "data"), "-ckpt-dir",
            str(tmp_path / "ckpt"), "-size", str(SIZE), "-config", "b1c6",
            "-batch-size", "8", "-steps", "1"]
    with pytest.raises(RuntimeError, match="no CUDA"):
        TCMD.main(args)
    # -multi-host: a batch that does not split over the ranks
    with pytest.raises(ValueError, match="not divisible"):
        TCMD.main(args + ["-multi-host", "-world-size", "3", "-device",
                          "cpu"])
    assert not (tmp_path / "ckpt").exists()
