"""Traffic kind "train": the port's trainer loop, as cli/train_cmd.py's
run_training drives it, on seeded rows.

Set-up writes the cell's rows as npz shards under $TMPDIR, builds the
program's float32 net with the benchmark's seeded weights, its SGD
optimizer (train_cmd's defaults), train state and step
(train/train_step.py), and its data path (train/datagen.py's
DataFileServer, train_cmd's batch server, symmetry and device copy),
then drives that one object through its first `checked_steps` steps,
keeping what the check needs. The window runs further steps on the same
object until `--seconds` have passed. A unit of work is a train step.

The window drives a copy of run_training's loop body (next batch,
symmetry, device copy, step, one copy of the metrics to the host):
run_training takes a step count and writes checkpoints, so it cannot
be stopped at a time. The traced run keeps the untraced path (no
synchronisation of its own): host spans around the data path, and CUDA
events around the optimizer and EMA on the card's timeline.

The check (after the window, with the program's state freed): each of
the first steps' batches must be rows of the shards under one symmetry,
array for array; the plain reference (reference/train.py) then takes
the same steps from the same weights on the rows it found, and the
program's loss at each step, the per-leaf norm of its first gradient
(worked out from the optimizer's momentum after one step), the
per-leaf norm of its parameters' change over the steps and that of its
weights' EMA's change are compared with the reference's, each leaf's
gap over the larger of that leaf's reference norm and the median
leaf's (see `compare`).
"""

from __future__ import annotations

import contextlib
import random
import shutil
import sys
import time

import numpy as np
import torch

from portbench import trace as TR
from portbench.reference import net as REF_NET
from portbench.reference import rows as ROWS
from portbench.reference import train as REF_TRAIN


def _float32_reference(tf32: bool = False):
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


class State:
    pass


def setup(ctx):
    from katago_torch.cli import train_cmd as TC
    from katago_torch.models import config as MC
    from katago_torch.models import model as M
    from katago_torch.train import schedules as SCH
    from katago_torch.train import train_step as TS
    from katago_torch.train.datagen import DataFileServer

    wl, cfg = ctx.workload, ctx.cfg
    size, batch = cfg["board_size"], wl["batch"]
    st = State()
    st.opt = dict(wl["optimizer"])
    # the rows: one draw from the seed, written as the cell's shards
    st.data_dir = ctx.tmpdir / "portbench_rows" / wl["name"]
    shutil.rmtree(st.data_dir, ignore_errors=True)
    st.data_dir.mkdir(parents=True)
    stored = ROWS.make_rows(wl["rows"], size, ctx.seed % 2 ** 32)
    per = wl["rows"] // wl["shards"]
    for i in range(wl["shards"]):
        np.savez(st.data_dir / f"shard{i}.npz",
                 **{k: v[i * per:(i + 1) * per] for k, v in stored.items()})
    st.raw = ROWS.decode(stored, size)

    dev = ctx.device
    st.weights = REF_NET.make_weights(cfg, ctx.seed, dev)
    model = M.KataGoModel(MC.get_config(cfg["preset"]), size, torch.float32)
    model.load_state_dict(st.weights, strict=True)
    model = model.to(dev)
    sched = SCH.make_lr_schedule(st.opt["lr"], batch)
    optimizer = TS.make_optimizer(
        lr=sched, momentum=st.opt["momentum"],
        weight_decay=st.opt["weight_decay"], grad_clip=st.opt["grad_clip"])
    state = TS.init_train_state(dict(model.named_parameters()), optimizer)
    step_fn = TS.make_train_step(model, optimizer,
                                 ema_decay=st.opt["ema_decay"])
    serve = {"data_files_used": [], "rev_data_files_remaining": [],
             "old_train_data_dirs": []}
    gen = DataFileServer(serve, no_repeat_files=False,
                         rng=random.Random(ctx.seed))
    if not gen.set_data_dir_if_has_remaining_files(str(st.data_dir)):
        raise RuntimeError("the program found no shards")
    rng = np.random.default_rng(ctx.seed % 2 ** 32)
    batches = TC._BatchServer(gen, size, batch, rng)
    to_device = TC._ToDevice(dev)

    span = TR.span if ctx.trace_on else contextlib.nullcontext
    # traced: the optimizer and EMA phase on the card's timeline, from an
    # event recorded as the step calls optimizer.update to one recorded
    # as the step returns (no synchronisation)
    st.opt_events, st.opt_start = [], None
    st.timed = ctx.trace_on and dev.type == "cuda"
    if st.timed:
        real_update = optimizer.update

        def update(*a, **k):
            if st.in_window:
                st.opt_start = torch.cuda.Event(enable_timing=True)
                st.opt_start.record()
            return real_update(*a, **k)
        optimizer.update = update
    st.in_window = False

    def one_step(keep=None):
        """run_training's loop body: next batch, symmetry, device copy,
        step, and one device-to-host copy of the metrics."""
        nonlocal state
        with span("data"):
            hb = batches.next_batch()
            if hb is None:
                raise RuntimeError("the program's data server ran dry")
            hb = TC._apply_symmetry(hb, size, int(rng.integers(0, 8)))
        with span("h2d"):
            dbatch = to_device(hb)
        with span("train_step"):
            state, metrics = step_fn(state, dbatch)
        if st.opt_start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            st.opt_events.append((st.opt_start, end))
            st.opt_start = None
        with span("metrics"):
            values = dict(zip(metrics, torch.stack(list(metrics.values()))
                              .cpu().tolist()))
        if keep is not None:
            keep.append(({k: np.array(v) for k, v in hb.items()}, values))
        return values

    # the checked steps: the same object the window drives
    st.p0 = {k: v.detach().clone() for k, v in state.params.items()}
    st.fed = []
    st.first_grad = None
    for i in range(wl["checked_steps"]):
        one_step(st.fed)
        if i == 0:
            wd = st.opt["weight_decay"]
            st.first_grad = {k: torch.linalg.vector_norm(
                t - wd * st.p0[k]).item()
                for k, t in state.opt_state["trace"].items()}
    st.change = {k: torch.linalg.vector_norm(v - st.p0[k]).item()
                 for k, v in state.params.items()}
    st.ema_change = {k: torch.linalg.vector_norm(v - st.p0[k]).item()
                     for k, v in state.ema_params.items()}
    del st.p0
    st.one_step = one_step
    return st


def window(st, ctx):
    steps = failed = 0
    st.in_window = True
    with ctx.measure():
        while True:
            try:
                st.one_step()
            except RuntimeError:
                failed += 1
            steps += 1
            if ctx.past_deadline(time.time()):
                break
            if ctx.trace_on and steps >= ctx.workload["trace_steps"]:
                break
    st.in_window = False
    torch.cuda.synchronize()
    elapsed = time.time() - ctx.window_start
    rows = steps * ctx.workload["batch"]
    if st.opt_events:
        ctx.counters["opt_device_s"] = sum(
            a.elapsed_time(b) for a, b in st.opt_events) * 1e-3
        ctx.counters["opt_steps"] = len(st.opt_events)
    return {"attempted": steps, "failed": failed,
            "e2e": {"train_rows_per_s": rows / elapsed},
            "counts": {"steps": steps, "rows": rows}}


def readings(st, cfg, size, tf32=False, half_batch=False,
             other_decay=None):
    """The reference's steps over the batches the program was fed: a dict
    of the rows that differ ("wrong"), the losses, the first gradient's
    leaf norms ("g1"), the leaf norms of the params' change and of the
    EMA's change; with other_decay, also the EMA's change at that decay
    ("ema_change_other", the trajectory's EMA at a wrong decay)."""
    _float32_reference(tf32)
    params = {k: v.clone() for k, v in st.weights.items()}
    trace = {k: torch.zeros_like(v) for k, v in params.items()}
    emas = {d: {k: v.clone() for k, v in params.items()}
            for d in (st.opt["ema_decay"], other_decay) if d is not None}
    dev = next(iter(params.values())).device
    seki = (torch.tensor(0.0, device=dev), torch.tensor(0.001, device=dev))
    wrong, losses, g1 = 0, [], None
    for hb, _ in st.fed:
        sym, idx, bad, want = ROWS.match_batch(hb, st.raw, size)
        wrong += bad
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                 for k, v in want.items()}
        params, trace, lval, grads, seki = REF_TRAIN.sgd_step(
            cfg, params, trace, batch, seki, st.opt, half_batch=half_batch)
        emas = {d: REF_TRAIN.ema_step(e, params, d) for d, e in emas.items()}
        losses.append(lval.item())
        if g1 is None:
            g1 = {k: torch.linalg.vector_norm(g).item()
                  for k, g in grads.items()}
        del grads

    def change(t):
        return {k: torch.linalg.vector_norm(t[k] - st.weights[k]).item()
                for k in t}
    out = dict(wrong=wrong, losses=losses, g1=g1, change=change(params),
               ema_change=change(emas[st.opt["ema_decay"]]))
    if other_decay is not None:
        out["ema_change_other"] = change(emas[other_decay])
    _float32_reference(False)
    return out


def compare(prog, ref, look=None):
    """The gaps of the program's readings `prog` (losses, g1, change,
    ema_change) from the reference's `ref`: the loss gap is the worst
    step's relative gap, the gradient gap the worst leaf's, and the
    change and EMA gaps the median leaf's: a leaf's change over three
    steps is a few float32 steps of its values (a gamma near 1 moves by
    a few ulps), so the worst leaf's change gap is round-off and swings
    from seed to seed. Leaves whose reference gradient is under a
    thousandth of the median leaf's are left out of the changes (they
    move by round-off alone). look: a dict that receives the worst
    leaves and the count left out."""
    ref_g1 = ref["g1"]
    out = {"loss_gap": max(abs(p - r) / abs(r) for p, r in zip(
        prog["losses"], ref["losses"]))}
    med_g = float(np.median(list(ref_g1.values())))
    per_leaf = {"grad": {k: abs(prog["g1"][k] - ref_g1[k])
                         / max(ref_g1[k], med_g) for k in ref_g1}}
    out["grad_gap"] = max(per_leaf["grad"].values())
    moved = [k for k in ref_g1 if ref_g1[k] >= 1e-3 * med_g]
    for key, name in (("change", "change_gap"), ("ema_change", "ema_gap")):
        med = float(np.median([ref[key][k] for k in moved]))
        per_leaf[key] = {k: abs(prog[key][k] - ref[key][k])
                         / max(ref[key][k], med) for k in moved}
        out[name] = float(np.median(list(per_leaf[key].values())))
    if look is not None:
        for key, d in per_leaf.items():
            k = max(d, key=d.get)
            look[key + "_worst"] = [k, d[k], ref[key if key != "grad"
                                                else "g1"][k],
                                    ref_g1[k] / med_g]
        look["left_out"] = len(ref_g1) - len(moved)
    return out


def _program(st):
    return dict(losses=[v["loss"] for _, v in st.fed], g1=st.first_grad,
                change=st.change, ema_change=st.ema_change)


def judge(st, ctx):
    cfg, wl = ctx.cfg, ctx.workload
    st.one_step = None          # frees the program's state
    torch.cuda.empty_cache()
    st.ref = ref = readings(st, cfg, cfg["board_size"])
    for name, d in (("program change", st.change),
                    ("program EMA change", st.ema_change),
                    ("reference change", ref["change"]),
                    ("reference gradient", ref["g1"])):
        bad = [k for k, v in d.items() if not np.isfinite(v)]
        if bad:
            print(f"portbench: non-finite {name} in {bad[:8]}",
                  file=sys.stderr)
    gaps = compare(_program(st), ref)
    shutil.rmtree(st.data_dir, ignore_errors=True)
    lim = wl["limits"]
    return [("rows_wrong", float(ref["wrong"]), 0.0)] + [
        (name, gaps[name], lim[name])
        for name in ("loss_gap", "grad_gap", "change_gap", "ema_gap")]


def control(st, ctx):
    """The control and the faults, each put in the program's place and
    compared with the float32 reference as the program is: the reference
    in TF32; the reference leaving out half of each batch; its EMA at
    decay 0.99 (the EMA's fault); and an EMA left unchanged (which reads
    1 by construction)."""
    size = ctx.cfg["board_size"]
    out = {}
    for name, kw in (("tf32", {"tf32": True}),
                     ("half_batch", {"half_batch": True}),
                     ("ema_decay_099", {"other_decay": 0.99})):
        got = readings(st, ctx.cfg, size, **kw)
        if name == "ema_decay_099":
            got["ema_change"] = got["ema_change_other"]
        look = {}
        out[name] = compare(got, st.ref, look=look)
        out[name]["look"] = look
    frozen = dict(_program(st), ema_change={k: 0.0 for k in st.ema_change})
    out["ema_unchanged"] = compare(frozen, st.ref)
    look = {}
    compare(_program(st), st.ref, look=look)
    out["program_look"] = look
    return out
