"""Learner: optimizer, EMA, and the train step — port of
katago_tpu/train/train_step.py.

Reference: python/train.py's per-GPU loop (train.py:1422-1637) with SGD
momentum, gradient clipping, and SWA/EMA (train.py:36,814-818). The
optimizers are the JAX package's optax chains written out on state_dicts:
the same order of clipping, weight decay, momentum and learning rate, the
same state, and a learning-rate count that is the optimizer state's own
(a checkpoint restores it).

Precision: the JAX trainer computes its net in float32. PyTorch lets
cuDNN convolutions run in TF32 by default, so the step runs inside
`float32_precision()`, which turns TF32 off for convolutions and matmuls
and restores the caller's setting afterwards. Newton-Schulz (muon.py)
stays in bfloat16, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any

import numpy as np
import torch
from torch.func import functional_call

from katago_torch.train.losses import (LossScales, SekiEma, compute_losses,
                                       unowned_prop_rows)


@contextlib.contextmanager
def float32_precision():
    """Convolutions and matmuls in true float32 (TF32 off) inside."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tree.values()))


def _clip_by_global_norm(grads: dict, max_norm: float) -> dict:
    """optax.clip_by_global_norm: unchanged below max_norm, else
    (t / norm) * max_norm."""
    g_norm = global_norm(grads)
    trigger = g_norm < max_norm
    return {k: torch.where(trigger, t, (t / g_norm) * max_norm)
            for k, t in grads.items()}


class Sgd:
    """optax.chain(clip_by_global_norm(grad_clip),
    add_decayed_weights(weight_decay), sgd(lr, momentum)):
    g -> clip -> g + wd * p -> trace = g + momentum * trace ->
    -lr(count) * trace. State: {"count", "trace"}."""

    def __init__(self, lr, momentum: float, weight_decay: float,
                 grad_clip: float):
        self.lr, self.momentum = lr, momentum
        self.weight_decay, self.grad_clip = weight_decay, grad_clip

    def init(self, params: dict) -> dict:
        return {"count": 0,
                "trace": {k: torch.zeros_like(p) for k, p in params.items()}}

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict):
        grads = _clip_by_global_norm(grads, self.grad_clip)
        count = state["count"]
        lr = self.lr(count) if callable(self.lr) else self.lr
        neg_lr = -float(np.float32(lr))
        trace, updates = {}, {}
        for k, g in grads.items():
            g = g + self.weight_decay * params[k]
            trace[k] = g + self.momentum * state["trace"][k]
            updates[k] = neg_lr * trace[k]
        return updates, {"count": count + 1, "trace": trace}


class ClippedMuon:
    """optax.chain(clip_by_global_norm(grad_clip), muon(...))."""

    def __init__(self, inner, grad_clip: float):
        self.inner, self.grad_clip = inner, grad_clip

    def init(self, params: dict) -> dict:
        return self.inner.init(params)

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict):
        return self.inner.update(
            _clip_by_global_norm(grads, self.grad_clip), state, params)


def make_optimizer(lr=6e-5, momentum: float = 0.9,
                   weight_decay: float = 3e-5, grad_clip: float = 1e6,
                   kind: str = "sgd"):
    """Optimizer factory. lr may be a float or a schedule callable
    (train.schedules).

    kind="sgd": SGD+momentum with decoupled weight decay, the reference's
    default family. kind="muon"/"normuon"/"polar": the reference's Muon
    family (python/muon/muon.py) — matrix params via orthogonalized
    momentum, AdamW for the rest."""
    if kind == "sgd":
        return Sgd(lr, momentum, weight_decay, grad_clip)
    if kind not in ("muon", "normuon", "polar"):
        raise ValueError(f"unknown optimizer kind {kind!r}")
    from katago_torch.train.muon import muon
    return ClippedMuon(muon(lr, weight_decay=weight_decay,
                            normuon=(kind == "normuon"),
                            use_polar_express=(kind in ("polar", "normuon"))),
                       grad_clip)


@dataclasses.dataclass
class TrainState:
    params: dict               # state_dict keys -> float32 tensors
    opt_state: Any
    ema_params: dict           # per-step EMA of weights for export
    swa_params: dict           # SWA average, sampled every swa period
    step: int
    seki_ema: SekiEma          # seki loss moving unowned-proportion state


def init_train_state(params: dict, optimizer) -> TrainState:
    params = {k: v.detach().clone() for k, v in params.items()}
    dev = next(iter(params.values())).device
    return TrainState(
        params=params,
        opt_state=optimizer.init(params),
        ema_params={k: v.clone() for k, v in params.items()},
        swa_params={k: v.clone() for k, v in params.items()},
        step=0,
        seki_ema=SekiEma.init(dev),
    )


def _forward(model, params, batch):
    spatial = batch["binaryInputNCHW"].permute(0, 2, 3, 1)  # NHWC
    return functional_call(model, params,
                           (spatial, batch["globalInputNC"]))


def make_train_step(model, optimizer, ema_decay: float = 0.999,
                    scales: LossScales = LossScales(),
                    timings: dict | None = None, mesh=None):
    """Returns train_step(state, batch) -> (state, metrics).

    model: the port's KataGoModel (float32); it supplies the architecture,
    state.params the weights (torch.func.functional_call). batch: the
    reference-schema dict of dataio.trainingwrite.read_npz as float32
    tensors on the model's device. metrics: 0-dim tensors, gnorm
    included.

    timings: optional dict that collects, synchronising the device at
    each boundary, the seconds spent in forward+backward ("fwd_bwd_s")
    and in the optimizer update and EMA ("opt_s").

    mesh: a parallel.mesh.Mesh when batch is this rank's slice of a
    global batch (data parallelism). The loss is the whole batch's: its
    sums over rows are divided by the global weight sum and the seki
    statistic is the global mean (one all-reduce of three numbers before
    the forward), each rank's gradient is scaled by its share of the
    weight, and the gradients and metrics are summed over the ranks (one
    all-reduce each), so every rank applies the same update."""

    def clock(key=None, t0=0.0):
        """Synchronise (when timing) and return now; with a key, add the
        seconds since t0 to timings[key]."""
        if timings is None:
            return 0.0
        dev = next(iter(model.parameters())).device
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        if key is not None:
            timings[key] = timings.get(key, 0.0) + now - t0
        return now

    def train_step(state: TrainState, batch: dict):
        with float32_precision():
            t = clock()
            params = {k: v.detach().requires_grad_(True)
                      for k, v in state.params.items()}
            raw = _forward(model, params, batch)
            metrics, seki_ema, grads = _loss_grads(
                raw, batch, params, scales, state.seki_ema, mesh)
            t = clock("fwd_bwd_s", t)
            with torch.no_grad():
                updates, opt_state = optimizer.update(
                    grads, state.opt_state, state.params)
                new_params = {k: p + updates[k]
                              for k, p in state.params.items()}
                ema = {k: ema_decay * e + (1.0 - ema_decay) * new_params[k]
                       for k, e in state.ema_params.items()}
                gnorm = global_norm(grads)
            clock("opt_s", t)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["gnorm"] = gnorm
        return TrainState(new_params, opt_state, ema, state.swa_params,
                          state.step + 1, seki_ema), metrics

    return train_step


def _loss_grads(raw, batch, params, scales, seki_ema, mesh):
    """compute_losses on this rank's slice (the whole batch without a
    mesh) as its share of the global batch's loss: (metrics and
    gradients summed over the ranks, the seki EMA). Without a mesh the
    share is 1 and the sums are the rank's own."""
    from katago_torch.parallel.mesh import all_reduce_sum
    gw = batch["globalTargetsNC"][:, 25]
    rows = unowned_prop_rows(batch)
    (stats,) = all_reduce_sum([torch.stack([
        gw.sum(), rows.sum(), torch.tensor(float(rows.shape[0]),
                                           device=gw.device)])], mesh)
    loss, metrics, seki_ema = compute_losses(
        raw, batch, scales=scales, seki_ema=seki_ema, is_training=True,
        unowned_prop=stats[1] / stats[2])
    share = torch.clamp(gw.sum(), min=1e-8) / torch.clamp(stats[0],
                                                          min=1e-8)
    grads = torch.autograd.grad(loss * share, list(params.values()))
    names = list(metrics)
    summed = all_reduce_sum(list(grads) + [torch.stack(
        [metrics[k].detach() * share for k in names])], mesh)
    return (dict(zip(names, summed[-1])), seki_ema,
            dict(zip(params, summed[:-1])))


def make_eval_step(model, scales: LossScales = LossScales()):
    """Validation step: eval_step(params, batch, seki_ema) -> metrics
    (no gradient, is_training=False — the reference's val pass,
    train.py:1578-1621)."""

    @torch.no_grad()
    def eval_step(params, batch, seki_ema):
        with float32_precision():
            raw = _forward(model, params, batch)
            _, metrics, _ = compute_losses(
                raw, batch, scales=scales, seki_ema=seki_ema,
                is_training=False)
        return metrics

    return eval_step
