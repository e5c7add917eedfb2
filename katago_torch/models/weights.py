"""Weights for the port's net: carry-over from the JAX package's Flax
parameter tree, and a seeded initializer for runs without JAX.

`from_flax_params` maps a Flax tree (given as numpy arrays) onto the
state_dict of models.model.KataGoModel: module names match the Flax
auto-names, conv kernels go HWIO -> OIHW and dense kernels [in, out] ->
[out, in]. `to_flax_params` is its inverse (the exporter and the tests
use it). `init_weights` mirrors the JAX package's initializers: katago_init
(model.py:56) for conv and dense kernels — truncated normal with std =
scale * gain / sqrt(fan_in) / 0.8796 at +-2 std, zeros where scale is 0
— and flax's lecun_normal for the transformer projections (the same law
at gain 1, scale 1); biases and betas zero, gammas and RMSNorm scales
one, the GAB frequencies geometric. Draws come from a torch.Generator,
so the numbers differ from JAX's. The carry-over handles every leaf
shape: 4-D and 2-D kernels are transposed, 1-D leaves (biases, betas,
gammas, RMSNorm scales, GAB freqs) copied. The same function carries a
Flax GenBoard tree into models.genboard.GenBoardModel, whose modules are
named after the Flax ones; its global-pooling `matg` matrices are not
kernels and keep their [in, out] layout.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from katago_torch.models import model as M

_TRUNC_CORRECTION = 0.87962566103423978


def from_flax_params(params_np: dict) -> dict:
    """Flax params (the dict under "params", numpy leaves) -> state_dict
    of KataGoModel or GenBoardModel."""
    out = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + k + ".")
                continue
            a = np.array(v, dtype=np.float32)
            if k == "kernel" and a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            elif k == "kernel" and a.ndim == 2:
                a = a.T
            out[prefix + k] = torch.from_numpy(np.ascontiguousarray(a).copy())

    walk(params_np, "")
    return out


def to_flax_params(state_dict: dict) -> dict:
    """state_dict -> the Flax params tree (the dict under "params") with
    numpy float32 leaves: OIHW -> HWIO, [out, in] -> [in, out]."""
    out: dict = {}
    for key, t in state_dict.items():
        *path, leaf = key.split(".")
        a = t.detach().float().cpu().numpy()
        if leaf == "kernel" and a.ndim == 4:
            a = a.transpose(2, 3, 1, 0)
        elif leaf == "kernel" and a.ndim == 2:
            a = a.T
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(a)
    return out


@torch.no_grad()
def init_weights(model: M.KataGoModel, seed: int) -> M.KataGoModel:
    """Seeded katago_init-style initialization of every kernel, in module
    order; returns the model."""
    gen = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, (M.ConvCore, M.Dense)):
            w = mod.kernel
            if mod.init_scale == 0.0:
                w.zero_()
            else:
                fan_in = w.shape[1] * (w.shape[2] * w.shape[3]
                                       if w.dim() == 4 else 1)
                std = (mod.init_scale * M.GAINS[mod.init_activation]
                       / math.sqrt(fan_in) / _TRUNC_CORRECTION)
                t = torch.empty(w.shape)
                torch.nn.init.trunc_normal_(t, 0.0, std, -2.0 * std,
                                            2.0 * std, generator=gen)
                w.copy_(t)
            if isinstance(mod, M.Dense) and mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, M.NormMask):
            mod.beta.zero_()
            if mod.gamma is not None:
                mod.gamma.fill_(1.0)
        elif isinstance(mod, M.RMSNorm):
            mod.scale.fill_(1.0)
        elif isinstance(mod, M.GABTemplates):
            mod.freqs.copy_(M.GABTemplates.initial_freqs(mod.freqs.numel()))
    return model
