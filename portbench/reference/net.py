"""Plain forward of a KataGo nested-bottleneck net (the "bottlenest2"
block family of KataGo's python/katago/train/model_pytorch.py), written
from the configuration's shapes in plain torch.

Weights are a dict keyed by the parameter paths of the published flax
layout (module auto-names joined by dots, kernels OIHW / [out, in]);
`param_shapes` lists them for a configuration. Everything computes in
float32 unless `quant` names a lower precision: then every convolution
and dense input and weight is rounded to that dtype first (the control
of the benchmark's comparison).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

EXTRA_SCORE_DISTR_RADIUS = 60


def num_policy_outputs(cfg: dict) -> int:
    v = cfg["version"]
    return 4 if v <= 11 else (6 if v <= 15 else 8)


def block_kinds(cfg: dict) -> list[str]:
    return [kind for kind, n in cfg["blocks"] for _ in range(n)]


def internal_length(kind: str) -> int:
    if not kind.startswith("bottlenest"):
        raise ValueError(f"block kind {kind!r} is not a nested bottleneck")
    return int(kind[len("bottlenest")])


def param_shapes(cfg: dict) -> dict[str, tuple]:
    """Parameter path -> shape, in the order the weights are drawn."""
    c, mid, gp = cfg["trunk"], cfg["mid"], cfg["gpool"]
    p1, g1, v1 = cfg["p1"], cfg["g1"], cfg["v1"]
    v2, sbv2, k = cfg["v2"], cfg["sbv2"], cfg["num_scorebeliefs"]
    npol = num_policy_outputs(cfg)
    s = {"Conv_0.Conv_0.kernel": (c, 22, 3, 3), "Dense_0.kernel": (c, 19)}
    for b, kind in enumerate(block_kinds(cfg)):
        pre = f"NestedBottleneckResBlock_{b}."
        s[pre + "NormActConv_0.NormMask_0.beta"] = (c,)
        s[pre + "NormActConv_0.Conv_0.Conv_0.kernel"] = (mid, c, 1, 1)
        for i in range(internal_length(kind)):
            rb = f"{pre}ResBlock_{i}."
            s[rb + "NormActConv_0.NormMask_0.beta"] = (mid,)
            inner = mid
            if i == 0 and kind.endswith("gpool"):
                inner = mid - gp
                cg = rb + "NormActConv_0.ConvAndGPool_0."
                s[cg + "Conv_0.Conv_0.kernel"] = (inner, mid, 3, 3)
                s[cg + "Conv_1.Conv_0.kernel"] = (gp, mid, 3, 3)
                s[cg + "NormMask_0.beta"] = (gp,)
                s[cg + "Dense_0.kernel"] = (inner, 3 * gp)
            else:
                s[rb + "NormActConv_0.Conv_0.Conv_0.kernel"] = (mid, mid, 3, 3)
            s[rb + "NormActConv_1.NormMask_0.beta"] = (inner,)
            s[rb + "NormActConv_1.NormMask_0.gamma"] = (inner,)
            s[rb + "NormActConv_1.Conv_0.Conv_0.kernel"] = (mid, inner, 3, 3)
        s[pre + "NormActConv_1.NormMask_0.beta"] = (mid,)
        s[pre + "NormActConv_1.NormMask_0.gamma"] = (mid,)
        s[pre + "NormActConv_1.Conv_0.Conv_0.kernel"] = (c, mid, 1, 1)
    s["NormMask_0.beta"] = (c,)
    s["NormMask_0.gamma"] = (c,)
    ph = "PolicyHead_0."
    s[ph + "Conv_0.Conv_0.kernel"] = (p1, c, 1, 1)
    s[ph + "Conv_1.Conv_0.kernel"] = (g1, c, 1, 1)
    s[ph + "NormMask_0.beta"] = (g1,)
    s[ph + "Dense_0.kernel"] = (p1, 3 * g1)
    s[ph + "Dense_0.bias"] = (p1,)
    s[ph + "Dense_1.kernel"] = (npol, p1)
    s[ph + "Dense_2.kernel"] = (p1, 3 * g1)
    s[ph + "NormMask_1.beta"] = (p1,)
    s[ph + "Conv_2.Conv_0.kernel"] = (npol, p1, 1, 1)
    vh = "ValueHead_0."
    s[vh + "Conv_0.Conv_0.kernel"] = (v1, c, 1, 1)
    s[vh + "NormMask_0.beta"] = (v1,)
    for name, shape, bias in (("Dense_0", (v2, 3 * v1), True),
                              ("Dense_1", (3, v2), True),
                              ("Dense_2", (10, v2), True),
                              ("Dense_3", (8, v2), True)):
        s[vh + name + ".kernel"] = shape
        s[vh + name + ".bias"] = (shape[0],)
    s[vh + "Conv_1.Conv_0.kernel"] = (1, v1, 1, 1)
    s[vh + "Conv_2.Conv_0.kernel"] = (1, v1, 1, 1)
    s[vh + "Conv_3.Conv_0.kernel"] = (2, c, 1, 1)
    s[vh + "Conv_4.Conv_0.kernel"] = (4, c, 1, 1)
    s[vh + "Dense_4.kernel"] = (sbv2, 3 * v1)
    s[vh + "Dense_4.bias"] = (sbv2,)
    s[vh + "Dense_5.kernel"] = (sbv2, 1)
    s[vh + "Dense_6.kernel"] = (sbv2, 1)
    s[vh + "Dense_7.kernel"] = (k, sbv2)
    s[vh + "Dense_7.bias"] = (k,)
    s[vh + "Dense_8.kernel"] = (k, 3 * v1)
    s[vh + "Dense_8.bias"] = (k,)
    return s


BRANCH_GAIN = 0.2     # last convolution of a residual branch
HEAD_GAIN = 0.3       # the layers that give the heads' outputs
_HEAD_OUT = ("PolicyHead_0.Conv_2", "PolicyHead_0.Dense_1",
             "ValueHead_0.Dense_1", "ValueHead_0.Dense_2",
             "ValueHead_0.Dense_3", "ValueHead_0.Conv_1",
             "ValueHead_0.Conv_2", "ValueHead_0.Conv_3",
             "ValueHead_0.Conv_4", "ValueHead_0.Dense_7",
             "ValueHead_0.Dense_8")


@torch.no_grad()
def make_weights(cfg: dict, seed: int, device, dtype=torch.float32) -> dict:
    """Seeded weights for `cfg`, drawn on `device` in one call: kernels
    N(0, (gain / sqrt(fan_in))^2) with gain sqrt(2) (ReLU), BRANCH_GAIN on
    the last convolution of each residual branch (so that the trunk stays
    in range over its depth, as KataGo's fixup initialisation starts its
    branches small) and HEAD_GAIN on the heads' output layers; betas and
    biases N(0, 0.1^2); gammas 1 + N(0, 0.1^2)."""
    shapes = param_shapes(cfg)
    total = sum(math.prod(sh) for sh in shapes.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        t = flat[at:at + n].view(shape)
        at += n
        leaf = name.rsplit(".", 1)[1]
        if leaf == "kernel":
            fan_in = math.prod(shape[1:])
            gain = math.sqrt(2.0)
            if "NormActConv_1.Conv_0" in name:
                gain = BRANCH_GAIN
            elif name.startswith(_HEAD_OUT):
                gain = HEAD_GAIN
            t = t * (gain / math.sqrt(fan_in))
        elif leaf == "gamma":
            t = 1.0 + 0.1 * t
        else:
            t = 0.1 * t
        out[name] = t.to(dtype)
    _normalise_heads(cfg, out, gen)
    return out


POLICY_STD = 1.0      # spread of the policy logits on the probe positions
VALUE_STD = 0.5       # and of the value logits


@torch.no_grad()
def _normalise_heads(cfg: dict, w: dict, gen) -> None:
    """Scale the policy and value output layers so that their logits
    spread alike for every seed (POLICY_STD, VALUE_STD over a few random
    probe positions): how peaked the priors and values are, and with it
    how deep the search's trees grow, then depends little on the seed."""
    size = cfg["board_size"]
    dev = w["Dense_0.kernel"].device
    x = (torch.rand((8, size, size, 22), generator=gen, device=dev)
         < 0.15).float()
    x[..., 0] = 1.0
    g = torch.randn((8, 19), generator=gen, device=dev) * 0.5
    out = forward(cfg, {k: v.float() for k, v in w.items()}, x, g)
    pol = out["policy_logits"][:, 0]
    for name, t, want in (("PolicyHead_0.Conv_2.Conv_0.kernel", pol,
                           POLICY_STD),
                          ("PolicyHead_0.Dense_1.kernel", pol, POLICY_STD),
                          ("ValueHead_0.Dense_1.kernel",
                           out["value_logits"], VALUE_STD)):
        w[name] = w[name] * (want / t.std().clamp(min=1e-12))


def _q(x, quant):
    return x if quant is None else x.to(quant).to(torch.float32)


def _conv(x, w, quant):
    k = w.shape[-1]
    return F.conv2d(_q(x, quant), _q(w, quant), padding=k // 2)


def _dense(x, w, quant, b=None):
    return F.linear(_q(x, quant), _q(w, quant), b)


def _norm(x, mask, beta, gamma=None):
    if gamma is not None:
        x = x * gamma.reshape(1, -1, 1, 1)
    return (x + beta.reshape(1, -1, 1, 1)) * mask


def _gpool(x, mask, mask_sum):
    sq = torch.sqrt(mask_sum) - 14.0
    mean = x.sum(dim=(2, 3), keepdim=True) / mask_sum
    mx = torch.amax(x + (mask - 1.0), dim=(2, 3), keepdim=True)
    return torch.cat([mean, mean * (sq / 10.0), mx], dim=1)[:, :, 0, 0]


def _value_gpool(x, mask_sum):
    sq = torch.sqrt(mask_sum) - 14.0
    mean = x.sum(dim=(2, 3), keepdim=True) / mask_sum
    return torch.cat([mean, mean * (sq / 10.0),
                      mean * (sq * sq / 100.0 - 0.1)], dim=1)[:, :, 0, 0]


def forward(cfg: dict, w: dict, spatial, global_in, quant=None) -> dict:
    """spatial float[B, H, W, 22], global float[B, 19] -> the raw heads:
    policy_logits [B, P, H*W+1], value_logits [B, 3], miscvalue [B, 10],
    moremiscvalue [B, 8], ownership_pretanh / scoring_presoftmax [B, H, W],
    futurepos_pretanh [B, H, W, 2], seki_logits [B, H, W, 4],
    scorebelief_logprobs [B, 2 * (H * W + 60)]."""
    relu = F.relu
    b, h, wd, _ = spatial.shape
    x_in = spatial.permute(0, 3, 1, 2).float()
    global_in = global_in.float()
    mask = torch.ones((b, 1, h, wd), device=x_in.device)
    msum = mask.sum(dim=(2, 3), keepdim=True)
    x = _conv(x_in, w["Conv_0.Conv_0.kernel"], quant) + \
        _dense(global_in, w["Dense_0.kernel"], quant)[:, :, None, None]

    def nac(pre, x, gamma=False):
        """NormActConv with a plain conv: norm, ReLU, conv."""
        y = relu(_norm(x, mask, w[pre + "NormMask_0.beta"],
                       w[pre + "NormMask_0.gamma"] if gamma else None))
        return _conv(y, w[pre + "Conv_0.Conv_0.kernel"], quant)

    for i, kind in enumerate(block_kinds(cfg)):
        pre = f"NestedBottleneckResBlock_{i}."
        out = nac(pre + "NormActConv_0.", x)
        for r in range(internal_length(kind)):
            rb = f"{pre}ResBlock_{r}."
            cg = rb + "NormActConv_0.ConvAndGPool_0."
            if cg + "Conv_0.Conv_0.kernel" in w:
                y = relu(_norm(out, mask,
                               w[rb + "NormActConv_0.NormMask_0.beta"]))
                outr = _conv(y, w[cg + "Conv_0.Conv_0.kernel"], quant)
                outg = relu(_norm(
                    _conv(y, w[cg + "Conv_1.Conv_0.kernel"], quant), mask,
                    w[cg + "NormMask_0.beta"]))
                bias = _dense(_gpool(outg, mask, msum),
                              w[cg + "Dense_0.kernel"], quant)
                mid = outr + bias[:, :, None, None]
            else:
                mid = nac(rb + "NormActConv_0.", out)
            out = out + nac(rb + "NormActConv_1.", mid, gamma=True)
        x = x + nac(pre + "NormActConv_1.", out, gamma=True)
    x = relu(_norm(x, mask, w["NormMask_0.beta"], w["NormMask_0.gamma"]))

    ph = "PolicyHead_0."
    outp = _conv(x, w[ph + "Conv_0.Conv_0.kernel"], quant)
    outg = relu(_norm(_conv(x, w[ph + "Conv_1.Conv_0.kernel"], quant), mask,
                      w[ph + "NormMask_0.beta"]))
    pooled = _gpool(outg, mask, msum)
    outpass = _dense(relu(_dense(pooled, w[ph + "Dense_0.kernel"], quant,
                                 w[ph + "Dense_0.bias"])),
                     w[ph + "Dense_1.kernel"], quant)
    outp = outp + _dense(pooled, w[ph + "Dense_2.kernel"],
                         quant)[:, :, None, None]
    outp = relu(_norm(outp, mask, w[ph + "NormMask_1.beta"]))
    outp = _conv(outp, w[ph + "Conv_2.Conv_0.kernel"], quant)
    outp = outp - (1.0 - mask) * 5000.0
    policy = torch.cat([outp.reshape(b, outp.shape[1], h * wd),
                        outpass[:, :, None]], dim=2)

    vh = "ValueHead_0."

    def vd(name, t):
        bias = w.get(vh + name + ".bias")
        return _dense(t, w[vh + name + ".kernel"], quant, bias)

    v1 = relu(_norm(_conv(x, w[vh + "Conv_0.Conv_0.kernel"], quant), mask,
                    w[vh + "NormMask_0.beta"]))
    pooled = _value_gpool(v1, msum)
    v2 = relu(vd("Dense_0", pooled))
    own = _conv(v1, w[vh + "Conv_1.Conv_0.kernel"], quant) * mask
    scoring = _conv(v1, w[vh + "Conv_2.Conv_0.kernel"], quant) * mask
    futurepos = _conv(x, w[vh + "Conv_3.Conv_0.kernel"], quant) * mask
    seki = _conv(x, w[vh + "Conv_4.Conv_0.kernel"], quant) * mask
    sb_len = 2 * (h * wd + EXTRA_SCORE_DISTR_RADIUS)
    mid = sb_len // 2
    idx = torch.arange(sb_len, device=x.device, dtype=torch.float32)
    offset = (0.05 * (idx - mid + 0.5))[None, :, None]
    parity = (0.5 - torch.remainder(idx - mid, 2.0))[None, :]
    s2 = vd("Dense_4", pooled)[:, None, :]
    s2off = vd("Dense_5", offset)
    s2par = vd("Dense_6", (parity * global_in[:, -1:])[:, :, None])
    sv3 = vd("Dense_7", relu(s2 + s2off + s2par))
    mix = F.log_softmax(vd("Dense_8", pooled), dim=1)
    belief = torch.logsumexp(F.log_softmax(sv3, dim=1) + mix[:, None, :],
                             dim=2)
    return {
        "policy_logits": policy,
        "value_logits": vd("Dense_1", v2),
        "miscvalue": vd("Dense_2", v2),
        "moremiscvalue": vd("Dense_3", v2),
        "ownership_pretanh": own[:, 0],
        "scoring_presoftmax": scoring[:, 0],
        "futurepos_pretanh": futurepos.permute(0, 2, 3, 1),
        "seki_logits": seki.permute(0, 2, 3, 1),
        "scorebelief_logprobs": belief,
    }
