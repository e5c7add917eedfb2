"""KataGo-family net as a torch nn.Module — port of the convolutional part
of katago_tpu/models/model.py (model_pytorch.py in the reference).

Masked conv trunk with fixup "norm" (gamma/beta then mask), KataGPool
global-pooling bias branches, regular and nested-bottleneck residual
blocks, and the full head set. Block kinds "regular[gpool]" and
"bottlenest2[gpool]" are ported; transformer, metadata-encoder and
intermediate-head configs raise NotImplementedError.

Layouts: the public forward takes the JAX package's NHWC spatial input
[B, H, W, 22] and global input [B, 19] and returns the same output
layouts; inside, activations are NCHW. `dtype` is the compute dtype of
the trunk convolutions (bfloat16 for search, float32 for the tests),
applied where flax's `dtype=` applies it, so the float32 heads and
promotions match: weights stay float32 and are cast at use.

Submodules carry the flax auto-names (Conv_0, Dense_1, NormMask_0,
NestedBottleneckResBlock_3, ...) and parameters the flax leaf names
(kernel, bias, beta, gamma), so a state_dict key is the flax parameter
path joined by dots (models/weights.py).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from katago_torch.models.config import ModelConfig

GAINS = {"relu": math.sqrt(2.0), "elu": math.sqrt(1.55052),
         "mish": math.sqrt(2.210277), "silu": math.sqrt(2.0),
         "gelu": math.sqrt(2.351718), "identity": 1.0}


def act_fn(name: str):
    return {"relu": F.relu, "elu": F.elu, "mish": F.mish, "silu": F.silu,
            "gelu": F.gelu, "identity": lambda x: x}[name]


class ConvCore(nn.Module):
    """flax nn.Conv, SAME padding, no bias; kernel stored OIHW."""

    def __init__(self, c_in, c_out, k, activation, scale):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(c_out, c_in, k, k))
        self.init_activation, self.init_scale = activation, scale

    def forward(self, x, dtype):
        k = self.kernel.shape[-1]
        return F.conv2d(x.to(dtype), self.kernel.to(dtype), padding=k // 2)


class Conv(nn.Module):
    def __init__(self, c_in, c_out, k, activation, scale, dtype):
        super().__init__()
        self.Conv_0 = ConvCore(c_in, c_out, k, activation, scale)
        self.dtype = dtype

    def forward(self, x):
        return self.Conv_0(x, self.dtype)


class Dense(nn.Module):
    """flax nn.Dense; kernel stored [out, in]. dtype None computes in the
    promoted input/param dtype (flax's default)."""

    def __init__(self, c_in, c_out, activation, scale, use_bias=True,
                 dtype=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(c_out, c_in))
        self.bias = nn.Parameter(torch.zeros(c_out)) if use_bias else None
        self.init_activation, self.init_scale = activation, scale
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype or torch.promote_types(x.dtype, self.kernel.dtype)
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.kernel.to(dt), b)


class NormMask(nn.Module):
    """Fixup 'norm': (x [* gamma] + beta) * mask."""

    def __init__(self, channels, use_gamma=False):
        super().__init__()
        self.beta = nn.Parameter(torch.zeros(channels))
        self.gamma = nn.Parameter(torch.ones(channels)) if use_gamma else None

    def forward(self, x, mask):
        if self.gamma is not None:
            x = x * self.gamma.to(x.dtype).reshape(1, -1, 1, 1)
        return (x + self.beta.to(x.dtype).reshape(1, -1, 1, 1)) * mask


def kata_gpool(x, mask, mask_sum_hw):
    """(mean, mean*(sqrt(area)-14)/10, max) over the board -> [B, 3C]."""
    xf = x.float()
    sqrt_off = torch.sqrt(mask_sum_hw) - 14.0
    mean = xf.sum(dim=(2, 3), keepdim=True) / mask_sum_hw
    mx = torch.amax(xf + (mask - 1.0), dim=(2, 3), keepdim=True)
    return torch.cat([mean, mean * (sqrt_off / 10.0), mx], dim=1)[:, :, 0, 0]


def value_head_gpool(x, mask, mask_sum_hw):
    xf = x.float()
    sqrt_off = torch.sqrt(mask_sum_hw) - 14.0
    mean = xf.sum(dim=(2, 3), keepdim=True) / mask_sum_hw
    return torch.cat([mean, mean * (sqrt_off / 10.0),
                      mean * (sqrt_off * sqrt_off / 100.0 - 0.1)],
                     dim=1)[:, :, 0, 0]


class ConvAndGPool(nn.Module):
    def __init__(self, c_in, c_out, c_gpool, activation, scale, dtype):
        super().__init__()
        r_scale, g_scale = 0.8, 0.6
        self.Conv_0 = Conv(c_in, c_out, 3, activation, scale * r_scale, dtype)
        self.Conv_1 = Conv(c_in, c_gpool, 3, activation,
                           math.sqrt(scale) * math.sqrt(g_scale), dtype)
        self.NormMask_0 = NormMask(c_gpool)
        self.Dense_0 = Dense(3 * c_gpool, c_out, activation,
                             math.sqrt(scale) * math.sqrt(g_scale),
                             use_bias=False, dtype=dtype)
        self.act = act_fn(activation)
        self.dtype = dtype

    def forward(self, x, mask, mask_sum_hw):
        outr = self.Conv_0(x)
        outg = self.act(self.NormMask_0(self.Conv_1(x), mask))
        pooled = kata_gpool(outg, mask, mask_sum_hw)
        bias = self.Dense_0(pooled.to(self.dtype))
        return outr + bias[:, :, None, None]


class NormActConv(nn.Module):
    def __init__(self, c_in, c_out, activation, kernel, scale, c_gpool=None,
                 use_gamma=False, dtype=torch.float32):
        super().__init__()
        self.NormMask_0 = NormMask(c_in, use_gamma=use_gamma)
        if c_gpool is not None:
            self.ConvAndGPool_0 = ConvAndGPool(c_in, c_out, c_gpool,
                                               activation, scale, dtype)
        else:
            self.Conv_0 = Conv(c_in, c_out, kernel, activation, scale, dtype)
        self.gpool = c_gpool is not None
        self.act = act_fn(activation)

    def forward(self, x, mask, mask_sum_hw):
        x = self.act(self.NormMask_0(x, mask))
        if self.gpool:
            return self.ConvAndGPool_0(x, mask, mask_sum_hw)
        return self.Conv_0(x)


class ResBlock(nn.Module):
    """Pre-activation residual block; returns the residual only."""

    def __init__(self, c_main, c_mid, activation, fixup_scale, c_gpool=None,
                 dtype=torch.float32):
        super().__init__()
        c_inner = c_mid - (c_gpool or 0)
        self.NormActConv_0 = NormActConv(c_main, c_inner, activation, 3,
                                         fixup_scale, c_gpool=c_gpool,
                                         dtype=dtype)
        self.NormActConv_1 = NormActConv(c_inner, c_main, activation, 3, 0.0,
                                         use_gamma=True, dtype=dtype)

    def forward(self, x, mask, mask_sum_hw):
        out = self.NormActConv_0(x, mask, mask_sum_hw)
        return self.NormActConv_1(out, mask, mask_sum_hw)


class NestedBottleneckResBlock(nn.Module):
    """1x1 down -> internal_length ResBlocks -> 1x1 up; returns residual."""

    def __init__(self, c_main, c_mid, internal_length, activation,
                 fixup_scale, c_gpool=None, dtype=torch.float32):
        super().__init__()
        inner_scale = math.pow(fixup_scale, 1.0 / (1.0 + internal_length))
        self.NormActConv_0 = NormActConv(c_main, c_mid, activation, 1,
                                         inner_scale, dtype=dtype)
        self.internal_length = internal_length
        for i in range(internal_length):
            setattr(self, f"ResBlock_{i}", ResBlock(
                c_mid, c_mid, activation, inner_scale,
                c_gpool=(c_gpool if i == 0 else None), dtype=dtype))
        self.NormActConv_1 = NormActConv(c_mid, c_main, activation, 1, 0.0,
                                         use_gamma=True, dtype=dtype)

    def forward(self, x, mask, mask_sum_hw):
        out = self.NormActConv_0(x, mask, mask_sum_hw)
        for i in range(self.internal_length):
            out = out + getattr(self, f"ResBlock_{i}")(out, mask, mask_sum_hw)
        return self.NormActConv_1(out, mask, mask_sum_hw)


class PolicyHead(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype):
        super().__init__()
        actn = cfg.activation
        c = cfg.trunk_num_channels
        p1, g1 = cfg.p1_num_channels, cfg.g1_num_channels
        n_out = cfg.num_policy_outputs
        self.Conv_0 = Conv(c, p1, 1, actn, 0.8, dtype)
        self.Conv_1 = Conv(c, g1, 1, actn, 1.0, dtype)
        self.NormMask_0 = NormMask(g1)
        self.Dense_0 = Dense(3 * g1, p1, actn, 1.0)
        self.Dense_1 = Dense(p1, n_out, "identity", 0.3, use_bias=False)
        self.Dense_2 = Dense(3 * g1, p1, actn, 0.6, use_bias=False,
                             dtype=dtype)
        self.NormMask_1 = NormMask(p1)
        self.Conv_2 = Conv(p1, n_out, 1, "identity", 0.3, torch.float32)
        self.act = act_fn(actn)
        self.dtype = dtype

    def forward(self, x, mask, mask_sum_hw):
        b, _, h, w = x.shape
        outp = self.Conv_0(x)
        outg = self.act(self.NormMask_0(self.Conv_1(x), mask))
        pooled = kata_gpool(outg, mask, mask_sum_hw)
        outpass = self.Dense_1(self.act(self.Dense_0(pooled)))
        bias = self.Dense_2(pooled.to(self.dtype))
        outp = outp + bias[:, :, None, None]
        outp = self.act(self.NormMask_1(outp, mask))
        outp = self.Conv_2(outp.float())
        outp = outp - (1.0 - mask) * 5000.0
        outp = outp.reshape(b, outp.shape[1], h * w)
        return torch.cat([outp, outpass[:, :, None]], dim=2)


class ValueHead(nn.Module):
    def __init__(self, cfg: ModelConfig, pos_len: int):
        super().__init__()
        actn = cfg.activation
        c, v1 = cfg.trunk_num_channels, cfg.v1_num_channels
        f32 = torch.float32
        sbv2, k = cfg.sbv2_num_channels, cfg.num_scorebeliefs
        self.Conv_0 = Conv(c, v1, 1, actn, 1.0, f32)
        self.NormMask_0 = NormMask(v1)
        self.Dense_0 = Dense(3 * v1, cfg.v2_size, actn, 1.0)
        self.Dense_1 = Dense(cfg.v2_size, 3, "identity", 1.0)
        self.Dense_2 = Dense(cfg.v2_size, 10, "identity", 1.0)
        self.Dense_3 = Dense(cfg.v2_size, 8, "identity", 1.0)
        self.Conv_1 = Conv(v1, 1, 1, "identity", 0.2, f32)
        self.Conv_2 = Conv(v1, 1, 1, "identity", 0.2, f32)
        self.Conv_3 = Conv(c, 2, 1, "identity", 0.2, f32)
        self.Conv_4 = Conv(c, 4, 1, "identity", 0.2, f32)
        self.Dense_4 = Dense(3 * v1, sbv2, actn, 1.0)
        self.Dense_5 = Dense(1, sbv2, actn, 1.0, use_bias=False)
        self.Dense_6 = Dense(1, sbv2, actn, 1.0, use_bias=False)
        self.Dense_7 = Dense(sbv2, k, "identity", 0.5)
        self.Dense_8 = Dense(3 * v1, k, "identity", 1.0)
        self.act = act_fn(actn)
        sb_len = cfg.scorebelief_len(pos_len)
        mid = sb_len // 2
        self.register_buffer("offset_bias", torch.tensor(
            [0.05 * (float(i - mid) + 0.5) for i in range(sb_len)],
            dtype=f32)[None, :, None], persistent=False)
        self.register_buffer("parity", torch.tensor(
            [0.5 - float((i - mid) % 2) for i in range(sb_len)],
            dtype=f32)[None, :], persistent=False)

    def forward(self, x, mask, mask_sum_hw, input_global):
        xf = x.float()
        v1 = self.act(self.NormMask_0(self.Conv_0(xf), mask))
        pooled = value_head_gpool(v1, mask, mask_sum_hw)
        v2 = self.act(self.Dense_0(pooled))
        own = self.Conv_1(v1) * mask
        scoring = self.Conv_2(v1) * mask
        futurepos = self.Conv_3(xf) * mask
        seki = self.Conv_4(xf) * mask
        s2 = self.Dense_4(pooled)[:, None, :]
        s2off = self.Dense_5(self.offset_bias)
        wave = input_global[:, -1:]
        s2par = self.Dense_6((self.parity * wave)[:, :, None])
        sv2 = self.act(s2 + s2off + s2par)
        sv3 = self.Dense_7(sv2)
        smix = self.Dense_8(pooled)
        mix_logw = F.log_softmax(smix, dim=1)
        sb_logprobs = F.log_softmax(sv3, dim=1)
        scorebelief = torch.logsumexp(sb_logprobs + mix_logw[:, None, :],
                                      dim=2)
        return {
            "value_logits": self.Dense_1(v2),
            "miscvalue": self.Dense_2(v2),
            "moremiscvalue": self.Dense_3(v2),
            "ownership_pretanh": own[:, 0],
            "scoring_presoftmax": scoring[:, 0],
            "futurepos_pretanh": futurepos.permute(0, 2, 3, 1),
            "seki_logits": seki.permute(0, 2, 3, 1),
            "scorebelief_logprobs": scorebelief,
        }


class KataGoModel(nn.Module):
    """Full net. forward(spatial [B,H,W,22], global [B,19], mask=None) ->
    dict of head tensors in the JAX package's layouts."""

    def __init__(self, cfg: ModelConfig, pos_len: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if cfg.metadata_encoder or cfg.has_intermediate_head:
            raise NotImplementedError(
                "metadata encoder / intermediate heads are not ported")
        self.cfg, self.pos_len, self.dtype = cfg, pos_len, dtype
        actn = cfg.activation
        c = cfg.trunk_num_channels
        self.Conv_0 = Conv(22, c, 1 if cfg.initial_conv_1x1 else 3, actn, 0.8,
                           dtype)
        self.Dense_0 = Dense(19, c, actn, 0.6, use_bias=False, dtype=dtype)
        fixup_scale = 1.0 / math.sqrt(max(len(cfg.block_kind), 1))
        self.block_names = []
        counts = {}
        for kind in cfg.block_kind:
            use_gpool = kind.endswith("gpool")
            base = kind[:-5] if use_gpool else kind
            c_gp = cfg.gpool_num_channels if use_gpool else None
            if base == "regular":
                cls = "ResBlock"
                blk = ResBlock(c, cfg.mid_num_channels, actn, fixup_scale,
                               c_gpool=c_gp, dtype=dtype)
            elif base == "bottlenest2":
                cls = "NestedBottleneckResBlock"
                blk = NestedBottleneckResBlock(c, cfg.mid_num_channels, 2,
                                               actn, fixup_scale,
                                               c_gpool=c_gp, dtype=dtype)
            else:
                raise NotImplementedError(f"block kind {kind!r} is not ported")
            name = f"{cls}_{counts.get(cls, 0)}"
            counts[cls] = counts.get(cls, 0) + 1
            setattr(self, name, blk)
            self.block_names.append(name)
        self.NormMask_0 = NormMask(c, use_gamma=True)
        self.PolicyHead_0 = PolicyHead(cfg, dtype)
        self.ValueHead_0 = ValueHead(cfg, pos_len)
        self.act = act_fn(actn)

    def forward(self, spatial, global_in, mask=None):
        b, h, w, _ = spatial.shape
        x_in = spatial.permute(0, 3, 1, 2)
        if mask is None:
            mask = torch.ones((b, 1, h, w), dtype=torch.float32,
                              device=spatial.device)
        else:
            mask = mask.permute(0, 3, 1, 2).float()
        mask_sum_hw = mask.sum(dim=(2, 3), keepdim=True)
        x = self.Conv_0(x_in)
        g = self.Dense_0(global_in.to(self.dtype))
        x = x + g[:, :, None, None]
        for name in self.block_names:
            x = x + getattr(self, name)(x, mask, mask_sum_hw)
        x = self.act(self.NormMask_0(x, mask))
        policy = self.PolicyHead_0(x, mask, mask_sum_hw)
        return {"policy_logits": policy,
                **self.ValueHead_0(x, mask, mask_sum_hw, global_in)}


def postprocess_outputs(raw: dict) -> dict:
    """Raw head tensors -> NNOutput-style quantities (see the JAX
    package's postprocess_outputs for the scaling conventions)."""
    mv, mmv = raw["miscvalue"], raw["moremiscvalue"]
    return {
        "policy_log_probs": F.log_softmax(raw["policy_logits"][:, 0, :], -1),
        "value_probs": F.softmax(raw["value_logits"], dim=-1),
        "score_mean": mv[:, 0] * 20.0,
        "score_stdev": F.softplus(mv[:, 1]) * 20.0,
        "lead": mv[:, 2] * 20.0,
        "variance_time": F.softplus(mv[:, 3]) * 40.0,
        "shortterm_value_error": F.softplus(mmv[:, 0] * 0.5) * 0.5,
        "shortterm_score_error": F.softplus(mmv[:, 1] * 0.5) * 5.4772256,
        "ownership": torch.tanh(raw["ownership_pretanh"]),
    }
