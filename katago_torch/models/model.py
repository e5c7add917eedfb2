"""KataGo-family net as a torch nn.Module — port of
katago_tpu/models/model.py (model_pytorch.py in the reference).

Masked conv trunk with fixup "norm" (gamma/beta then mask), KataGPool
global-pooling bias branches, regular and nested-bottleneck residual
blocks (bottle1-3, bottlenest2, each with its gpool form), the v17
transformer blocks (RMSNorm, grouped-query attention with optional
QK-norm, interleaved 2-D RoPE or the Geometric Attention Bias, plain or
SwiGLU FFNs, and the nested-bottleneck transformer hybrids), the humanSL
metadata encoder, intermediate heads (mid-trunk or trunk end), and the
full head set.

Layouts: the public forward takes the JAX package's NHWC spatial input
[B, H, W, 22] and global input [B, 19] (and optional metadata [B, 192])
and returns the same output layouts; inside, activations are NCHW, and
the transformer blocks view them as [B, H*W, C]. `dtype` is the compute
dtype of the trunk convolutions and projections (bfloat16 for search,
float32 for the tests), applied where flax's `dtype=` applies it, so
the float32 heads, softmaxes and promotions match: weights stay float32
and are cast at use. Attention is plain matmuls with a float32 softmax,
as the JAX package writes it (no kernel of its own on either side).

Submodules carry the flax auto-names (Conv_0, Dense_1, NormMask_0,
NestedBottleneckResBlock_3, TransformerAttentionBlock_0, q_proj,
gab_templates, MetadataEncoder_0, intermediate_policy_head, ...) and
parameters the flax leaf names (kernel, bias, beta, gamma, scale,
freqs), so a state_dict key is the flax parameter path joined by dots
(models/weights.py).
"""

from __future__ import annotations

import functools
import math

import numpy as np
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


class RMSNorm(nn.Module):
    """torch.nn.RMSNorm over the last axis, computed in float32 and
    returned in the input's dtype (the JAX package's RMSNorm)."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.eps = eps

    def forward(self, x):
        xf = x.float()
        ms = torch.mean(xf * xf, dim=-1, keepdim=True)
        return (xf * torch.rsqrt(ms + self.eps) * self.scale).to(x.dtype)


@functools.lru_cache(maxsize=None)
def rope_cos_sin_2d(dim: int, pos_len: int, theta: float = 100.0,
                    pos_w: int | None = None):
    """precompute_freqs_cos_sin_2d (model_pytorch.py:1415-1435): 2-D RoPE
    tables, interleaved layout, first half of each head's pairs rotating
    with the row and the second with the column, over a pos_len x pos_w
    grid (pos_w defaults to pos_len). Returns (cos, sin) float32 numpy
    [pos_len * pos_w, dim]."""
    assert dim % 4 == 0
    dim_half = dim // 2
    freqs = 1.0 / (theta ** (np.arange(0, dim_half, 2, dtype=np.float32)
                             / dim_half))
    grid_h, grid_w = np.meshgrid(
        np.arange(pos_len, dtype=np.float32),
        np.arange(pos_w or pos_len, dtype=np.float32), indexing="ij")
    emb = np.concatenate([grid_h[..., None] * freqs,
                          grid_w[..., None] * freqs], axis=-1).reshape(
        -1, dim_half)
    emb = np.repeat(emb, 2, axis=-1)
    return np.cos(emb), np.sin(emb)


def rotate_every_two(x):
    """(x0, x1) pairs of the last axis -> (-x1, x0)."""
    x2 = x.reshape(x.shape[:-1] + (-1, 2))
    return torch.stack([-x2[..., 1], x2[..., 0]], dim=-1).reshape(x.shape)


def apply_rope(q, k, cos, sin):
    """apply_rotary_emb (model_pytorch.py:1437-1455). q, k: [B, S, H, D];
    cos, sin: [S, D] float32; results in q's and k's dtypes."""
    cos = cos[None, :, None, :]
    sin = sin[None, :, None, :]
    q2 = q * cos + rotate_every_two(q) * sin
    k2 = k * cos + rotate_every_two(k) * sin
    return q2.to(q.dtype), k2.to(k.dtype)


class GABTemplates(nn.Module):
    """Geometric Attention Bias templates (GABTemplateMLP,
    model_pytorch.py:1423-1470): learnable Fourier frequencies over the
    relative offsets (dr, dc, dr+dc, dr-dc) -> MLP -> T translational
    bias templates [S, S, T], shared by every GAB attention block."""

    def __init__(self, cfg: ModelConfig, pos_len: int):
        super().__init__()
        nf, nt = cfg.gab_num_fourier_features, cfg.gab_num_templates
        self.freqs = nn.Parameter(torch.empty(nf))
        self.linear1 = Dense(8 * nf, cfg.gab_mlp_hidden, cfg.activation, 1.0)
        self.linear2 = Dense(cfg.gab_mlp_hidden, nt, "identity", 1.0)
        self.act = act_fn(cfg.activation)
        self.num_templates = nt
        idx = np.arange(pos_len * pos_len)
        sr, sc = idx // pos_len, idx % pos_len
        dr = (sr[:, None] - sr[None, :]).astype(np.float32)
        dc = (sc[:, None] - sc[None, :]).astype(np.float32)
        self.register_buffer("combos", torch.from_numpy(np.stack(
            [dr, dc, dr + dc, dr - dc], -1)), persistent=False)

    @staticmethod
    def initial_freqs(n: int) -> torch.Tensor:
        """The geometric init, 1 rad/square down to 1/50 rad/square."""
        return torch.exp(torch.linspace(math.log(1.0), math.log(1.0 / 50.0),
                                        n))

    def forward(self, s: int):
        ang = self.combos[:s, :s, :, None] * self.freqs      # [S,S,4,F]
        feats = torch.cat([torch.sin(ang), torch.cos(ang)],
                          dim=-1).reshape(s, s, -1)
        t = self.linear2(self.act(self.linear1(feats)))
        return t / math.sqrt(self.num_templates)             # [S,S,T]


def _proj(c_in, c_out, dtype):
    """A bias-free projection with flax's lecun_normal init (truncated
    normal, std 1/sqrt(fan_in), as katago_init("identity", 1.0))."""
    return Dense(c_in, c_out, "identity", 1.0, use_bias=False, dtype=dtype)


class TransformerAttentionBlock(nn.Module):
    """v17 attention half-block (model_pytorch.py:2079): RMSNorm -> GQA
    projections (transformer_kv_heads; optional QK-norm) -> 2-D RoPE ->
    attention over board positions with off-board keys masked and the
    softmax in float32 -> out projection. Returns the residual.

    use_gab: the Geometric Attention Bias — per-head mixtures of the
    shared translational templates (GABTemplates), chosen from the
    pooled board state, added to the logits (_compute_gab_bias,
    model_pytorch.py:2208-2281)."""

    def __init__(self, cfg: ModelConfig, pos_len: int, c: int,
                 use_rope: bool = True, use_gab: bool = False,
                 dtype=torch.float32):
        super().__init__()
        nh = cfg.transformer_heads
        nkv = cfg.transformer_kv_heads or nh
        self.nh, self.nkv, self.qd = nh, nkv, c // nh
        self.dtype = dtype
        self.RMSNorm_0 = RMSNorm(c)
        self.q_proj = _proj(c, nh * self.qd, dtype)
        self.k_proj = _proj(c, nkv * self.qd, dtype)
        self.v_proj = _proj(c, nkv * self.qd, dtype)
        self.qk_norm = cfg.attention_qk_norm
        if self.qk_norm:
            self.q_norm = RMSNorm(self.qd)
            self.k_norm = RMSNorm(self.qd)
        self.use_rope = use_rope
        if use_rope:
            cos, sin = rope_cos_sin_2d(self.qd, pos_len, cfg.rope_theta)
            self.register_buffer("rope_cos", torch.from_numpy(cos),
                                 persistent=False)
            self.register_buffer("rope_sin", torch.from_numpy(sin),
                                 persistent=False)
        self.use_gab = use_gab
        if use_gab:
            nt = cfg.gab_num_templates
            self.num_templates = nt
            self.gab_proj1 = _proj(c, cfg.gab_d1, dtype)
            self.gab_proj2 = _proj(cfg.gab_d1, cfg.gab_d2, dtype)
            self.gab_norm1 = RMSNorm(cfg.gab_d2)
            self.gab_proj3 = _proj(cfg.gab_d2, nh * nt, dtype)
            self.gab_norm2 = RMSNorm(nh * nt)
            self.act = act_fn(cfg.activation)
        self.out_proj = _proj(nh * self.qd, c, dtype)

    def forward(self, x, mask, mask_sum_hw, gab_templates=None):
        b, c, h, w = x.shape
        s = h * w
        nh, nkv, qd, dt = self.nh, self.nkv, self.qd, self.dtype
        xn = self.RMSNorm_0(x.flatten(2).transpose(1, 2)).to(dt)  # [B,S,C]
        q = self.q_proj(xn).reshape(b, s, nh, qd)
        k = self.k_proj(xn).reshape(b, s, nkv, qd)
        v = self.v_proj(xn).reshape(b, s, nkv, qd)
        if self.qk_norm:
            q = self.q_norm(q).to(dt)
            k = self.k_norm(k).to(dt)
        if self.use_rope:
            q, k = apply_rope(q, k, self.rope_cos, self.rope_sin)
        if nh > nkv:
            k = k.repeat_interleave(nh // nkv, dim=2)
            v = v.repeat_interleave(nh // nkv, dim=2)
        # the JAX package divides by a numpy scalar, which promotes the
        # logits to float32
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / \
            math.sqrt(qd)
        if self.use_gab:
            assert gab_templates is not None, \
                "GAB block needs the shared template tensor"
            y = self.gab_proj1(xn)                           # [B,S,d1]
            pooled = torch.sum(y * mask.reshape(b, s, 1), dim=1) / \
                mask_sum_hw.reshape(b, 1)
            z = self.gab_norm1(self.act(self.gab_proj2(pooled)))
            z = self.gab_norm2(self.act(self.gab_proj3(z)))
            z = z.reshape(b, nh, self.num_templates)
            logits = logits + torch.einsum(
                "bhd,std->bhst", z.float(), gab_templates.float())
        logits = torch.where(mask.reshape(b, 1, 1, s) > 0, logits, -1e30)
        att = torch.softmax(logits.float(), dim=-1).to(dt)
        out = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(b, s, nh * qd)
        out = self.out_proj(out)
        return out.transpose(1, 2).reshape(b, c, h, w) * mask


class TransformerFFNBlock(nn.Module):
    """v17 FFN half-block (model_pytorch.py:2485): RMSNorm -> FFN (the
    config's activation, or SwiGLU: silu of linear1 times the gate
    projection) -> projection. Returns the residual."""

    def __init__(self, cfg: ModelConfig, c: int, use_swiglu: bool = False,
                 dtype=torch.float32):
        super().__init__()
        ffn = cfg.transformer_ffn_channels
        self.dtype = dtype
        self.RMSNorm_0 = RMSNorm(c)
        self.ffn_linear1 = _proj(c, ffn, dtype)
        self.use_swiglu = use_swiglu
        if use_swiglu:
            self.ffn_linear_gate = _proj(c, ffn, dtype)
        self.ffn_linear2 = _proj(ffn, c, dtype)
        self.act = act_fn(cfg.activation)

    def forward(self, x, mask, mask_sum_hw):
        xn = self.RMSNorm_0(x.permute(0, 2, 3, 1)).to(self.dtype)
        y = self.ffn_linear1(xn)
        if self.use_swiglu:
            y = F.silu(y) * self.ffn_linear_gate(xn)
        else:
            y = self.act(y)
        return self.ffn_linear2(y).permute(0, 3, 1, 2) * mask


class NestedBottleneckTransformerBlock(nn.Module):
    """1x1 conv down -> internal_length x (attention + FFN) at mid width
    -> 1x1 conv up; returns the residual (model_pytorch.py:1921-2018, the
    "nbttf" hybrids)."""

    def __init__(self, cfg: ModelConfig, pos_len: int, internal_length: int,
                 use_swiglu: bool = True, use_rope: bool = True,
                 use_gab: bool = False, fixup_scale: float = 1.0,
                 dtype=torch.float32):
        super().__init__()
        inner_scale = math.pow(fixup_scale, 1.0 / (1.0 + internal_length))
        c, mid = cfg.trunk_num_channels, cfg.mid_num_channels
        self.NormActConv_0 = NormActConv(c, mid, cfg.activation, 1,
                                         inner_scale, dtype=dtype)
        self.internal_length = internal_length
        for i in range(internal_length):
            setattr(self, f"attn{i + 1}", TransformerAttentionBlock(
                cfg, pos_len, mid, use_rope=use_rope, use_gab=use_gab,
                dtype=dtype))
            setattr(self, f"ffn{i + 1}", TransformerFFNBlock(
                cfg, mid, use_swiglu=use_swiglu, dtype=dtype))
        self.NormActConv_1 = NormActConv(mid, c, cfg.activation, 1, 0.0,
                                         use_gamma=True, dtype=dtype)

    def forward(self, x, mask, mask_sum_hw, gab_templates=None):
        out = self.NormActConv_0(x, mask, mask_sum_hw)
        for i in range(self.internal_length):
            out = out + getattr(self, f"attn{i + 1}")(
                out, mask, mask_sum_hw, gab_templates=gab_templates)
            out = out + getattr(self, f"ffn{i + 1}")(out, mask, mask_sum_hw)
        return self.NormActConv_1(out, mask, mask_sum_hw)


class MetadataEncoder(nn.Module):
    """HumanSL SGF-metadata conditioning (model_pytorch.py:2881): 192
    metadata floats, channel 86 (board area) masked out -> 2-layer MLP ->
    trunk bias, scaled by 0.5."""

    def __init__(self, cfg: ModelConfig, internal_channels: int = 64):
        super().__init__()
        actn = cfg.activation
        self.Dense_0 = Dense(192, internal_channels, actn, 0.8)
        self.Dense_1 = Dense(internal_channels, internal_channels, actn, 0.8)
        self.Dense_2 = Dense(internal_channels, cfg.trunk_num_channels, actn,
                             0.8, use_bias=False)
        self.act = act_fn(actn)
        m = torch.ones(192)
        m[86] = 0.0
        self.register_buffer("feature_mask", m, persistent=False)

    def forward(self, input_meta):
        x = input_meta.float() * self.feature_mask
        x = self.act(self.Dense_0(x))
        x = self.act(self.Dense_1(x))
        return 0.5 * self.Dense_2(x)


def block_spec(kind: str):
    """A block kind -> (class name, kwargs of its constructor beyond the
    shared ones), mirroring the dispatch of the JAX KataGoModel."""
    if kind in ("attnrope", "attn"):
        return "TransformerAttentionBlock", {"use_rope": kind == "attnrope"}
    if kind in ("ffng", "ffnsg"):
        return "TransformerFFNBlock", {"use_swiglu": kind == "ffnsg"}
    if kind.startswith("bottlenest") and "transformer" in kind:
        return "NestedBottleneckTransformerBlock", {
            "internal_length": int(kind[len("bottlenest")]),
            "use_gab": "gab" in kind, "use_rope": "rope" in kind,
            "use_swiglu": kind.endswith("sg")}
    use_gpool = kind.endswith("gpool")
    base = kind[:-5] if use_gpool else kind
    if base == "regular":
        return "ResBlock", {"gpool": use_gpool}
    if base in ("bottle1", "bottle2", "bottle3", "bottlenest2"):
        return "NestedBottleneckResBlock", {
            "internal_length": 2 if base == "bottlenest2" else int(base[-1]),
            "gpool": use_gpool}
    raise ValueError(f"unsupported block kind {kind!r}")


class KataGoModel(nn.Module):
    """Full net. forward(spatial [B,H,W,22], global [B,19], mask=None,
    metadata=None [B,192]) -> dict of head tensors in the JAX package's
    layouts, plus intermediate_* heads when the config has them."""

    def __init__(self, cfg: ModelConfig, pos_len: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg, self.pos_len, self.dtype = cfg, pos_len, dtype
        actn = cfg.activation
        c = cfg.trunk_num_channels
        self.Conv_0 = Conv(22, c, 1 if cfg.initial_conv_1x1 else 3, actn, 0.8,
                           dtype)
        self.Dense_0 = Dense(19, c, actn, 0.6, use_bias=False, dtype=dtype)
        if cfg.metadata_encoder:
            self.MetadataEncoder_0 = MetadataEncoder(
                cfg, internal_channels=cfg.metadata_encoder_channels)
        num_blocks = len(cfg.block_kind)
        fixup_scale = 1.0 / math.sqrt(max(num_blocks, 1))
        self.blocks = []            # (attribute name, takes gab templates)
        counts = {}
        for kind in cfg.block_kind:
            cls, kw = block_spec(kind)
            if cls == "ResBlock":
                blk = ResBlock(c, cfg.mid_num_channels, actn, fixup_scale,
                               c_gpool=(cfg.gpool_num_channels
                                        if kw["gpool"] else None),
                               dtype=dtype)
            elif cls == "NestedBottleneckResBlock":
                blk = NestedBottleneckResBlock(
                    c, cfg.mid_num_channels, kw["internal_length"], actn,
                    fixup_scale, c_gpool=(cfg.gpool_num_channels
                                          if kw["gpool"] else None),
                    dtype=dtype)
            elif cls == "TransformerAttentionBlock":
                blk = TransformerAttentionBlock(cfg, pos_len, c,
                                                use_rope=kw["use_rope"],
                                                dtype=dtype)
            elif cls == "TransformerFFNBlock":
                blk = TransformerFFNBlock(cfg, c, use_swiglu=kw["use_swiglu"],
                                          dtype=dtype)
            else:
                if kw["use_gab"] and not hasattr(self, "gab_templates"):
                    # built once, shared by every GAB block
                    self.gab_templates = GABTemplates(cfg, pos_len)
                blk = NestedBottleneckTransformerBlock(
                    cfg, pos_len, kw["internal_length"],
                    use_swiglu=kw["use_swiglu"], use_rope=kw["use_rope"],
                    use_gab=kw["use_gab"], fixup_scale=fixup_scale,
                    dtype=dtype)
            name = f"{cls}_{counts.get(cls, 0)}"
            counts[cls] = counts.get(cls, 0) + 1
            setattr(self, name, blk)
            self.blocks.append((name, cls == "NestedBottleneckTransformerBlock"))
        # intermediate heads: tapped before block intermediate_head_blocks,
        # or at the trunk end when that is >= the block count
        # (model_pytorch.py:3510-3521, modelconfigs.py:2107-2108)
        self.intermediate_at = None
        if cfg.has_intermediate_head:
            self.intermediate_at = min(cfg.intermediate_head_blocks,
                                       num_blocks)
            self.norm_intermediate_trunkfinal = NormMask(c, use_gamma=True)
            self.intermediate_policy_head = PolicyHead(cfg, dtype)
            self.intermediate_value_head = ValueHead(cfg, pos_len)
        self.NormMask_0 = NormMask(c, use_gamma=True)
        self.PolicyHead_0 = PolicyHead(cfg, dtype)
        self.ValueHead_0 = ValueHead(cfg, pos_len)
        self.act = act_fn(actn)

    def _intermediate(self, x, mask, mask_sum_hw, global_in) -> dict:
        xi = self.act(self.norm_intermediate_trunkfinal(x, mask))
        ival = self.intermediate_value_head(xi, mask, mask_sum_hw, global_in)
        return {"intermediate_policy_logits": self.intermediate_policy_head(
                    xi, mask, mask_sum_hw),
                **{f"intermediate_{k}": v for k, v in ival.items()}}

    def forward(self, spatial, global_in, mask=None, metadata=None):
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
        if self.cfg.metadata_encoder:
            if metadata is None:
                metadata = torch.zeros((b, 192), dtype=torch.float32,
                                       device=spatial.device)
            meta_bias = self.MetadataEncoder_0(metadata)
            x = x + meta_bias[:, :, None, None].to(self.dtype)
        gab = None
        if hasattr(self, "gab_templates"):
            gab = self.gab_templates(self.pos_len * self.pos_len)
        inter = {}
        for i, (name, takes_gab) in enumerate(self.blocks):
            if i == self.intermediate_at:
                inter = self._intermediate(x, mask, mask_sum_hw, global_in)
            blk = getattr(self, name)
            if takes_gab:
                x = x + blk(x, mask, mask_sum_hw, gab_templates=gab)
            else:
                x = x + blk(x, mask, mask_sum_hw)
        if self.intermediate_at == len(self.blocks):
            inter = self._intermediate(x, mask, mask_sum_hw, global_in)
        x = self.act(self.NormMask_0(x, mask))
        policy = self.PolicyHead_0(x, mask, mask_sum_hw)
        return {"policy_logits": policy,
                **self.ValueHead_0(x, mask, mask_sum_hw, global_in),
                **inter}


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
