"""KataGo .bin.gz / .txt.gz model format: parser and a PyTorch forward.

The port's own copy of the parser of katago_tpu/models/desc.py (every
block kind, model versions 3..17, the same ModelParseError and sha256),
and `DescNet`, an nn.Module built from a parsed ModelDesc that computes
the JAX package's `apply_desc_model` for every family it reads:
ordinary, gpool and nested-bottleneck blocks, merged batch norms and
activations, the v17 transformer attention blocks (grouped-query, fixed
or learnable 2-D RoPE, off-board keys masked) and FFN blocks (plain or
SwiGLU), the trunk-tip RMSNorm, the SGF metadata encoder of humanSL nets
(`forward(..., metadata=)`), the policy head with the v15+ pass MLP, the
value head and the version normalization of its score channels
(`_normalize_value_channels`). It returns the raw-output dict that the
port's search reads from KataGoModel, keys included.

Layout: the file stores conv weights y,x,ic,oc (HWIO) and matmuls
ic,oc; `DescNet` converts them once, at construction, to OIHW and
[out, in] and runs NCHW inside (the transformer blocks view the trunk
as [B, H*W, C]); callers pass NHWC planes as they do to KataGoModel. The
forward runs in float32 with TF32 off (the JAX desc forward is float32);
its convolutions and matmuls are cuDNN/cuBLAS. RoPE tables are computed
in numpy exactly as the JAX package computes them, once per board shape.
"""

from __future__ import annotations

import dataclasses
import gzip
import hashlib
import threading

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from katago_torch.models.model import rope_cos_sin_2d, rotate_every_two


class ModelParseError(ValueError):
    pass


class _Reader:
    """Tokenized reader over the decompressed model bytes, with @BIN@ blobs."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def token(self) -> str:
        d, n = self.data, len(self.data)
        p = self.pos
        while p < n and d[p:p + 1].isspace():
            p += 1
        start = p
        while p < n and not d[p:p + 1].isspace():
            p += 1
        self.pos = p
        if start == p:
            raise ModelParseError("unexpected end of model file")
        return d[start:p].decode("ascii")

    def int(self) -> int:
        return int(self.token())

    def float(self) -> float:
        return float(self.token())

    def floats(self, count: int) -> np.ndarray:
        """Weight blob: binary @BIN@ payload or `count` text floats."""
        d = self.data
        p = self.pos
        while p < len(d) and d[p:p + 1].isspace():
            p += 1
        if d[p:p + 5] == b"@BIN@":
            p += 5
            out = np.frombuffer(d, dtype="<f4", count=count, offset=p)
            self.pos = p + 4 * count
            return out.astype(np.float32)
        # text floats
        vals = np.empty(count, np.float32)
        self.pos = p
        for i in range(count):
            vals[i] = self.float()
        return vals


# ---- layer descs (plain dataclasses holding numpy weights) ---------------

@dataclasses.dataclass
class Conv:
    name: str
    ky: int
    kx: int
    in_ch: int
    out_ch: int
    kernel: np.ndarray  # HWIO


@dataclasses.dataclass
class BatchNorm:
    name: str
    channels: int
    # merged affine: y = x * scale + bias  (desc.cpp computeMerged)
    scale: np.ndarray
    bias: np.ndarray


@dataclasses.dataclass
class MatMul:
    name: str
    in_ch: int
    out_ch: int
    weight: np.ndarray  # [in, out]


@dataclasses.dataclass
class MatBias:
    name: str
    channels: int
    bias: np.ndarray


def _parse_conv(r: _Reader) -> Conv:
    name = r.token()
    ky, kx = r.int(), r.int()
    in_ch, out_ch = r.int(), r.int()
    dy, dx = r.int(), r.int()
    if dy != 1 or dx != 1:
        raise ModelParseError(f"{name}: dilation != 1 unsupported here")
    w = r.floats(ky * kx * in_ch * out_ch).reshape(ky, kx, in_ch, out_ch)
    return Conv(name, ky, kx, in_ch, out_ch, w)


def _parse_bn(r: _Reader) -> BatchNorm:
    name = r.token()
    c = r.int()
    eps = r.float()
    has_scale = r.int()
    has_bias = r.int()
    mean = r.floats(c)
    var = r.floats(c)
    scale = r.floats(c) if has_scale else np.ones(c, np.float32)
    bias = r.floats(c) if has_bias else np.zeros(c, np.float32)
    merged_scale = scale / np.sqrt(var + eps)
    merged_bias = bias - mean * merged_scale
    return BatchNorm(name, c, merged_scale.astype(np.float32),
                     merged_bias.astype(np.float32))


_ACTS = {"ACTIVATION_IDENTITY": "identity", "ACTIVATION_RELU": "relu",
         "ACTIVATION_MISH": "mish", "ACTIVATION_SILU": "silu"}


def _parse_act(r: _Reader, version: int) -> str:
    r.token()  # name
    if version >= 11:
        kind = r.token()
        if kind not in _ACTS:
            raise ModelParseError(f"unknown activation {kind}")
        return _ACTS[kind]
    return "relu"


def _parse_matmul(r: _Reader) -> MatMul:
    name = r.token()
    in_ch, out_ch = r.int(), r.int()
    w = r.floats(in_ch * out_ch).reshape(in_ch, out_ch)
    return MatMul(name, in_ch, out_ch, w)


def _parse_matbias(r: _Reader) -> MatBias:
    name = r.token()
    c = r.int()
    return MatBias(name, c, r.floats(c))


@dataclasses.dataclass
class TRMSNorm:
    """Weight-only RMSNorm inside transformer blocks (desc.cpp:1124-1143)."""
    name: str
    channels: int
    eps: float
    weight: np.ndarray


@dataclasses.dataclass
class RMSNormLayer:
    """Trunk-tip RMSNorm with gamma+beta (desc.cpp:1069-1095)."""
    name: str
    channels: int
    eps: float
    spatial: bool
    gamma: np.ndarray
    beta: np.ndarray


def _parse_trmsnorm(r: _Reader) -> TRMSNorm:
    name = r.token()
    c = r.int()
    eps = r.float()
    return TRMSNorm(name, c, eps, r.floats(c))


def _parse_rmsnorm_layer(r: _Reader) -> RMSNormLayer:
    name = r.token()
    c = r.int()
    eps = r.float()
    spatial = r.int() != 0
    cgroup = r.int()
    if cgroup != 0:
        raise ModelParseError(f"{name}: grouped spatial rmsnorm unsupported")
    gamma = r.floats(c)
    beta = r.floats(c)
    return RMSNormLayer(name, c, eps, spatial, gamma, beta)


def _parse_attention(r: _Reader) -> dict:
    """transformer_attention_block (desc.cpp:1176-1254)."""
    name = r.token()
    num_heads = r.int()
    num_kv_heads = r.int()
    q_head_dim = r.int()
    v_head_dim = r.int()
    use_rope = r.int() != 0
    learnable_rope = r.int() != 0
    if num_heads < 1 or num_kv_heads < 1 or num_heads % num_kv_heads != 0:
        raise ModelParseError(f"{name}: bad head counts")
    if use_rope and q_head_dim % 2 != 0:
        raise ModelParseError(f"{name}: qHeadDim must be even with RoPE")
    blk = {
        "kind": "attention", "name": name,
        "num_heads": num_heads, "num_kv_heads": num_kv_heads,
        "q_head_dim": q_head_dim, "v_head_dim": v_head_dim,
        "use_rope": use_rope, "learnable_rope": learnable_rope,
        "pre_ln": _parse_trmsnorm(r),
        "q_proj": _parse_matmul(r), "k_proj": _parse_matmul(r),
        "v_proj": _parse_matmul(r), "out_proj": _parse_matmul(r),
        "rope_theta": 0.0, "rope_freqs": None,
    }
    if blk["q_proj"].out_ch != num_heads * q_head_dim:
        raise ModelParseError(f"{name}: qProj shape mismatch")
    if blk["k_proj"].out_ch != num_kv_heads * q_head_dim:
        raise ModelParseError(f"{name}: kProj shape mismatch")
    if blk["v_proj"].out_ch != num_kv_heads * v_head_dim:
        raise ModelParseError(f"{name}: vProj shape mismatch")
    if use_rope:
        r.token()  # rope_freqs / rope_theta tensor name
        if learnable_rope:
            kvh = r.int()
            pairs = r.int()
            dim2 = r.int()
            if kvh != num_kv_heads or pairs != q_head_dim // 2 or dim2 != 2:
                raise ModelParseError(f"{name}: bad learnable rope header")
            blk["rope_freqs"] = r.floats(kvh * pairs * 2).reshape(
                kvh, pairs, 2)
        else:
            blk["rope_theta"] = r.float()
            if not blk["rope_theta"] > 0:
                raise ModelParseError(f"{name}: rope theta must be positive")
    return blk


def _parse_ffn(r: _Reader) -> dict:
    """transformer_ffn_block (desc.cpp:1374-1408)."""
    name = r.token()
    channels = r.int()
    ffn_channels = r.int()
    use_swiglu = r.int() != 0
    blk = {
        "kind": "ffn", "name": name, "channels": channels,
        "ffn_channels": ffn_channels, "use_swiglu": use_swiglu,
        "pre_ln": _parse_trmsnorm(r),
        "linear1": _parse_matmul(r),
        "linear_gate": _parse_matmul(r) if use_swiglu else None,
        "linear2": _parse_matmul(r),
    }
    if blk["linear1"].in_ch != channels or blk["linear1"].out_ch != ffn_channels:
        raise ModelParseError(f"{name}: linear1 shape mismatch")
    if blk["linear2"].in_ch != ffn_channels or blk["linear2"].out_ch != channels:
        raise ModelParseError(f"{name}: linear2 shape mismatch")
    return blk


def _parse_metadata_encoder(r: _Reader, version: int) -> dict:
    """SGF metadata encoder (desc.cpp:1572-1614): 192-float -> MLP -> trunk
    bias. The exporter folds the feature mask and output scale into
    mul1/mul3 (export_model_pytorch.py write_metadata_encoder)."""
    name = r.token()
    in_ch = r.int()
    if in_ch != 192:
        raise ModelParseError(f"{name}: meta encoder wants 192 in-channels")
    return {
        "name": name, "in_ch": in_ch,
        "mul1": _parse_matmul(r), "bias1": _parse_matbias(r),
        "act1": _parse_act(r, version),
        "mul2": _parse_matmul(r), "bias2": _parse_matbias(r),
        "act2": _parse_act(r, version),
        "mul3": _parse_matmul(r),
    }


def _parse_block(r: _Reader, version: int) -> dict:
    kind = r.token()
    if kind == "ordinary_block":
        return {
            "kind": "ordinary",
            "name": r.token(),
            "pre_bn": _parse_bn(r), "pre_act": _parse_act(r, version),
            "regular_conv": _parse_conv(r),
            "mid_bn": _parse_bn(r), "mid_act": _parse_act(r, version),
            "final_conv": _parse_conv(r),
        }
    if kind == "gpool_block":
        return {
            "kind": "gpool",
            "name": r.token(),
            "pre_bn": _parse_bn(r), "pre_act": _parse_act(r, version),
            "regular_conv": _parse_conv(r),
            "gpool_conv": _parse_conv(r),
            "gpool_bn": _parse_bn(r), "gpool_act": _parse_act(r, version),
            "gpool_to_bias": _parse_matmul(r),
            "mid_bn": _parse_bn(r), "mid_act": _parse_act(r, version),
            "final_conv": _parse_conv(r),
        }
    if kind == "nested_bottleneck_block":
        name = r.token()
        internal = r.int()
        pre = {"pre_bn": _parse_bn(r), "pre_act": _parse_act(r, version),
               "pre_conv": _parse_conv(r)}
        sub = [_parse_block(r, version) for _ in range(internal)]
        post = {"post_bn": _parse_bn(r), "post_act": _parse_act(r, version),
                "post_conv": _parse_conv(r)}
        return {"kind": "nested", "name": name, "internal": internal,
                **pre, "sub_blocks": sub, **post}
    if kind == "transformer_attention_block":
        return _parse_attention(r)
    if kind == "transformer_ffn_block":
        return _parse_ffn(r)
    raise ModelParseError(f"unsupported block kind {kind!r}")


@dataclasses.dataclass
class ModelDesc:
    name: str
    version: int
    num_spatial_inputs: int
    num_global_inputs: int
    sha256: str
    post_process: dict
    trunk: dict
    policy_head: dict
    value_head: dict
    meta_encoder_version: int = 0
    prefer_pass_alive: bool = False

    @property
    def num_policy_channels(self) -> int:
        return self.policy_head["p2_conv"].out_ch

    @property
    def input_version(self) -> int:
        """Input-feature version for this model (modelversion.cpp:35-48)."""
        v = self.version
        if v >= 8:
            return 7
        return {3: 3, 4: 3, 5: 4, 6: 5, 7: 6}[v]


def load_model(path: str) -> ModelDesc:
    """Parse a reference-format model file (.bin.gz / .txt.gz / raw)."""
    raw = open(path, "rb").read()
    sha256 = hashlib.sha256(raw).hexdigest()
    if raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    r = _Reader(raw)

    name = r.token()
    version = r.int()
    if not (3 <= version <= 17):
        raise ModelParseError(f"model version {version} unsupported (want 3..17)")
    num_spatial = r.int()
    num_global = r.int()

    pp = {"td_score_mult": 20.0, "scoremean_mult": 20.0,
          "scorestdev_mult": 20.0, "lead_mult": 20.0,
          "variance_time_mult": 40.0, "shortterm_value_error_mult": 0.25,
          "shortterm_score_error_mult": 30.0}
    if version >= 13:
        for k in list(pp):
            pp[k] = r.float()
    meta_version = 0
    prefer_pass_alive = False
    if version >= 15:
        meta_version = r.int()
        if meta_version not in (0, 1):
            raise ModelParseError(
                f"metadata encoder version {meta_version} unsupported")
        prefer_pass_alive = r.int() != 0
        for _ in range(6):  # reserved
            if r.int() != 0:
                raise ModelParseError("unsupported reserved model option")

    # ---- trunk ----
    tname = r.token()
    if tname != "trunk":
        raise ModelParseError(f"expected 'trunk', got {tname!r}")
    num_blocks = r.int()
    trunk_ch = r.int()
    mid_ch = r.int()
    regular_ch = r.int()
    _dilated_ch = r.int()
    gpool_ch = r.int()
    trunk_norm_kind = 0
    if version >= 15:
        trunk_norm_kind = r.int()
        if trunk_norm_kind not in (0, 1):
            raise ModelParseError(
                f"trunk norm kind {trunk_norm_kind} unsupported")
        for _ in range(5):
            if r.int() != 0:
                raise ModelParseError("unsupported trunk option")
    initial_conv = _parse_conv(r)
    initial_matmul = _parse_matmul(r)
    meta_encoder = None
    if meta_version > 0:
        meta_encoder = _parse_metadata_encoder(r, version)
        if meta_encoder["mul3"].out_ch != trunk_ch:
            raise ModelParseError("meta encoder output != trunk channels")
    blocks = [_parse_block(r, version) for _ in range(num_blocks)]
    if trunk_norm_kind == 0:
        trunk_final_bn = _parse_bn(r)
        trunk_final_rms = None
    else:
        trunk_final_bn = None
        trunk_final_rms = _parse_rmsnorm_layer(r)
    trunk_final_act = _parse_act(r, version)
    trunk = {
        "num_blocks": num_blocks, "trunk_ch": trunk_ch, "mid_ch": mid_ch,
        "regular_ch": regular_ch, "gpool_ch": gpool_ch,
        "initial_conv": initial_conv, "initial_matmul": initial_matmul,
        "meta_encoder": meta_encoder,
        "blocks": blocks, "final_bn": trunk_final_bn,
        "final_rms": trunk_final_rms,
        "final_act": trunk_final_act,
    }

    # ---- policy head ----
    ph: dict = {"name": r.token()}
    if version >= 17:
        pol_out = r.int()
        if pol_out not in (2, 4):
            raise ModelParseError(f"bad policyOutChannels {pol_out}")
        ph["policy_out_channels"] = pol_out
        for _ in range(3):
            if r.int() != 0:
                raise ModelParseError("unsupported policy head option")
    ph["p1_conv"] = _parse_conv(r)
    ph["g1_conv"] = _parse_conv(r)
    ph["g1_bn"] = _parse_bn(r)
    ph["g1_act"] = _parse_act(r, version)
    ph["gpool_to_bias"] = _parse_matmul(r)
    ph["p1_bn"] = _parse_bn(r)
    ph["p1_act"] = _parse_act(r, version)
    ph["p2_conv"] = _parse_conv(r)
    ph["gpool_to_pass"] = _parse_matmul(r)
    if version >= 15:
        ph["pass_bias"] = _parse_matbias(r)
        ph["pass_act"] = _parse_act(r, version)
        ph["gpool_to_pass2"] = _parse_matmul(r)

    # ---- value head ----
    vh: dict = {"name": r.token()}
    if version >= 17:
        for _ in range(3):
            if r.int() != 0:
                raise ModelParseError("unsupported value head option")
    vh["v1_conv"] = _parse_conv(r)
    vh["v1_bn"] = _parse_bn(r)
    vh["v1_act"] = _parse_act(r, version)
    vh["v2_mul"] = _parse_matmul(r)
    vh["v2_bias"] = _parse_matbias(r)
    vh["v2_act"] = _parse_act(r, version)
    vh["v3_mul"] = _parse_matmul(r)
    vh["v3_bias"] = _parse_matbias(r)
    vh["sv3_mul"] = _parse_matmul(r)
    vh["sv3_bias"] = _parse_matbias(r)
    vh["ownership_conv"] = _parse_conv(r)

    return ModelDesc(name=name, version=version,
                     num_spatial_inputs=num_spatial,
                     num_global_inputs=num_global, sha256=sha256,
                     post_process=pp, trunk=trunk, policy_head=ph,
                     value_head=vh, meta_encoder_version=meta_version,
                     prefer_pass_alive=prefer_pass_alive)


# ---- PyTorch forward over a parsed desc ----------------------------------

_ACT_FNS = {"relu": F.relu, "silu": F.silu, "identity": lambda x: x,
            "mish": lambda x: x * torch.tanh(F.softplus(x))}

# float32_precision flips process-wide backend flags; forwards on several
# threads (a ponder search beside a GTP command) take turns inside it
_PRECISION_LOCK = threading.Lock()


class DescNet(nn.Module):
    """A parsed reference net (ModelDesc) as a float32 nn.Module.

    forward(spatial [B,H,W,C] NHWC, global [B,G], mask=None [B,H,W,1],
    metadata=None [B,192]) -> the raw-output dict of the JAX package's
    apply_desc_model: policy logits [B, Cpol, H*W+1], value logits
    [B, 3], miscvalue [B, 10] and moremiscvalue [B, 8] in the v14-native
    conventions, ownership [B, H, W], zero placeholders for the heads a
    desc net lacks, and supports_shortterm_error False for versions
    below 9. metadata conditions a humanSL net's metadata encoder (zeros
    when None); other nets ignore it."""

    def __init__(self, desc: ModelDesc):
        super().__init__()
        self.desc = desc
        self.version = desc.version
        self._n = 0
        self._rope_cache: dict = {}
        t = desc.trunk
        self.initial_conv = self._conv(t["initial_conv"])
        self.initial_matmul = self._mat(t["initial_matmul"])
        me = t.get("meta_encoder")
        self.meta = None if me is None else {
            k: self._layer(v) for k, v in me.items()
            if k not in ("name", "in_ch")}
        self.blocks = [self._block(b) for b in t["blocks"]]
        self.final_bn = self.final_rms = None
        if t.get("final_rms") is not None:
            fr = t["final_rms"]
            self.final_rms = (self._buf(fr.gamma), self._buf(fr.beta),
                              fr.eps, fr.spatial)
        else:
            self.final_bn = self._bn(t["final_bn"])
        self.final_act = t["final_act"]
        ph, vh = desc.policy_head, desc.value_head
        self.ph = {k: self._layer(v) for k, v in ph.items() if k != "name"}
        self.vh = {k: self._layer(v) for k, v in vh.items() if k != "name"}

    # -- weights, converted once and registered as buffers -----------------

    def _buf(self, a: np.ndarray) -> str:
        name = f"w{self._n}"
        self._n += 1
        self.register_buffer(name, torch.from_numpy(
            np.ascontiguousarray(a, dtype=np.float32)))
        return name

    def _conv(self, c: Conv) -> tuple:
        return ("conv", self._buf(c.kernel.transpose(3, 2, 0, 1)), c.ky, c.kx)

    def _bn(self, bn: BatchNorm) -> tuple:
        return ("bn", self._buf(bn.scale), self._buf(bn.bias))

    def _mat(self, m: MatMul) -> tuple:
        return ("mat", self._buf(m.weight.T))

    def _layer(self, v):
        if isinstance(v, Conv):
            return self._conv(v)
        if isinstance(v, BatchNorm):
            return self._bn(v)
        if isinstance(v, MatMul):
            return self._mat(v)
        if isinstance(v, MatBias):
            return ("bias", self._buf(v.bias))
        if isinstance(v, TRMSNorm):
            return ("trms", self._buf(v.weight), v.eps)
        return v            # activation names and header ints

    def _block(self, blk: dict) -> dict:
        if blk["kind"] in ("attention", "ffn"):
            out = {k: self._layer(v) for k, v in blk.items()
                   if k != "rope_freqs"}
            out["rope_freqs"] = blk.get("rope_freqs")   # numpy, host side
            return out
        out = {}
        for k, v in blk.items():
            if k == "sub_blocks":
                out[k] = [self._block(s) for s in v]
            elif k in ("kind", "name", "internal"):
                out[k] = v
            else:
                out[k] = self._layer(v)
        return out

    # -- ops ----------------------------------------------------------------

    def _w(self, name: str) -> torch.Tensor:
        return getattr(self, name)

    def _apply_conv(self, x, c):
        _, w, ky, kx = c
        py, px = (ky - 1) // 2, (kx - 1) // 2
        if ky % 2 == 0 or kx % 2 == 0:    # "SAME": the extra pad goes after
            x = F.pad(x, (px, kx - 1 - px, py, ky - 1 - py))
            return F.conv2d(x, self._w(w))
        return F.conv2d(x, self._w(w), padding=(py, px))

    def _apply_bn(self, x, bn, mask):
        _, s, b = bn
        return (x * self._w(s)[:, None, None] + self._w(b)[:, None, None]) \
            * mask

    def _apply_mat(self, x, m):
        return F.linear(x, self._w(m[1]))

    @staticmethod
    def _gpool(x, mask, mask_sum_hw):
        sqrt_off = torch.sqrt(mask_sum_hw) - 14.0
        mean = x.sum(dim=(2, 3), keepdim=True) / mask_sum_hw
        mx = torch.amax(x + (mask - 1.0) * 5000.0, dim=(2, 3), keepdim=True)
        return torch.cat([mean, mean * (sqrt_off / 10.0), mx],
                         dim=1)[:, :, 0, 0]

    @staticmethod
    def _vgpool(x, mask_sum_hw):
        sqrt_off = torch.sqrt(mask_sum_hw) - 14.0
        mean = x.sum(dim=(2, 3), keepdim=True) / mask_sum_hw
        return torch.cat([mean, mean * (sqrt_off / 10.0),
                          mean * (sqrt_off * sqrt_off / 100.0 - 0.1)],
                         dim=1)[:, :, 0, 0]

    def _trms(self, x, n):
        """Weight-only RMSNorm over the last axis (eigenbackend.cpp:866-918)."""
        _, wname, eps = n
        ms = torch.mean(x * x, dim=-1, keepdim=True)
        return x * torch.rsqrt(ms + eps) * self._w(wname)

    def _rope(self, blk, h, w, device):
        """cos/sin [S, num_kv_heads or 1, D] of computeRopeCosSin
        (desc.cpp:1301-1363): fixed RoPE is the model's interleaved 2-D
        table; learnable RoPE is x * freq_x + y * freq_y per KV head."""
        key = (blk["name"], h, w, str(device))
        if key in self._rope_cache:
            return self._rope_cache[key]
        if blk["learnable_rope"]:
            ys, xs = np.meshgrid(np.arange(h, dtype=np.float32),
                                 np.arange(w, dtype=np.float32),
                                 indexing="ij")
            fr = np.asarray(blk["rope_freqs"], np.float32)
            ang = np.repeat(xs.reshape(-1, 1, 1) * fr[None, :, :, 0]
                            + ys.reshape(-1, 1, 1) * fr[None, :, :, 1],
                            2, axis=-1)
            cos, sin = np.cos(ang), np.sin(ang)
        else:
            cos, sin = rope_cos_sin_2d(blk["q_head_dim"], h,
                                       blk["rope_theta"], w)
            cos, sin = cos[:, None, :], sin[:, None, :]
        out = (torch.from_numpy(np.ascontiguousarray(cos)).to(device),
               torch.from_numpy(np.ascontiguousarray(sin)).to(device))
        self._rope_cache[key] = out
        return out

    def _apply_attention(self, x, blk, mask):
        """GQA attention over board positions (eigenbackend.cpp:1374-1612)."""
        b, c, h, w = x.shape
        s = h * w
        nh, nkv = blk["num_heads"], blk["num_kv_heads"]
        qd, vd = blk["q_head_dim"], blk["v_head_dim"]
        xs = self._trms(x.flatten(2).transpose(1, 2), blk["pre_ln"])
        q = self._apply_mat(xs, blk["q_proj"]).reshape(b, s, nh, qd)
        k = self._apply_mat(xs, blk["k_proj"]).reshape(b, s, nkv, qd)
        v = self._apply_mat(xs, blk["v_proj"]).reshape(b, s, nkv, vd)
        if blk["use_rope"]:
            cos, sin = self._rope(blk, h, w, x.device)     # [S, kv|1, D]
            qcos, qsin, kcos, ksin = cos, sin, cos, sin
            if blk["learnable_rope"]:
                # q heads take their kv head's table (eigenbackend.cpp:1444)
                qcos = cos.repeat_interleave(nh // nkv, dim=1)
                qsin = sin.repeat_interleave(nh // nkv, dim=1)
            q = q * qcos + rotate_every_two(q) * qsin
            k = k * kcos + rotate_every_two(k) * ksin
        if nh != nkv:
            k = k.repeat_interleave(nh // nkv, dim=2)
            v = v.repeat_interleave(nh // nkv, dim=2)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / float(np.sqrt(qd))
        logits = torch.where(mask.reshape(b, 1, 1, s) > 0, logits, -1e30)
        att = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(b, s, nh * vd)
        out = self._apply_mat(out, blk["out_proj"])
        return x + out.transpose(1, 2).reshape(b, c, h, w) * mask

    def _apply_ffn(self, x, blk, mask):
        """SwiGLU / plain FFN (eigenbackend.cpp:1643-1720): silu applies
        to linear1's output, times the gate projection; plain is relu."""
        xs = self._trms(x.permute(0, 2, 3, 1), blk["pre_ln"])
        y = self._apply_mat(xs, blk["linear1"])
        if blk["use_swiglu"]:
            y = F.silu(y) * self._apply_mat(xs, blk["linear_gate"])
        else:
            y = F.relu(y)
        y = self._apply_mat(y, blk["linear2"])
        return x + y.permute(0, 3, 1, 2) * mask

    def _apply_block(self, x, blk, mask, mask_sum_hw):
        if blk["kind"] == "attention":
            return self._apply_attention(x, blk, mask)
        if blk["kind"] == "ffn":
            return self._apply_ffn(x, blk, mask)
        act = lambda name, v: _ACT_FNS[name](v)  # noqa: E731
        bn = lambda v, k: self._apply_bn(v, blk[k], mask)  # noqa: E731
        conv = lambda v, k: self._apply_conv(v, blk[k])  # noqa: E731
        if blk["kind"] == "ordinary":
            out = act(blk["pre_act"], bn(x, "pre_bn"))
            out = conv(out, "regular_conv")
            out = act(blk["mid_act"], bn(out, "mid_bn"))
            return x + conv(out, "final_conv")
        if blk["kind"] == "gpool":
            out = act(blk["pre_act"], bn(x, "pre_bn"))
            outr = conv(out, "regular_conv")
            outg = act(blk["gpool_act"], bn(conv(out, "gpool_conv"),
                                             "gpool_bn"))
            pooled = self._gpool(outg, mask, mask_sum_hw)
            outr = outr + self._apply_mat(
                pooled, blk["gpool_to_bias"])[:, :, None, None]
            outr = act(blk["mid_act"], bn(outr, "mid_bn"))
            return x + conv(outr, "final_conv")
        if blk["kind"] == "nested":
            out = act(blk["pre_act"], bn(x, "pre_bn"))
            out = conv(out, "pre_conv")
            for sub in blk["sub_blocks"]:
                out = self._apply_block(out, sub, mask, mask_sum_hw)
            out = act(blk["post_act"], bn(out, "post_bn"))
            return x + conv(out, "post_conv")
        raise ValueError(blk["kind"])

    def _value_channels(self, sv, mask_sum_hw):
        """_normalize_value_channels of the JAX package: a version's sv3
        outputs as the v14-native raw channels (see its docstring)."""
        b = sv.shape[0]
        v = self.version
        pp = self.desc.post_process
        zero = torch.zeros((b,), dtype=sv.dtype, device=sv.device)
        neg = torch.full((b,), -1e4, dtype=sv.dtype, device=sv.device)

        def inv_softplus(t):
            t = torch.clamp(t, min=1e-6)
            return t + torch.log1p(-torch.exp(-t))

        def rebase_softplus(x, mult, default):
            if mult == default:
                return x
            return inv_softplus(F.softplus(x) * (mult / default))

        if v == 3:
            sqrt_area = torch.sqrt(mask_sum_hw[:, 0, 0, 0])
            mean_raw = sv[:, 0] * 2.0 * sqrt_area / 20.0
            return [mean_raw, neg, mean_raw, neg], [zero, zero]
        if v <= 7:
            return [sv[:, 0], sv[:, 1], sv[:, 0], neg], [zero, zero]
        mv = [sv[:, 0] * (pp["scoremean_mult"] / 20.0),
              rebase_softplus(sv[:, 1], pp["scorestdev_mult"], 20.0),
              sv[:, 2] * (pp["lead_mult"] / 20.0),
              rebase_softplus(sv[:, 3], pp["variance_time_mult"], 40.0)]
        if v == 8:
            return mv, [zero, zero]
        wl_mult = pp["shortterm_value_error_mult"]
        sc_mult = pp["shortterm_score_error_mult"]
        if v >= 14:
            if wl_mult == 0.25 and sc_mult == 30.0:
                return mv, [sv[:, 4], sv[:, 5]]
            err_wl = F.softplus(sv[:, 4] * 0.5) * float(np.sqrt(wl_mult))
            err_sc = F.softplus(sv[:, 5] * 0.5) * float(np.sqrt(sc_mult))
        elif v >= 10:
            err_wl = torch.sqrt(F.softplus(sv[:, 4]) * wl_mult)
            err_sc = torch.sqrt(F.softplus(sv[:, 5]) * sc_mult)
        else:  # v9: engine-side plain softplus, score error x10
            err_wl = F.softplus(sv[:, 4])
            err_sc = F.softplus(sv[:, 5]) * 10.0
        return mv, [2.0 * inv_softplus(err_wl * 2.0),
                    2.0 * inv_softplus(err_sc / float(np.sqrt(30.0)))]

    # -- forward ------------------------------------------------------------

    def forward(self, spatial, global_in, mask=None, metadata=None):
        from katago_torch.train.train_step import float32_precision
        with _PRECISION_LOCK, float32_precision():
            return self._forward(spatial, global_in, mask, metadata)

    def _forward(self, spatial, global_in, mask, metadata):
        b, h, w, _ = spatial.shape
        x_in = spatial.float().permute(0, 3, 1, 2)
        if mask is None:
            mask = torch.ones((b, 1, h, w), dtype=torch.float32,
                              device=spatial.device)
        else:
            mask = mask.float().permute(0, 3, 1, 2)
        mask_sum_hw = mask.sum(dim=(2, 3), keepdim=True)

        x = self._apply_conv(x_in, self.initial_conv)
        x = x + self._apply_mat(global_in.float(),
                                self.initial_matmul)[:, :, None, None]
        if self.meta is not None:
            me = self.meta
            if metadata is None:
                metadata = torch.zeros((b, 192), dtype=torch.float32,
                                       device=spatial.device)
            m = self._apply_mat(metadata.float(), me["mul1"]) + \
                self._w(me["bias1"][1])
            m = _ACT_FNS[me["act1"]](m)
            m = self._apply_mat(m, me["mul2"]) + self._w(me["bias2"][1])
            m = _ACT_FNS[me["act2"]](m)
            x = x + self._apply_mat(m, me["mul3"])[:, :, None, None]
        for blk in self.blocks:
            x = self._apply_block(x, blk, mask, mask_sum_hw)
        if self.final_rms is not None:
            gamma, beta, eps, spatial_rms = self.final_rms
            if spatial_rms:
                # RMS over every on-board position and channel of a board
                ssum = torch.sum(x * x * mask, dim=(1, 2, 3), keepdim=True)
                rms = torch.rsqrt(ssum / (mask_sum_hw * x.shape[1]) + eps)
            else:
                rms = torch.rsqrt(torch.mean(x * x, dim=1, keepdim=True)
                                  + eps)
            x = (x * rms * self._w(gamma)[:, None, None]
                 + self._w(beta)[:, None, None]) * mask
        else:
            x = self._apply_bn(x, self.final_bn, mask)
        x = _ACT_FNS[self.final_act](x)

        ph = self.ph
        p1 = self._apply_conv(x, ph["p1_conv"])
        g1 = self._apply_conv(x, ph["g1_conv"])
        g1 = _ACT_FNS[ph["g1_act"]](self._apply_bn(g1, ph["g1_bn"], mask))
        pooled = self._gpool(g1, mask, mask_sum_hw)
        p1 = p1 + self._apply_mat(pooled,
                                  ph["gpool_to_bias"])[:, :, None, None]
        p1 = _ACT_FNS[ph["p1_act"]](self._apply_bn(p1, ph["p1_bn"], mask))
        p2 = self._apply_conv(p1, ph["p2_conv"])          # [B, Cpol, H, W]
        p2 = p2 - (1.0 - mask) * 5000.0
        outpass = self._apply_mat(pooled, ph["gpool_to_pass"])
        if self.version >= 15:
            outpass = outpass + self._w(ph["pass_bias"][1])
            outpass = _ACT_FNS[ph["pass_act"]](outpass)
            outpass = self._apply_mat(outpass, ph["gpool_to_pass2"])
        policy = torch.cat([p2.reshape(b, p2.shape[1], h * w),
                            outpass[:, :, None]], dim=2)

        vh = self.vh
        v1 = self._apply_conv(x, vh["v1_conv"])
        v1 = _ACT_FNS[vh["v1_act"]](self._apply_bn(v1, vh["v1_bn"], mask))
        vpooled = self._vgpool(v1, mask_sum_hw)
        v2 = self._apply_mat(vpooled, vh["v2_mul"]) + \
            self._w(vh["v2_bias"][1])
        v2 = _ACT_FNS[vh["v2_act"]](v2)
        value = self._apply_mat(v2, vh["v3_mul"]) + self._w(vh["v3_bias"][1])
        sv = self._apply_mat(v2, vh["sv3_mul"]) + self._w(vh["sv3_bias"][1])
        own = self._apply_conv(v1, vh["ownership_conv"]) * mask

        mv, mmv = self._value_channels(sv, mask_sum_hw)
        zeros6 = torch.zeros((b, 6), dtype=sv.dtype, device=sv.device)
        own = own[:, 0]
        out = {} if self.version >= 9 else {"supports_shortterm_error": False}
        out.update({
            "policy_logits": policy,
            "value_logits": value,
            "miscvalue": torch.cat([torch.stack(mv, dim=-1), zeros6], -1),
            "moremiscvalue": torch.cat([torch.stack(mmv, dim=-1), zeros6],
                                       -1),
            "ownership_pretanh": own,
            "scoring_presoftmax": torch.zeros_like(own),
            "futurepos_pretanh": own.new_zeros((b, h, w, 2)),
            "seki_logits": own.new_zeros((b, h, w, 4)),
            "scorebelief_logprobs": own.new_zeros((b, 2)),
        })
        return out


def load_net(path: str, device) -> DescNet:
    """Parse a reference model file and build its DescNet on `device`."""
    return DescNet(load_model(path)).to(device).eval()
