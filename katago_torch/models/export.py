"""Export the port's net to the reference .bin.gz weight format — the
port's own copy of katago_tpu/models/export.py.

The reference's python/export_model_pytorch.py:206-394 writes the engine
format consumed by desc.cpp; this writes the same text+@BIN@ layout:
versions 8..15 conv-trunk models (initial conv/matmul, ordinary / gpool /
nested-bottleneck blocks — bottle1-3 and bottlenest2 — policy head with
the v15 pass-MLP, value head v3/sv3/ownership outputs) and version 17
transformer models (transformer_attention_block / transformer_ffn_block
with fixed 2-D RoPE and SwiGLU, export_model_pytorch.py:394-454) plus the
v15+ SGF-metadata encoder (write_metadata_encoder,
export_model_pytorch.py:493-505). Fixup NormMask layers are written as
merged batchnorms (mean 0, var 1, scale gamma, bias beta — the same
merged-affine form desc.cpp computes from real BN stats).

Input: the Flax params tree in numpy (models/weights.py::to_flax_params
of the port's state_dict), so the bytes equal the JAX exporter's on the
same weights. It refuses what the JAX exporter refuses, with the same
messages: QK-norm attention (the reference exporter rejects it too), a
non-SwiGLU FFN under another activation than relu, and block kinds the
format has no entry for (the nested-bottleneck transformer hybrids).

Policy outputs follow the reference channel selection: of the model's 6 or
8 policy channels only (policy, short-term-optimistic[, q-winloss,
q-score]) = rows (0, 5[, 6, 7]) are written (write_policy_head). The sv3
matmul carries (scoremean, scorestdev, lead, vtime) from miscvalue plus
the two shortterm errors from moremiscvalue (write_value_head).

Not representable in this format (dropped, zero-filled by the loader):
the remaining miscvalue/moremiscvalue td channels, scoring/futurepos/seki
convs, the scorebelief mixture head and intermediate heads.
"""

from __future__ import annotations

import gzip
import io

import numpy as np

from katago_torch.models.config import ModelConfig

_ACT_TOKENS = {"identity": "ACTIVATION_IDENTITY", "relu": "ACTIVATION_RELU",
               "mish": "ACTIVATION_MISH", "silu": "ACTIVATION_SILU"}


class _Writer:
    def __init__(self):
        self.buf = io.BytesIO()

    def tok(self, *vals):
        for v in vals:
            self.buf.write(str(v).encode("ascii"))
            self.buf.write(b"\n")

    def bin(self, arr: np.ndarray):
        self.buf.write(b"@BIN@")
        self.buf.write(np.ascontiguousarray(arr, dtype="<f4").tobytes())
        self.buf.write(b"\n")

    def conv(self, name, kernel):
        ky, kx, cin, cout = kernel.shape
        self.tok(name, ky, kx, cin, cout, 1, 1)
        self.bin(kernel)

    def bn_from_norm(self, name, channels, beta, gamma=None):
        self.tok(name, channels, 1e-20, 1, 1)
        self.bin(np.zeros(channels, np.float32))   # mean
        self.bin(np.ones(channels, np.float32))    # var
        self.bin(np.ones(channels, np.float32) if gamma is None
                 else np.asarray(gamma, np.float32))
        self.bin(np.asarray(beta, np.float32))

    def act(self, activation):
        self.tok("act", _ACT_TOKENS[activation])

    def matmul(self, name, w):
        cin, cout = w.shape
        self.tok(name, cin, cout)
        self.bin(w)

    def matbias(self, name, b):
        self.tok(name, b.shape[0])
        self.bin(b)


def _np(p):
    return np.asarray(p, np.float32)


def export_model(params, cfg: ModelConfig, path: str,
                 name: str | None = None) -> str:
    """Write params (a Flax params tree in numpy, e.g. to_flax_params of
    the port's state_dict) to the reference engine format at `path`
    (gzip if it ends with .gz)."""
    p = params["params"] if "params" in params else params
    w = _Writer()
    actn = cfg.activation
    blocks = list(cfg.block_kind)
    has_transformer = any(k.startswith(("attn", "ffn")) for k in blocks)
    version = 17 if (has_transformer or cfg.version >= 16) else 15
    if cfg.attention_qk_norm and has_transformer:
        raise ValueError("QK-norm attention is not exportable "
                         "(matches the reference exporter's restriction)")
    w.tok(name or cfg.name)
    w.tok(version)
    w.tok(22, 19)
    # postprocess multipliers, reader order (desc.py load_model)
    for v in (20.0, 20.0, 20.0, 20.0, 40.0, 0.25, 30.0):
        w.tok(v)
    w.tok(1 if cfg.metadata_encoder else 0)  # metadata encoder version
    for _ in range(7):
        w.tok(0)

    w.tok("trunk", len(blocks), cfg.trunk_num_channels, cfg.mid_num_channels,
          cfg.mid_num_channels, 0, cfg.gpool_num_channels)
    w.tok(0)                       # trunk norm kind (bnorm-merged)
    for _ in range(5):
        w.tok(0)

    w.conv("initconv", _np(p["Conv_0"]["Conv_0"]["kernel"]))
    w.matmul("initmatmul", _np(p["Dense_0"]["kernel"]))

    if cfg.metadata_encoder:
        me = p["MetadataEncoder_0"]
        w.tok("metaencoder", 192)
        # fold the channel-86 feature mask into mul1 and the 0.5 output
        # scale into mul3 (export_model_pytorch.py write_metadata_encoder)
        mul1 = _np(me["Dense_0"]["kernel"]).copy()
        mul1[86, :] = 0.0
        w.matmul("metamul1", mul1)
        w.matbias("metabias1", _np(me["Dense_0"]["bias"]))
        w.act(actn)
        w.matmul("metamul2", _np(me["Dense_1"]["kernel"]))
        w.matbias("metabias2", _np(me["Dense_1"]["bias"]))
        w.act(actn)
        w.matmul("metamul3", 0.5 * _np(me["Dense_2"]["kernel"]))

    res_i = 0
    nest_i = 0
    attn_i = 0
    ffn_i = 0

    def write_trms(label, np_weight, eps=1e-6):
        """Weight-only transformer RMSNorm (write_transformer_norm)."""
        w.tok(label, np_weight.shape[0], eps)
        w.bin(np_weight)

    def write_attention(bp, label, use_rope):
        c = cfg.trunk_num_channels
        nh = cfg.transformer_heads
        nkv = cfg.transformer_kv_heads or nh
        qd = c // nh
        w.tok("transformer_attention_block", label, nh, nkv, qd, qd,
              1 if use_rope else 0, 0)
        write_trms(f"{label}.norm", _np(bp["RMSNorm_0"]["scale"]))
        w.matmul(f"{label}.q", _np(bp["q_proj"]["kernel"]))
        w.matmul(f"{label}.k", _np(bp["k_proj"]["kernel"]))
        w.matmul(f"{label}.v", _np(bp["v_proj"]["kernel"]))
        w.matmul(f"{label}.out", _np(bp["out_proj"]["kernel"]))
        if use_rope:
            w.tok(f"{label}.rope_theta", cfg.rope_theta)

    def write_ffn(bp, label, use_swiglu):
        if not use_swiglu and actn != "relu":
            # the engine format carries no FFN activation token; non-SwiGLU
            # implies relu (desc.cpp:1368-1408; the reference's CUDA/Eigen
            # backends reject non-SwiGLU outright)
            raise ValueError(
                f"non-SwiGLU FFN with activation {actn!r} is not exportable")
        w.tok("transformer_ffn_block", label, cfg.trunk_num_channels,
              cfg.transformer_ffn_channels, 1 if use_swiglu else 0)
        write_trms(f"{label}.norm", _np(bp["RMSNorm_0"]["scale"]))
        w.matmul(f"{label}.l1", _np(bp["ffn_linear1"]["kernel"]))
        if use_swiglu:
            w.matmul(f"{label}.lg", _np(bp["ffn_linear_gate"]["kernel"]))
        w.matmul(f"{label}.l2", _np(bp["ffn_linear2"]["kernel"]))

    def write_res_block(bp, label, has_gpool):
        """One flax ResBlock params subtree as ordinary/gpool block."""
        pre = bp["NormActConv_0"]
        mid = bp["NormActConv_1"]
        if has_gpool:
            w.tok("gpool_block", label)
            cg = pre["ConvAndGPool_0"]
            c_pre = _np(cg["Conv_0"]["Conv_0"]["kernel"])
            w.bn_from_norm("prebn", c_pre.shape[2],
                           _np(pre["NormMask_0"]["beta"]))
            w.act(actn)
            w.conv("regularconv", c_pre)
            w.conv("gpoolconv", _np(cg["Conv_1"]["Conv_0"]["kernel"]))
            gch = _np(cg["NormMask_0"]["beta"]).shape[0]
            w.bn_from_norm("gpoolbn", gch, _np(cg["NormMask_0"]["beta"]))
            w.act(actn)
            w.matmul("gpooltobias", _np(cg["Dense_0"]["kernel"]))
        else:
            w.tok("ordinary_block", label)
            c_pre = _np(pre["Conv_0"]["Conv_0"]["kernel"])
            w.bn_from_norm("prebn", c_pre.shape[2],
                           _np(pre["NormMask_0"]["beta"]))
            w.act(actn)
            w.conv("regularconv", c_pre)
        c_fin = _np(mid["Conv_0"]["Conv_0"]["kernel"])
        w.bn_from_norm("midbn", c_fin.shape[2],
                       _np(mid["NormMask_0"]["beta"]),
                       _np(mid["NormMask_0"]["gamma"]))
        w.act(actn)
        w.conv("finalconv", c_fin)

    for kind in blocks:
        if kind.startswith("attn"):
            bp = p[f"TransformerAttentionBlock_{attn_i}"]
            attn_i += 1
            write_attention(bp, f"attn{attn_i}", use_rope=(kind == "attnrope"))
            continue
        if kind.startswith("ffn"):
            bp = p[f"TransformerFFNBlock_{ffn_i}"]
            ffn_i += 1
            write_ffn(bp, f"ffn{ffn_i}", use_swiglu=(kind == "ffnsg"))
            continue
        use_gpool = kind.endswith("gpool")
        base = kind[:-5] if use_gpool else kind
        if base == "regular":
            bp = p[f"ResBlock_{res_i}"]
            res_i += 1
            write_res_block(bp, f"block{res_i}", use_gpool)
        elif base in ("bottle1", "bottle2", "bottle3", "bottlenest2"):
            il = 2 if base == "bottlenest2" else int(base[-1])
            bp = p[f"NestedBottleneckResBlock_{nest_i}"]
            nest_i += 1
            w.tok("nested_bottleneck_block", f"nest{nest_i}", il)
            pre = bp["NormActConv_0"]
            c_pre = _np(pre["Conv_0"]["Conv_0"]["kernel"])
            w.bn_from_norm("prebn", c_pre.shape[2],
                           _np(pre["NormMask_0"]["beta"]))
            w.act(actn)
            w.conv("preconv", c_pre)
            for i in range(il):
                write_res_block(bp[f"ResBlock_{i}"], f"nest{nest_i}sub{i}",
                                use_gpool and i == 0)
            post = bp["NormActConv_1"]
            c_post = _np(post["Conv_0"]["Conv_0"]["kernel"])
            w.bn_from_norm("postbn", c_post.shape[2],
                           _np(post["NormMask_0"]["beta"]),
                           _np(post["NormMask_0"]["gamma"]))
            w.act(actn)
            w.conv("postconv", c_post)
        else:
            raise ValueError(f"unsupported block kind {kind!r}")

    w.bn_from_norm("trunkfinalbn", cfg.trunk_num_channels,
                   _np(p["NormMask_0"]["beta"]),
                   _np(p["NormMask_0"]["gamma"]))
    w.act(actn)

    # ---- policy head ----
    # Of the model's 6 or 8 policy channels, the engine format carries only
    # (policy, short-term-optimistic[, q-winloss, q-score]) = columns
    # (0, 5[, 6, 7]) (export_model_pytorch.py:557-621 write_policy_head).
    n_pol = cfg.num_policy_outputs
    pol_cols = [0, 5] if n_pol == 6 else [0, 5, 6, 7]
    ph = p["PolicyHead_0"]
    w.tok("policyhead")
    if version >= 17:
        w.tok(len(pol_cols), 0, 0, 0)  # out channels + reserved
    w.conv("p1conv", _np(ph["Conv_0"]["Conv_0"]["kernel"]))
    w.conv("g1conv", _np(ph["Conv_1"]["Conv_0"]["kernel"]))
    w.bn_from_norm("g1bn", cfg.g1_num_channels,
                   _np(ph["NormMask_0"]["beta"]))
    w.act(actn)
    w.matmul("gpooltobias", _np(ph["Dense_2"]["kernel"]))
    w.bn_from_norm("p1bn", cfg.p1_num_channels,
                   _np(ph["NormMask_1"]["beta"]))
    w.act(actn)
    w.conv("p2conv", _np(ph["Conv_2"]["Conv_0"]["kernel"])[..., pol_cols])
    w.matmul("gpooltopass", _np(ph["Dense_0"]["kernel"]))
    w.matbias("passbias", _np(ph["Dense_0"]["bias"]))
    w.act(actn)
    w.matmul("gpooltopass2", _np(ph["Dense_1"]["kernel"])[:, pol_cols])

    # ---- value head ----
    vh = p["ValueHead_0"]
    w.tok("valuehead")
    if version >= 17:
        w.tok(0, 0, 0)  # reserved
    w.conv("v1conv", _np(vh["Conv_0"]["Conv_0"]["kernel"]))
    w.bn_from_norm("v1bn", cfg.v1_num_channels,
                   _np(vh["NormMask_0"]["beta"]))
    w.act(actn)
    w.matmul("v2mul", _np(vh["Dense_0"]["kernel"]))
    w.matbias("v2bias", _np(vh["Dense_0"]["bias"]))
    w.act(actn)
    w.matmul("v3mul", _np(vh["Dense_1"]["kernel"]))
    w.matbias("v3bias", _np(vh["Dense_1"]["bias"]))
    # sv3 = (scoremean, scorestdev, lead, vtime) from miscvalue cols 0-3
    # plus the two shortterm errors from moremiscvalue cols 0-1
    # (export_model_pytorch.py:642-651 write_value_head)
    sv3_mul = np.concatenate([_np(vh["Dense_2"]["kernel"])[:, :4],
                              _np(vh["Dense_3"]["kernel"])[:, :2]], axis=1)
    sv3_bias = np.concatenate([_np(vh["Dense_2"]["bias"])[:4],
                               _np(vh["Dense_3"]["bias"])[:2]])
    w.matmul("sv3mul", sv3_mul)
    w.matbias("sv3bias", sv3_bias)
    w.conv("vownershipconv", _np(vh["Conv_1"]["Conv_0"]["kernel"]))

    data = w.buf.getvalue()
    if path.endswith(".gz"):
        data = gzip.compress(data)
    with open(path, "wb") as f:
        f.write(data)
    return path
