"""Named model architectures — the port's copy of
katago_tpu/models/config.py (the reference's
python/katago/train/modelconfigs.py).

The port keeps its own copy (it imports nothing from the JAX package):
the same 23 presets with the same names and fields, so configs compare
field for field.

The reference defines dict configs keyed by names like b6c96 / b18c384nbt
(modelconfigs.py:605-641, 1838-1871): trunk/mid/gpool channel counts, a list
of block kinds, head channel sizes, norm kind and activation.

Block kinds: "regular", "regulargpool", "bottle{1,2,3}" (+gpool),
"bottlenest2" (+gpool), the v17 transformer kinds "attn" / "attnrope"
(RMSNorm + multi-head attention, optionally with 2-D RoPE,
model_pytorch.py:2079), "ffng" / "ffnsg" (RMSNorm + FFN, plain / SwiGLU,
model_pytorch.py:2485), and the nested-bottleneck hybrids
"bottlenest{N}transformer[rope][gab]sg" (models/model.py).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

EXTRA_SCORE_DISTR_RADIUS = 60  # model_pytorch.py:26


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    version: int = 15
    norm_kind: str = "fixup"
    activation: str = "relu"
    trunk_num_channels: int = 96
    mid_num_channels: int = 96
    gpool_num_channels: int = 32
    block_kind: Sequence[str] = ()
    p1_num_channels: int = 32
    g1_num_channels: int = 32
    v1_num_channels: int = 32
    v2_size: int = 64
    sbv2_num_channels: int = 48
    num_scorebeliefs: int = 4
    initial_conv_1x1: bool = False
    # humanSL metadata conditioning (model_pytorch.py:2881)
    metadata_encoder: bool = False
    metadata_encoder_channels: int = 64
    # intermediate auxiliary heads partway down the trunk
    # (model_pytorch.py:3073-3078, modelconfigs.py:2098-2108)
    has_intermediate_head: bool = False
    intermediate_head_blocks: int = 0
    # v17 transformer knobs (modelconfigs.py b5c48h3tfr etc.)
    transformer_ffn_channels: int = 0
    transformer_heads: int = 0
    transformer_kv_heads: int = 0
    attention_qk_norm: bool = False
    rope_theta: float = 100.0
    # Geometric Attention Bias (modelconfigs.py b5c384h6nbttfgabs)
    gab_num_templates: int = 48
    gab_num_fourier_features: int = 16
    gab_mlp_hidden: int = 128
    gab_d1: int = 32
    gab_d2: int = 32

    @property
    def num_policy_outputs(self) -> int:
        # version <=11: 4; <=15: 6; 16: 8 (model_pytorch.py:2599-2611)
        if self.version <= 11:
            return 4
        if self.version <= 15:
            return 6
        return 8

    def scorebelief_len(self, pos_len: int) -> int:
        return 2 * (pos_len * pos_len + EXTRA_SCORE_DISTR_RADIUS)


def _blocks(pattern: Sequence[tuple[str, int]]) -> tuple[str, ...]:
    out = []
    for kind, n in pattern:
        out.extend([kind] * n)
    return tuple(out)


CONFIGS: dict[str, ModelConfig] = {}


def _register(cfg: ModelConfig) -> ModelConfig:
    CONFIGS[cfg.name] = cfg
    return cfg


# Tiny net for fast tests (not in the reference; same role as its base64
# embedded tinymodel, cpp/tests/tinymodel.h:10-21).
_register(ModelConfig(
    name="b1c6", trunk_num_channels=6, mid_num_channels=6,
    gpool_num_channels=4,
    block_kind=("regulargpool",),
    p1_num_channels=4, g1_num_channels=4, v1_num_channels=4,
    v2_size=8, sbv2_num_channels=8, num_scorebeliefs=2,
))

_register(ModelConfig(
    name="b2c16", trunk_num_channels=16, mid_num_channels=16,
    gpool_num_channels=8,
    block_kind=("regular", "regulargpool"),
    p1_num_channels=8, g1_num_channels=8, v1_num_channels=8,
    v2_size=16, sbv2_num_channels=16, num_scorebeliefs=2,
))

# Historic katago architecture (modelconfigs.py "b6c96")
_register(ModelConfig(
    name="b6c96", trunk_num_channels=96, mid_num_channels=96,
    gpool_num_channels=32,
    block_kind=_blocks([("regular", 2), ("regulargpool", 1), ("regular", 1),
                        ("regulargpool", 1), ("regular", 1)]),
    p1_num_channels=32, g1_num_channels=32, v1_num_channels=32,
    v2_size=64, sbv2_num_channels=48, num_scorebeliefs=4,
))

_register(ModelConfig(
    name="b10c128", trunk_num_channels=128, mid_num_channels=128,
    gpool_num_channels=32,
    block_kind=_blocks([("regular", 4), ("regulargpool", 1), ("regular", 2),
                        ("regulargpool", 1), ("regular", 2)]),
    p1_num_channels=32, g1_num_channels=32, v1_num_channels=32,
    v2_size=80, sbv2_num_channels=64, num_scorebeliefs=6,
))

# The historical conv run ladder (modelconfigs.py b15c192..b60c320: the
# g170/g104 run shapes — 15-block gpools at 7/12, larger ones every 5th
# block starting at 6)
_register(ModelConfig(
    name="b15c192", trunk_num_channels=192, mid_num_channels=192,
    gpool_num_channels=64,
    block_kind=_blocks([("regular", 6), ("regulargpool", 1), ("regular", 4),
                        ("regulargpool", 1), ("regular", 3)]),
    p1_num_channels=32, g1_num_channels=32, v1_num_channels=32,
    v2_size=96, sbv2_num_channels=80, num_scorebeliefs=8,
))

_register(ModelConfig(
    name="b20c256", trunk_num_channels=256, mid_num_channels=256,
    gpool_num_channels=64,
    block_kind=_blocks([("regular", 6), ("regulargpool", 1), ("regular", 4),
                        ("regulargpool", 1), ("regular", 4),
                        ("regulargpool", 1), ("regular", 3)]),
    p1_num_channels=48, g1_num_channels=48, v1_num_channels=48,
    v2_size=112, sbv2_num_channels=96, num_scorebeliefs=8,
))

_register(ModelConfig(
    name="b30c320", trunk_num_channels=320, mid_num_channels=320,
    gpool_num_channels=96,
    block_kind=_blocks([("regular", 5), ("regulargpool", 1)]
                       + [("regular", 4), ("regulargpool", 1)] * 4
                       + [("regular", 4)]),
    p1_num_channels=48, g1_num_channels=48, v1_num_channels=96,
    v2_size=128, sbv2_num_channels=112, num_scorebeliefs=8,
))

_register(ModelConfig(
    name="b40c256", trunk_num_channels=256, mid_num_channels=256,
    gpool_num_channels=64,
    block_kind=_blocks([("regular", 5), ("regulargpool", 1)]
                       + [("regular", 4), ("regulargpool", 1)] * 6
                       + [("regular", 4)]),
    p1_num_channels=48, g1_num_channels=48, v1_num_channels=96,
    v2_size=128, sbv2_num_channels=112, num_scorebeliefs=8,
))

_register(ModelConfig(
    name="b60c320", trunk_num_channels=320, mid_num_channels=320,
    gpool_num_channels=96,
    block_kind=_blocks([("regular", 5), ("regulargpool", 1)]
                       + [("regular", 4), ("regulargpool", 1)] * 10
                       + [("regular", 4)]),
    p1_num_channels=64, g1_num_channels=64, v1_num_channels=96,
    v2_size=144, sbv2_num_channels=128, num_scorebeliefs=8,
))

_register(ModelConfig(
    name="b5c192nbt", trunk_num_channels=192, mid_num_channels=96,
    gpool_num_channels=32,
    block_kind=_blocks([("bottlenest2", 1), ("bottlenest2gpool", 1),
                        ("bottlenest2", 1), ("bottlenest2gpool", 1),
                        ("bottlenest2", 1)]),
    p1_num_channels=32, g1_num_channels=32, v1_num_channels=32,
    v2_size=64, sbv2_num_channels=64, num_scorebeliefs=6,
))

# The nbt ladder (modelconfigs.py: gpool every 3rd block)
_register(ModelConfig(
    name="b8c192nbt", trunk_num_channels=192, mid_num_channels=96,
    gpool_num_channels=32,
    block_kind=_blocks([("bottlenest2", 2), ("bottlenest2gpool", 1)] * 2
                       + [("bottlenest2", 2)]),
    p1_num_channels=32, g1_num_channels=32, v1_num_channels=32,
    v2_size=80, sbv2_num_channels=64, num_scorebeliefs=6,
))

_register(ModelConfig(
    name="b10c256nbt", trunk_num_channels=256, mid_num_channels=128,
    gpool_num_channels=64,
    block_kind=_blocks([("bottlenest2", 2), ("bottlenest2gpool", 1)] * 3
                       + [("bottlenest2", 1)]),
    p1_num_channels=32, g1_num_channels=32, v1_num_channels=32,
    v2_size=96, sbv2_num_channels=80, num_scorebeliefs=8,
))

_register(ModelConfig(
    name="b10c384nbt", trunk_num_channels=384, mid_num_channels=192,
    gpool_num_channels=64,
    block_kind=_blocks([("bottlenest2", 2), ("bottlenest2gpool", 1)] * 3
                       + [("bottlenest2", 1)]),
    p1_num_channels=48, g1_num_channels=48, v1_num_channels=48,
    v2_size=112, sbv2_num_channels=96, num_scorebeliefs=8,
))

# Recommended best config at AlphaGoZero cost (modelconfigs.py "b18c384nbt")
_register(ModelConfig(
    name="b18c384nbt", trunk_num_channels=384, mid_num_channels=192,
    gpool_num_channels=64,
    block_kind=_blocks([("bottlenest2", 2), ("bottlenest2gpool", 1)] * 5
                       + [("bottlenest2", 3)]),
    p1_num_channels=48, g1_num_channels=48, v1_num_channels=96,
    v2_size=128, sbv2_num_channels=112, num_scorebeliefs=8,
))

_register(ModelConfig(
    name="b20c640nbt", trunk_num_channels=640, mid_num_channels=320,
    gpool_num_channels=96,
    block_kind=_blocks([("bottlenest2", 2), ("bottlenest2gpool", 1)] * 6
                       + [("bottlenest2", 2)]),
    p1_num_channels=64, g1_num_channels=64, v1_num_channels=96,
    v2_size=144, sbv2_num_channels=128, num_scorebeliefs=8,
))

_register(ModelConfig(
    name="b28c512nbt", trunk_num_channels=512, mid_num_channels=256,
    gpool_num_channels=64,
    block_kind=_blocks([("bottlenest2", 2), ("bottlenest2gpool", 1)] * 8
                       + [("bottlenest2", 4)]),
    p1_num_channels=64, g1_num_channels=64, v1_num_channels=128,
    v2_size=144, sbv2_num_channels=128, num_scorebeliefs=8,
))

_register(ModelConfig(
    name="b32c448nbt", trunk_num_channels=448, mid_num_channels=224,
    gpool_num_channels=64,
    block_kind=_blocks([("bottlenest2", 2), ("bottlenest2gpool", 1)] * 10
                       + [("bottlenest2", 2)]),
    p1_num_channels=64, g1_num_channels=64, v1_num_channels=96,
    v2_size=144, sbv2_num_channels=128, num_scorebeliefs=8,
))

_register(ModelConfig(
    name="b40c768nbt", trunk_num_channels=768, mid_num_channels=384,
    gpool_num_channels=128,
    block_kind=_blocks([("bottlenest2", 2), ("bottlenest2gpool", 1)] * 13
                       + [("bottlenest2", 1)]),
    p1_num_channels=128, g1_num_channels=128, v1_num_channels=256,
    v2_size=256, sbv2_num_channels=256, num_scorebeliefs=8,
))


# v17 transformer configs (modelconfigs.py:985-1100)
_register(ModelConfig(
    name="b5c48h3tfr", version=17, trunk_num_channels=48,
    mid_num_channels=48, gpool_num_channels=32,
    transformer_ffn_channels=128, transformer_heads=3,
    transformer_kv_heads=3,
    block_kind=tuple(k for _ in range(5) for k in ("attnrope", "ffng")),
    p1_num_channels=16, g1_num_channels=16, v1_num_channels=16,
    v2_size=48, sbv2_num_channels=32, num_scorebeliefs=4,
))

_register(ModelConfig(
    name="b7c96h3tfrs", version=17, trunk_num_channels=96,
    mid_num_channels=96, gpool_num_channels=32,
    transformer_ffn_channels=256, transformer_heads=3,
    transformer_kv_heads=3,
    block_kind=tuple(k for _ in range(7) for k in ("attnrope", "ffnsg")),
    p1_num_channels=32, g1_num_channels=32, v1_num_channels=32,
    v2_size=64, sbv2_num_channels=48, num_scorebeliefs=4,
))

_register(ModelConfig(
    name="b7c96h6kv3tfrs", version=17, trunk_num_channels=96,
    mid_num_channels=96, gpool_num_channels=32,
    transformer_ffn_channels=256, transformer_heads=6,
    transformer_kv_heads=3, attention_qk_norm=True,
    block_kind=tuple(k for _ in range(7) for k in ("attnrope", "ffnsg")),
    p1_num_channels=32, g1_num_channels=32, v1_num_channels=32,
    v2_size=64, sbv2_num_channels=48, num_scorebeliefs=4,
))

# nested-bottleneck transformer hybrids (modelconfigs.py b5c384h6nbttflrs
# / b5c384h6nbttfgabs): conv 1x1 sandwich around RoPE- or GAB-positioned
# attention+SwiGLU pairs at mid width
_register(ModelConfig(
    name="b5c384h6nbttflrs", version=17, trunk_num_channels=384,
    mid_num_channels=192, gpool_num_channels=32,
    transformer_ffn_channels=512, transformer_heads=6,
    transformer_kv_heads=6,
    block_kind=("bottlenest2transformerropesg",) * 5,
    p1_num_channels=32, g1_num_channels=32, v1_num_channels=32,
    v2_size=96, sbv2_num_channels=80, num_scorebeliefs=8,
))

_register(ModelConfig(
    name="b5c384h6nbttfgabs", version=17, trunk_num_channels=384,
    mid_num_channels=192, gpool_num_channels=32,
    transformer_ffn_channels=512, transformer_heads=6,
    transformer_kv_heads=6,
    block_kind=("bottlenest2transformergabsg",) * 5,
    p1_num_channels=32, g1_num_channels=32, v1_num_channels=32,
    v2_size=96, sbv2_num_channels=80, num_scorebeliefs=8,
))


def get_config(name: str) -> ModelConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown model config {name!r}; have {sorted(CONFIGS)}")
    return CONFIGS[name]
