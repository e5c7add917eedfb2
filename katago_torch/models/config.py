"""Named model architectures — a copy of katago_tpu/models/config.py.

The port keeps its own copy (it imports nothing from the JAX package).
Only the convolutional configs this slice runs are registered; the
dataclass keeps every field so configs compare field for field.

The reference defines dict configs keyed by names like b6c96 / b18c384nbt
(modelconfigs.py:605-641, 1838-1871): trunk/mid/gpool channel counts, a list
of block kinds, head channel sizes, norm kind and activation.

Block kinds the port's net runs: "regular", "regulargpool", "bottlenest2"
and "bottlenest2gpool"; the others (transformer kinds, bottle1-3) raise in
models/model.py.
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

_register(ModelConfig(
    name="b6c96", trunk_num_channels=96, mid_num_channels=96,
    gpool_num_channels=32,
    block_kind=_blocks([("regular", 2), ("regulargpool", 1), ("regular", 1),
                        ("regulargpool", 1), ("regular", 1)]),
    p1_num_channels=32, g1_num_channels=32, v1_num_channels=32,
    v2_size=64, sbv2_num_channels=48, num_scorebeliefs=4,
))

_register(ModelConfig(
    name="b18c384nbt", trunk_num_channels=384, mid_num_channels=192,
    gpool_num_channels=64,
    block_kind=_blocks([("bottlenest2", 2), ("bottlenest2gpool", 1)] * 5
                       + [("bottlenest2", 3)]),
    p1_num_channels=48, g1_num_channels=48, v1_num_channels=96,
    v2_size=128, sbv2_num_channels=112, num_scorebeliefs=8,
))


def get_config(name: str) -> ModelConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown model config {name!r}; have {sorted(CONFIGS)}")
    return CONFIGS[name]
