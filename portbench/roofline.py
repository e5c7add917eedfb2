"""The yardstick's constants and arithmetic: the card's peaks, a net's
FLOPs per position from its configuration's shapes, and the bytes and
operations of the two hand-written kernels per call.

Peaks: NVIDIA's H100 SXM data sheet, dense rates, at the full 700 W
power limit (the harness prints the card's power.limit beside them).

The net: every convolution and dense layer of the nested-bottleneck net
(reference/net.py's parameter list), one multiply-add counted as 2
FLOPs; element-wise work (norms, activations, pooling, softmaxes) is
left out, as a FLOP count of convolutions usually does.

K1 and K2: copied from chip_smoke.py's phase K1 and phase K2 bound
(the bytes the function needs, read once and written once).
"""

from __future__ import annotations

import math

from portbench.reference import net as REF_NET

BF16_FLOPS_PER_S = 989e12      # tensor cores, dense
FP32_FLOPS_PER_S = 67e12       # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12          # 32-bit integer ops, as chip_smoke.py

# dense layers of the value head applied once per score-belief bucket
# rather than once per position (model_pytorch.py's score belief head)
_PER_BUCKET = ("ValueHead_0.Dense_5.kernel", "ValueHead_0.Dense_6.kernel",
               "ValueHead_0.Dense_7.kernel")


def flops_per_position(cfg: dict) -> float:
    """Forward FLOPs of one position (one board) of `cfg` at its board
    size: 2 x the multiply-adds of every kernel."""
    area = cfg["board_size"] ** 2
    buckets = 2 * (area + REF_NET.EXTRA_SCORE_DISTR_RADIUS)
    macs = 0
    for name, shape in REF_NET.param_shapes(cfg).items():
        if not name.endswith("kernel"):
            continue
        if len(shape) == 4:
            macs += area * math.prod(shape)
        else:
            macs += math.prod(shape) * (buckets if name in _PER_BUCKET else 1)
    return 2.0 * macs


def k1_bytes(n_active: int, lanes: int, size: int) -> int:
    """chip_smoke.py phase K1: the active lanes' stones plus rep,
    defender and premove (4 bytes each), `active` read and `out` written
    for every lane."""
    return n_active * (size * size + 3) * 4 + 2 * lanes


def k2_bytes(boards: int, size: int) -> int:
    """chip_smoke.py phase K2: int32 values read and labels written."""
    return 2 * boards * size * size * 4


def k2_ops(boards: int, size: int) -> int:
    """chip_smoke.py phase K2: compare, link and find per point."""
    return 5 * boards * size * size


def bound_s(nbytes: float, ops: float = 0.0) -> float:
    """The least time the card could take: the larger of bytes over HBM
    bandwidth and integer operations over the integer rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / INT_OPS_PER_S)
