"""The whole step's share of the bf16 peak: positions the net evaluated
in the traced window times the configuration's FLOPs per position, over
the window's length times 989 TFLOP/s, in %."""

from portbench import roofline as RF


def read(r):
    pos = r.counts["positions"]
    if not pos:
        return None
    return 100.0 * pos * RF.flops_per_position(r.cfg) / (
        r.trace.window_s * r.chips * RF.BF16_FLOPS_PER_S)
