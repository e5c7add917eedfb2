"""The whole train step's share of the float32 peak: rows trained in the
traced window times 3 x the configuration's forward FLOPs per position
(forward and backward), over the window's length times the chips times
67 TFLOP/s, in %."""

from portbench import roofline as RF


def read(r):
    rows = r.counts["rows"]
    if not rows:
        return None
    return 100.0 * rows * 3.0 * RF.flops_per_position(r.cfg) / (
        r.trace.window_s * r.chips * RF.FP32_FLOPS_PER_S)
