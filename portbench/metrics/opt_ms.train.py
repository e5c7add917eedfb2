"""Optimizer and EMA ms per train step on the card's timeline: from a
CUDA event recorded as the step calls optimizer.update to one recorded
as the step returns, summed over the traced window's steps (no
synchronisation added to the step)."""


def read(r):
    steps = r.counters.get("opt_steps", 0)
    if not steps:
        return None
    return r.counters["opt_device_s"] / steps * 1e3
