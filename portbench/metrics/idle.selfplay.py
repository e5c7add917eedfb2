"""The card's idle share of the traced window: 1 minus the union of its
kernel, copy and set intervals over the window, in %."""


def read(r):
    return 100.0 * (1.0 - r.trace.busy_s() / r.trace.window_s)
