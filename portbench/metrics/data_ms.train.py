"""Data path host ms per train step: the spans around the next batch
with its symmetry ("data") and the call that copies it to the card
("h2d"), over the traced window's steps. The step before ends with the
metrics' copy to the host, so the card waits through this time."""


def read(r):
    steps = r.counts["steps"]
    if not steps:
        return None
    return r.trace.span_s({"data", "h2d"}) / steps * 1e3
