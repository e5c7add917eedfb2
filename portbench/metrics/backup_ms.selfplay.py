"""Host ms per playout step inside mcts.insert_and_backup (the span
around it), over the traced window's playout steps."""


def read(r):
    steps = r.counts["steps"]
    if not steps:
        return None
    return r.trace.span_s({"insert_and_backup"}) / steps * 1e3
