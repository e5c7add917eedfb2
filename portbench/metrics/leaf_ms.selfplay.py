"""Host ms per playout step preparing the leaves: the union of the spans
around make_leaf_gamestate, legal_moves, ladder_map_chase_batch and
fill_features."""

NAMES = {"make_leaf_gamestate", "legal_moves", "ladder_map_chase_batch",
         "fill_features"}


def read(r):
    steps = r.counts["steps"]
    if not steps:
        return None
    return r.trace.span_s(NAMES) / steps * 1e3
