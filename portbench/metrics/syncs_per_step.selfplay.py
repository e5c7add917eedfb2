"""Host syncs with the card (cudaStreamSynchronize, cudaDeviceSynchronize,
cudaEventSynchronize, from the profiler's runtime events) per playout
step of the traced window."""


def read(r):
    steps = r.counts["steps"]
    if not steps:
        return None
    return r.trace.syncs() / steps
