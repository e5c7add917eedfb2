"""Graceful SIGINT/SIGTERM draining for long-running commands.

The port's own copy of katago_tpu/utils/signals.py
(katago_torch imports nothing of the JAX package, not even its modules
that do not import JAX).

The reference installs signal handlers that set an atomic flag which the
selfplay/train/contribute loops poll so in-flight games finish and data
files close cleanly (sigReceived/shouldStop, selfplay.cpp:24-31,
gatekeeper.cpp:25-33, contribute.cpp:64-80). Same contract here: the
first signal requests a drain (finish the current batch, flush, exit);
a second signal raises KeyboardInterrupt immediately.
"""

from __future__ import annotations

import signal


class GracefulShutdown:
    """Context manager installing drain-on-signal handlers.

    with GracefulShutdown(log) as stop:
        for batch in ...:
            if stop.requested:
                break
            ...
    """

    def __init__(self, log=None):
        self._log = log or (lambda *_: None)
        self.requested = False
        self._prev = {}

    def _handler(self, signum, frame):
        del frame
        if self.requested:
            raise KeyboardInterrupt
        self.requested = True
        self._log(f"signal {signal.Signals(signum).name}: draining — "
                  "finishing the current batch (send again to abort)")

    def __enter__(self):
        for s in (signal.SIGINT, signal.SIGTERM):
            try:
                self._prev[s] = signal.signal(s, self._handler)
            except ValueError:  # not the main thread (tests)
                pass
        return self

    def __exit__(self, *exc):
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        return False
