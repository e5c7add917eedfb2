"""Training anomaly detection and metrics logging — ports of
katago/train/trainloop_helpers.py GnormWatcher (300-357) and
katago/train/metrics_logging.py (11-55); the port's own copy of
katago_tpu/train/watchers.py.
"""

from __future__ import annotations

import json
import math
import os


class GnormWatcherError(RuntimeError):
    pass


class GnormWatcher:
    """Halts training when the gradient norm is persistently pathological
    (nonfinite, or extremely large relative to the clip cap).

    Triggers (trainloop_helpers.py:300-357):
      - consecutive: >= consecutive_warn_threshold bad batches in a row,
        armed only after the first good batch;
      - startup: no good batch within the first startup_good_limit;
      - rate: >= rate_warn_fraction of the last rate_window batches bad.
    Raises GnormWatcherError unless KATAGO_GNORM_WATCHER_HALT=0 (warn-only).
    """

    def __init__(self, consecutive_warn_threshold=8, rate_window=100,
                 rate_warn_fraction=0.25, extreme_cap_factor=50.0,
                 startup_good_limit=30, log=print):
        self.consecutive_warn_threshold = consecutive_warn_threshold
        self.rate_window = rate_window
        self.rate_warn_fraction = rate_warn_fraction
        self.extreme_cap_factor = extreme_cap_factor
        self.startup_good_limit = startup_good_limit
        self.halt = os.environ.get("KATAGO_GNORM_WATCHER_HALT", "1") != "0"
        self.log = log
        self.window: list[int] = []
        self.window_pos = 0
        self.consecutive_bad = 0
        self.total_observed = 0
        self.total_bad = 0
        self.seen_good = False
        self._last_warn_at = None

    def _trigger(self, message: str):
        message += (" Training is likely diverging or gradients are being "
                    "corrupted.")
        if self.halt:
            raise GnormWatcherError(
                message + " Halting (KATAGO_GNORM_WATCHER_HALT=0 to warn).")
        if (self._last_warn_at is not None and
                self.total_observed - self._last_warn_at <
                self.rate_window // 2):
            return
        self._last_warn_at = self.total_observed
        self.log("WARNING: " + message)

    def observe(self, gnorm: float, gnorm_cap: float | None = None):
        bad = not math.isfinite(gnorm)
        if not bad and gnorm_cap is not None:
            bad = gnorm > self.extreme_cap_factor * gnorm_cap
        self.total_observed += 1
        self.total_bad += int(bad)
        if len(self.window) < self.rate_window:
            self.window.append(int(bad))
        else:
            self.window[self.window_pos] = int(bad)
            self.window_pos = (self.window_pos + 1) % self.rate_window
        if bad:
            self.consecutive_bad += 1
        else:
            self.consecutive_bad = 0
            self.seen_good = True

        if self.seen_good and \
                self.consecutive_bad >= self.consecutive_warn_threshold:
            self._trigger(f"{self.consecutive_bad} consecutive bad "
                          f"gradient-norm batches.")
        elif not self.seen_good and \
                self.total_observed >= self.startup_good_limit:
            self._trigger(f"no good gradient-norm batch in the first "
                          f"{self.total_observed} batches.")
        elif len(self.window) == self.rate_window and \
                sum(self.window) >= self.rate_warn_fraction * self.rate_window:
            self._trigger(f"{sum(self.window)}/{self.rate_window} recent "
                          f"batches had bad gradient norms.")


class MetricsLogger:
    """Moving-average metric accumulation + JSON-lines output
    (metrics_logging.py accumulate/log_metrics/clear_metric_nonfinite)."""

    def __init__(self, out_path: str | None = None, decay: float = 1.0):
        self.sums: dict[str, float] = {}
        self.weights: dict[str, float] = {}
        self.decay = decay
        if out_path:
            os.makedirs(os.path.dirname(os.path.abspath(out_path)),
                        exist_ok=True)
            self.out = open(out_path, "a")
        else:
            self.out = None

    def accumulate(self, metrics: dict, batch_size: int = 1,
                   weight: float = 1.0):
        if self.decay != 1.0:
            for k in self.sums:
                self.sums[k] *= self.decay
                self.weights[k] *= self.decay
        for k, v in metrics.items():
            v = float(v)
            self.sums[k] = self.sums.get(k, 0.0) + v * batch_size * weight
            self.weights[k] = self.weights.get(k, 0.0) + batch_size * weight

    def clear_nonfinite(self, log=print):
        for k in list(self.sums):
            if not math.isfinite(self.sums[k]):
                log(f"WARNING: nonfinite metric {k}, clearing")
                self.sums[k] = 0.0
                self.weights[k] = 0.0

    def snapshot(self) -> dict:
        return {k: self.sums[k] / max(self.weights[k], 1e-30)
                for k in self.sums}

    def log_line(self, extra: dict | None = None) -> dict:
        out = self.snapshot()
        if extra:
            out.update({k: float(v) for k, v in extra.items()})
        if self.out:
            self.out.write(json.dumps(out) + "\n")
            self.out.flush()
        return out

    def close(self):
        if self.out:
            self.out.close()
            self.out = None
