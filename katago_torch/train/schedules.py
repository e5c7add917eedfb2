"""LR schedules and SWA weight averaging (reference python/train.py) —
the port's copy of katago_tpu/train/schedules.py.

The reference scales a hardcoded base LR by a piecewise-constant factor of
total samples seen: either the built-in `-lr-scale-auto` / `-lr-scale-auto2`
tables (train.py:504-546) or an explicit `-lr-schedule`
"(0,12.0),(20M,9.0),..." string (train.py:86,169-190, thresholds accept
K/M/B suffixes). SWA keeps a separate running average of weights sampled
every `swa_period_samples`, averaging `swa_scale` samples in expectation
(train.py:95-96,440-443,814-818: AveragedModel with ema factor 1/swa_scale)
— distinct from the per-step EMA used for export.

A schedule here is evaluated on the host with the optimizer's integer
step count and returns a numpy float32, computed as the JAX package's
traced schedule computes it (float32 sample counts and thresholds), so
both give the same learning rate bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

_SUFFIX = {"K": 1_000, "M": 1_000_000, "B": 1_000_000_000}

# (upper-bound samples, scale) rows; last row is the open-ended tail.
# train.py:504-522
LR_SCALE_AUTO = [
    (550e6, 8.0), (1400e6, 6.0), (2500e6, 4.0), (3400e6, 3.0),
    (4200e6, 2.0), (4900e6, 1.5), (5500e6, 1.0), (6400e6, 0.7),
    (float("inf"), 0.5),
]

# train.py:524-546: the fast small-run table, multiplied by the user factor.
LR_SCALE_AUTO2 = [
    (20e6, 12.0), (40e6, 9.0), (70e6, 6.0), (100e6, 5.0), (140e6, 4.0),
    (190e6, 3.5), (250e6, 3.0), (320e6, 2.5), (400e6, 2.0), (500e6, 1.7),
    (610e6, 1.4), (730e6, 1.2), (860e6, 1.0), (float("inf"), 0.8),
]


def parse_suffixed_count(s: str) -> int:
    """'20M' -> 20000000; plain ints pass through (train.py:169-177)."""
    s = s.strip()
    if s and s[-1].upper() in _SUFFIX:
        return int(float(s[:-1]) * _SUFFIX[s[-1].upper()])
    return int(float(s))


def parse_lr_schedule(schedule_str: str) -> list[tuple[int, float]]:
    """Parse "(0,12.0),(20M,9.0),(40M,6.0)" into [(samples, scale), ...].

    Must start at samples=0 and be strictly increasing (train.py:169-190).
    """
    s = schedule_str.replace(" ", "")
    points = []
    for part in s.split("),("):
        part = part.strip("()")
        if not part:
            continue
        thresh_str, _, val_str = part.partition(",")
        points.append((parse_suffixed_count(thresh_str), float(val_str)))
    if not points or points[0][0] != 0:
        raise ValueError(f"lr schedule must start at (0,...): {schedule_str!r}")
    for (a, _), (b, _) in zip(points, points[1:]):
        if b <= a:
            raise ValueError(f"lr schedule thresholds must increase: "
                             f"{schedule_str!r}")
    return points


def piecewise_scale(points: list[tuple[float, float]], samples,
                    upper_bound_rows: bool = False) -> np.float32:
    """Look up the scale at `samples` (in float32, as the JAX package
    looks it up under jit).

    upper_bound_rows=True: points are (upper_bound, scale) rows (the auto
    tables). False: points are (threshold, scale) onset rows (explicit
    schedules, train.py:555-561)."""
    bounds = np.asarray([float(p[0]) for p in points], np.float32)
    scales = np.asarray([float(p[1]) for p in points], np.float32)
    s = np.float32(samples)
    if upper_bound_rows:
        # first row whose bound exceeds samples
        idx = int(np.searchsorted(bounds, s, side="right"))
    else:
        # last onset threshold <= samples
        idx = int(np.searchsorted(bounds, s, side="right")) - 1
    return scales[min(max(idx, 0), len(points) - 1)]


def make_lr_schedule(base_lr: float, samples_per_step: int, *,
                     lr_scale: float | None = None,
                     lr_scale_auto: bool = False,
                     lr_scale_auto2: float | None = None,
                     lr_schedule_str: str | None = None,
                     start_samples: int = 0):
    """Return a schedule fn(step_count) -> lr (numpy float32).

    Exactly one of the scale modes may be set; with none set the scale
    is 1.0. step_count is this process's step counter; start_samples
    offsets it by the samples already seen at resume."""
    modes = sum([lr_scale is not None, lr_scale_auto,
                 lr_scale_auto2 is not None, lr_schedule_str is not None])
    if modes > 1:
        raise ValueError("at most one LR scale mode may be set")
    if lr_schedule_str is not None:
        points = parse_lr_schedule(lr_schedule_str)

        def sched(count):
            samples = start_samples + count * samples_per_step
            return np.float32(base_lr) * piecewise_scale(points, samples)
    elif lr_scale_auto:
        def sched(count):
            samples = start_samples + count * samples_per_step
            return np.float32(base_lr) * piecewise_scale(
                LR_SCALE_AUTO, samples, upper_bound_rows=True)
    elif lr_scale_auto2 is not None:
        def sched(count):
            samples = start_samples + count * samples_per_step
            return np.float32(base_lr * lr_scale_auto2) * piecewise_scale(
                LR_SCALE_AUTO2, samples, upper_bound_rows=True)
    else:
        factor = 1.0 if lr_scale is None else lr_scale

        def sched(count):
            return np.float32(base_lr * factor)
    return sched


class SwaTracker:
    """Host-side SWA bookkeeping (train.py:981-982,1560-1572): every
    `period_samples` training samples, fold the current params into the
    running average with factor 1/scale."""

    def __init__(self, period_samples: float, scale: float,
                 accum: float = 0.0):
        self.period_samples = float(period_samples)
        self.scale = float(scale)
        self.accum = float(accum)  # persisted as swa_sample_accum

    def step(self, samples_this_step: int) -> bool:
        """Advance by one train step; True when an SWA sample is due."""
        self.accum += samples_this_step
        if self.accum >= self.period_samples:
            self.accum -= self.period_samples
            if self.accum > self.period_samples:  # fell far behind; snap
                self.accum = 0.0
            return True
        return False

    @torch.no_grad()
    def update(self, swa_params: dict, params: dict) -> dict:
        """swa <- swa*(1-1/scale) + params*(1/scale), per state_dict
        entry."""
        f = 1.0 / self.scale
        return {k: s * (1.0 - f) + params[k] * f
                for k, s in swa_params.items()}
