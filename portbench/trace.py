"""The traced run's instruments: named host spans around the program's
layer calls (torch.profiler record_function ranges, installed from
outside the program), counters, and the reduction of the profiler's raw
events to device intervals, syncs and idle gaps.

The raw kineto events are read directly (no FunctionEvent tree, no
key_averages), so a window of a million events reduces in seconds.
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch.profiler import ProfilerActivity, profile, record_function

SPAN_PREFIX = "portbench:"
SYNC_NAMES = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")
_DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


def wrap_span(obj, attr: str, name: str, patches: list) -> None:
    """Replace obj.attr by a wrapper that runs it inside the span `name`;
    the original goes onto `patches` for `unwrap`."""
    fn = getattr(obj, attr)

    @functools.wraps(fn)
    def wrapped(*a, **k):
        with record_function(SPAN_PREFIX + name):
            return fn(*a, **k)
    patches.append((obj, attr, fn))
    setattr(obj, attr, wrapped)


def span(name: str):
    """A named span around a block of the benchmark's own loop."""
    return record_function(SPAN_PREFIX + name)


def unwrap(patches: list) -> None:
    while patches:
        obj, attr, fn = patches.pop()
        setattr(obj, attr, fn)


class Trace:
    """What a traced window recorded: device intervals (start_ns, end_ns,
    name), the host's spans (start_ns, end_ns, name without the prefix),
    the CUDA runtime calls by name, and the window's bounds on the same
    clock."""

    def __init__(self, events, t0_ns: int, t1_ns: int):
        self.window = (t0_ns, t1_ns)
        self.device, self.spans, self.runtime = [], [], {}
        for e in events:
            start, end = e.start_ns(), e.end_ns()
            if end < t0_ns or start > t1_ns:
                continue
            kind = e.activity_type() if hasattr(e, "activity_type") else ""
            name = e.name()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if e.is_user_annotation() or kind not in _DEVICE_KINDS \
                        and kind:
                    continue
                self.device.append((max(start, t0_ns), min(end, t1_ns),
                                    name))
            elif e.is_user_annotation() and name.startswith(SPAN_PREFIX):
                self.spans.append((start, end, name[len(SPAN_PREFIX):]))
            elif kind == "cuda_runtime" or name.startswith("cuda"):
                self.runtime[name] = self.runtime.get(name, 0) + 1

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def busy_intervals(self):
        """The union of the device intervals, sorted."""
        out = []
        for s, e, _ in sorted(self.device):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def syncs(self) -> int:
        return sum(self.runtime.get(n, 0) for n in SYNC_NAMES)

    def device_s(self, match) -> float:
        """Summed device seconds of the intervals whose name `match`es."""
        return sum(e - s for s, e, n in self.device if match(n)) * 1e-9

    def span_s(self, names) -> float:
        """Host seconds covered by the union of the spans named in
        `names` (nested spans are not counted twice)."""
        iv = sorted((s, e) for s, e, n in self.spans if n in names)
        total, cur_s, cur_e = 0, None, None
        for s, e in iv:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total * 1e-9

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps named by the innermost span the host was in at their middle."""
        by_op = {}
        for s, e, n in self.device:
            by_op[n] = by_op.get(n, 0) + (e - s)
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        gaps, prev = [], self.window[0]
        for s, e in self.busy_intervals() + [[self.window[1]] * 2]:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        gaps.sort(key=lambda g: g[0] - g[1])
        named = []
        for s, e in gaps[:top]:
            mid = (s + e) // 2
            inner = [sp for sp in self.spans if sp[0] <= mid <= sp[1]
                     and sp[2] != "window"]
            where = min(inner, key=lambda sp: sp[1] - sp[0])[2] \
                if inner else "outside layer spans"
            named.append([where, (e - s) * 1e-9])
        return {"device_ops": [[n, v * 1e-9] for n, v in ops],
                "idle_gaps": named}


@contextlib.contextmanager
def traced():
    """Profile the block on the CPU and the card; yields a holder whose
    `trace` is set once the block has ended (window: from entry, after a
    synchronize, to the synchronize at exit)."""
    holder = type("Holder", (), {"trace": None})()
    acts = [ProfilerActivity.CPU]
    if torch.version.cuda:              # a CPU build traces the host only
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        torch.cuda.synchronize()
        with record_function(SPAN_PREFIX + "window"):
            yield holder
            torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    win = [e for e in events if e.name() == SPAN_PREFIX + "window"
           and e.device_type() != torch.autograd.DeviceType.CUDA]
    t0, t1 = win[0].start_ns(), win[0].end_ns()
    holder.trace = Trace(events, t0, t1)
