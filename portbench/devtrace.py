"""The device trace of a traced window, read from ``torch.profiler``.

A traced run wraps its traced steps in a ``record_function("window")``
(after one profiled step, whose operations are left out) and,
inside each step, the program's loss and backward's forward half in
``"forward+loss"``, the optimizer in ``"optimizer"`` and the loss's read
back in ``"loss read"`` (from the benchmark's own wrappers; the program is
not edited).  :func:`read` takes the profiler's events and gives a
:class:`Trace`: every device operation with its name, its interval and the
host range that launched it, and the window.  What is not in one of the
named ranges is the backward and the glue between calls.
"""
from __future__ import annotations

import bisect
import dataclasses

WINDOW = "window"
RANGES = ("forward+loss", "optimizer", "loss read")
OTHER = "backward and glue"


@dataclasses.dataclass
class DeviceOp:
    name: str
    start_ns: int
    end_ns: int
    launched_in: str | None      # None: the launch was not found


@dataclasses.dataclass
class Trace:
    ops: list
    window: tuple                # (start_ns, end_ns) on the host clock
    ranges: list                 # [(start_ns, end_ns, name)], sorted

    def __post_init__(self):
        self._starts = [r[0] for r in self.ranges]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals, clipped to the
        window."""
        lo, hi = self.window
        spans = sorted((max(o.start_ns, lo), min(o.end_ns, hi))
                       for o in self.ops if o.end_ns > lo and o.start_ns < hi)
        merged: list = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def range_at(self, t_ns: int) -> str:
        """The named host range open at ``t_ns`` (they do not nest), else
        the backward and glue."""
        i = bisect.bisect_right(self._starts, t_ns) - 1
        if i >= 0 and t_ns < self.ranges[i][1]:
            return self.ranges[i][2]
        return OTHER

    def idle_gaps(self) -> list:
        """[(host range open at the gap's middle, seconds)] of every gap
        between busy intervals inside the window."""
        lo, hi = self.window
        gaps, at = [], lo
        for s, e in self.busy_intervals() + [[hi, hi]]:
            if s > at:
                gaps.append((self.range_at((at + s) // 2), (s - at) / 1e9))
            at = max(at, e)
        return gaps

    def device_time_by_name(self) -> dict:
        out: dict = {}
        for o in self.ops:
            out[o.name] = out.get(o.name, 0.0) + (o.end_ns - o.start_ns) / 1e9
        return out

    def breakdown(self, top: int = 10) -> dict:
        by_name = sorted(self.device_time_by_name().items(),
                         key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_gaps(), key=lambda g: -g[1])[:top]
        return {"device_ops": [[n[:160], s] for n, s in by_name],
                "idle_gaps": [[n, s] for n, s in gaps]}


def read(prof) -> Trace:
    """A :class:`Trace` of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    launches: dict = {}
    device: list = []
    ranges: list = []
    window = None
    for e in events:
        name = e.name()
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() != DeviceType.CPU:
            if name == WINDOW or name in RANGES:   # a range's device echo
                continue
            device.append((name, start, end, e.correlation_id(),
                           e.linked_correlation_id()))
        elif name == WINDOW:
            window = (start, end)
        elif name in RANGES:
            ranges.append((start, end, name))
        elif name.startswith("cu"):          # a runtime call, a launch
            launches[e.correlation_id()] = start
    if window is None:
        raise RuntimeError("the trace holds no window range")
    ranges.sort()
    tr = Trace(ops=[], window=window, ranges=ranges)
    for name, start, end, corr, linked in device:
        if start < window[0]:       # the profiler's start-up step
            continue
        at = launches.get(corr, launches.get(linked))
        tr.ops.append(DeviceOp(name, start, end,
                               None if at is None else tr.range_at(at)))
    return tr
