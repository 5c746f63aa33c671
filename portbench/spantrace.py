"""The device trace of a traced window, with the program's own spans.

While a profiler runs, the program opens host ranges named ``rt/...``
inside its training step (``src/repro_torch/obs/spans.py``): the step,
its forward and backward, each layer and its replay under the remat, the
head, the f32 loss and their backward, the optimizer, the gradient's norm,
the collectives, the loss's read, a checkpoint and each garbage
collection.  :func:`read` reads what :func:`portbench.devtrace.read`
reads (the same operations, window and benchmark ranges; a trace without
``rt/`` spans gives the same ``ops``, ``ranges`` and ``breakdown()``) and
adds, beside it:

* the program's spans (``spans``), and the stack of them open at any
  time on the host's clock (:meth:`SpanTrace.stacks_at`, innermost last;
  spans of the autograd engine's thread nest in time inside the caller's
  ``rt/backward``);
* each device operation's spans open at its launch (:class:`SpanOp`);
* each runtime call that enqueued device work, by its time and name
  (``launches``): a kernel launch, a copy or a fill, a graph launch;
* idle gaps named by the benchmark range and the innermost span open at
  the gap's middle (``forward+loss/rt/loss``).

The readings below are per traced step, a step being an ``rt/step`` span
inside the window; a trace without one (a program without spans) reads
None.  ``python3 portbench/span_table.py`` prints them for a cell.
"""
from __future__ import annotations

import dataclasses

from portbench import devtrace
from portbench.devtrace import RANGES, WINDOW

PREFIX = "rt/"
STEP = PREFIX + "step"
HEAD_LOSS = (PREFIX + "head", PREFIX + "loss", PREFIX + "backward/head_loss")
REMAT_REPLAY = PREFIX + "remat_replay"


@dataclasses.dataclass
class SpanOp(devtrace.DeviceOp):
    spans: tuple = ()        # open at its launch, innermost last

    @property
    def span(self) -> str | None:
        return self.spans[-1] if self.spans else None


@dataclasses.dataclass
class SpanTrace(devtrace.Trace):
    spans: list = dataclasses.field(default_factory=list)
    launches: list = dataclasses.field(default_factory=list)
    echoes: int = 0          # device echoes of ``rt/`` spans, dropped

    def stacks_at(self, times: list) -> list:
        """For each host time, the names of the program's spans open at
        it, outermost first."""
        # by start, and of two that start together the longer first
        order = sorted(self.spans, key=lambda s: (s[0], -s[1]))
        out: list = [()] * len(times)
        active: list = []
        i = 0
        for k in sorted(range(len(times)), key=times.__getitem__):
            t = times[k]
            while i < len(order) and order[i][0] <= t:
                active.append(order[i])
                i += 1
            active = [s for s in active if s[1] > t]
            out[k] = tuple(s[2] for s in active)
        return out

    def innermost_span(self, t_ns: int) -> str | None:
        stack = self.stacks_at([t_ns])[0]
        return stack[-1] if stack else None

    def idle_gaps(self) -> list:
        """:meth:`devtrace.Trace.idle_gaps`, each named also by the
        innermost program span open at its middle, where there is one."""
        gaps = self.gaps()
        mids = [(a + b) // 2 for a, b in gaps]
        return [(self.range_at(m) + (f"/{st[-1]}" if st else ""),
                 (b - a) / 1e9)
                for m, (a, b), st in zip(mids, gaps, self.stacks_at(mids))]

    def gaps(self) -> list:
        """[(start_ns, end_ns)] of every gap between busy intervals inside
        the window."""
        lo, hi = self.window
        out, at = [], lo
        for s, e in self.busy_intervals() + [[hi, hi]]:
            if s > at:
                out.append((at, s))
            at = max(at, e)
        return out

    def steps(self) -> int:
        lo, hi = self.window
        return sum(1 for s, e, n in self.spans
                   if n == STEP and lo <= s and e <= hi)


def read(prof) -> SpanTrace:
    """A :class:`SpanTrace` of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType
    calls: dict = {}
    device: list = []
    ranges: list = []
    spans: list = []
    echoes = 0
    window = None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() != DeviceType.CPU:
            # a range's device echo
            if name == WINDOW or name in RANGES:
                continue
            if name.startswith(PREFIX):
                echoes += 1
                continue
            device.append((name, start, end, e.correlation_id(),
                           e.linked_correlation_id()))
        elif name == WINDOW:
            window = (start, end)
        elif name in RANGES:
            ranges.append((start, end, name))
        elif name.startswith(PREFIX):
            spans.append((start, end, name))
        elif name.startswith("cu"):          # a runtime call, a launch
            calls[e.correlation_id()] = (start, name)
    if window is None:
        raise RuntimeError("the trace holds no window range")
    ranges.sort()
    spans.sort()
    tr = SpanTrace(ops=[], window=window, ranges=ranges, spans=spans,
                   echoes=echoes)
    kept = []
    for name, start, end, corr, linked in device:
        if start < window[0]:       # the profiler's start-up step
            continue
        call = corr if corr in calls else linked if linked in calls \
            else None
        kept.append((name, start, end, call))
    launched = {c for *_, c in kept if c is not None}
    at = {c: calls[c][0] for c in launched}
    stack = dict(zip(at, tr.stacks_at(list(at.values()))))
    for name, start, end, call in kept:
        t = at.get(call)
        tr.ops.append(SpanOp(name, start, end,
                             None if t is None else tr.range_at(t),
                             stack.get(call, ())))
    tr.launches = sorted(calls[c] for c in launched)
    return tr


# --------------------------------------------------------------------------
# readings, per traced step
# --------------------------------------------------------------------------

def _ms(ops) -> float:
    return 1e3 * sum(o.end_ns - o.start_ns for o in ops) / 1e9


def device_ms_per_step(tr: SpanTrace, names) -> float | None:
    """Device ms a step of the operations launched while any span of
    ``names`` was open (nested spans included)."""
    n = tr.steps()
    if n == 0:
        return None
    names = set(names)
    return _ms(o for o in tr.ops if names.intersection(o.spans)) / n


def head_loss_ms_per_step(tr: SpanTrace) -> float | None:
    """The head's and the f32 loss's forward and backward."""
    return device_ms_per_step(tr, HEAD_LOSS)


def remat_replay_ms_per_step(tr: SpanTrace) -> float | None:
    """The layers' forwards run again in the backward."""
    return device_ms_per_step(tr, (REMAT_REPLAY,))


def launches_per_step(tr: SpanTrace) -> float | None:
    """Runtime calls a step that enqueued device work inside ``rt/step``."""
    n = tr.steps()
    if n == 0:
        return None
    stacks = tr.stacks_at([t for t, _ in tr.launches])
    return sum(STEP in s for s in stacks) / n


def step_share(tr: SpanTrace) -> float | None:
    """The share of the operations' device time launched inside
    ``rt/step``."""
    total = _ms(tr.ops)
    if tr.steps() == 0 or total == 0:
        return None
    return _ms(o for o in tr.ops if STEP in o.spans) / total


def _innermost_segments(tr: SpanTrace) -> list:
    """[(start_ns, end_ns, innermost span or None)] covering the window,
    in order."""
    lo, hi = tr.window
    cuts = sorted({lo, hi} | {t for s, e, _ in tr.spans
                              for t in (s, e) if lo < t < hi})
    mids = [(a + b) // 2 for a, b in zip(cuts, cuts[1:])]
    return [(a, b, st[-1] if st else None) for a, b, st in
            zip(cuts, cuts[1:], tr.stacks_at(mids))]


def table(tr: SpanTrace) -> dict | None:
    """{span: {device_ms, device_ms_inclusive, launches, idle_ms}} a
    step.  ``device_ms``, ``launches`` and ``idle_ms`` go to the innermost
    span open at the launch, or while the device idled (an idle gap split
    where the host's innermost span changes); ``device_ms_inclusive``
    counts the operations launched anywhere under the span.  The key
    ``null`` holds what no span covers."""
    n = tr.steps()
    if n == 0:
        return None
    rows: dict = {}

    def row(name):
        return rows.setdefault(name, dict(device_ms=0.0,
                                          device_ms_inclusive=0.0,
                                          launches=0, idle_ms=0.0))
    for o in tr.ops:
        d = (o.end_ns - o.start_ns) / 1e6
        row(o.span)["device_ms"] += d
        for name in set(o.spans):
            row(name)["device_ms_inclusive"] += d
    for st in tr.stacks_at([t for t, _ in tr.launches]):
        row(st[-1] if st else None)["launches"] += 1
    segs = _innermost_segments(tr)
    j = 0
    for a, b in tr.gaps():
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            s, e, name = segs[k]
            row(name)["idle_ms"] += (min(b, e) - max(a, s)) / 1e6
            k += 1
    return {str(k): {m: v / n for m, v in r.items()}
            for k, r in sorted(rows.items(), key=lambda kv: str(kv[0]))}


def report(tr: SpanTrace, base: devtrace.Trace) -> dict:
    """The readings of one traced run, with the checks that tie them to
    the benchmark's own (``base``, as :func:`devtrace.read` read the same
    profile): the optimizer's device ms read from the program's span and
    from the benchmark's range, each layer's first forward against its
    replay, and the share of device time launched inside ``rt/step``."""
    n = tr.steps()
    opt_range = [o for o in base.ops if o.launched_in == "optimizer"]
    return dict(
        steps=n,
        head_loss_ms_per_step=head_loss_ms_per_step(tr),
        remat_replay_ms_per_step=remat_replay_ms_per_step(tr),
        launches_per_step=launches_per_step(tr),
        layer_ms_per_step=device_ms_per_step(tr, (PREFIX + "layer",)),
        optimizer_span_ms_per_step=device_ms_per_step(
            tr, (PREFIX + "optimizer",)),
        optimizer_range_ms_per_step=_ms(opt_range) / n if n else None,
        step_share=step_share(tr),
        ops=len(tr.ops), base_ops=len(base.ops), echoes=tr.echoes,
        busy_s=tr.busy_s, window_s=tr.window_s,
        idle_gaps=tr.breakdown()["idle_gaps"],
        table=table(tr))
