"""The share of a step in which no operation runs on the device:
1 - (the device's busy time a traced step: the union of its operations'
intervals over the traced steps) / (a step's host-clock time in the
untraced window).  The profiler's host cost lengthens a traced step and
leaves the device's operations as they are, so the busy time is taken
from the trace and the step's length from the window without it."""
from __future__ import annotations

LAYER = "device"
UNIT = "%"
MOVES = "train_tokens_per_s"


def read(ctx):
    tr = ctx.trace
    if not tr.ops or ctx.steps == 0 or ctx.window_steps == 0:
        return None
    busy = tr.busy_s / ctx.steps
    return 100.0 * (1.0 - busy * ctx.window_steps / ctx.window_s)
