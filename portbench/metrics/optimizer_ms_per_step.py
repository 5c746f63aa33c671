"""Device milliseconds a step of the operations launched inside
``optim/adamw.py::update`` (the benchmark's ``optimizer`` range around
it, in the traced run only)."""
from __future__ import annotations

from portbench.metrics._kernels import seconds

LAYER = "optimizer (optim/adamw.py)"
UNIT = "ms"
MOVES = "train_tokens_per_s"


def read(ctx):
    ops = [o for o in ctx.trace.ops if o.launched_in == "optimizer"]
    if not ops or ctx.steps == 0:
        return None
    return 1e3 * seconds(ops) / ctx.steps
