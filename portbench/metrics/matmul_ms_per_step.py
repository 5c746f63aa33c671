"""Device milliseconds a step in the products' kernels (cuBLAS and
CUTLASS, found by name), the port's own kernels left out."""
from __future__ import annotations

from portbench.metrics._kernels import GEMM, OWN, seconds

LAYER = "products (cuBLAS and CUTLASS under models/)"
UNIT = "ms"
MOVES = "train_tokens_per_s"


def read(ctx):
    ops = [o for o in ctx.trace.ops
           if GEMM.search(o.name) and not OWN.search(o.name)]
    if not ops or ctx.steps == 0:
        return None
    return 1e3 * seconds(ops) / ctx.steps
