"""The grouped expert product (``kernels/moe_gmm``) against its roofline:
the sum of its launches' bounds over the sum of their device time, every
``moe_gmm_*`` kernel together (the forward's gate, up and down products,
in the first pass and the remat's replay, and the backward's rows' and
weights' gradients of each).  Each launch is one product over the pairs
its layer kept on the held experts in that step, P: 2·P·D·F FLOPs, its
operands read once (``flops_moe.gmm_call``).

P comes from the program under test, not from the benchmark: the
program's record of each layer's kept pairs, which it keeps on the device
while a profiler runs and hands over once, after the run
(``models/moe.py::take_counts``).  The traced steps' routing depends on
every weight update before them, which the benchmark cannot rebuild
without running the model again, and the Zipf tokens skew it far from
the expectation of 16,384 pairs a layer, either way, so an expectation
would read above 100% on some steps.  The traced steps are the last
``steps`` profiled ones, so their counts are the last ``steps · layers``.
A program without that record gives nothing to read."""
from __future__ import annotations

from portbench import flops_moe
from portbench.metrics._kernels import named, seconds
from portbench.reference.moe import held

LAYER = "expert block (models/moe.py, kernels/moe_gmm)"
UNIT = "%"
MOVES = "train_tokens_per_s"


def _profiled_pairs() -> list:
    """Each layer's kept pairs of each profiled forward, oldest first;
    empty for a program that keeps no such record."""
    try:
        from repro_torch.models import moe
    except ImportError:
        return []
    take = getattr(moe, "take_counts", None)
    return [c[0] for c in take()] if take else []


def read(ctx):
    pairs = _profiled_pairs()
    ops = named(ctx.trace.ops, r"moe_gmm_\w+")
    m = ctx.cell.model
    if not ops or "moe_d_ff" not in m or ctx.steps == 0:
        return None
    layer_steps = ctx.steps * m["n_layers"]
    if len(pairs) < layer_steps:
        return None
    pairs = pairs[-layer_steps:]
    bound = sum(flops_moe.gmm_bound_s(flops_moe.gmm_call(
        p, m["d_model"], m["moe_d_ff"], held(m))) for p in pairs)
    # every layer-step launches the same products: len(ops) / len(pairs)
    return 100.0 * bound * len(ops) / len(pairs) / seconds(ops)
