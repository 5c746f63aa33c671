"""K2 (flash attention, bf16 on the tensor cores) against its roofline:
the sum of its calls' bounds over the sum of their device time, the
forward (``flash_wgmma_kernel``) and the backward's three kernels
(``fa_bwd_dot``, ``fa_bwd_dkdv_wgmma``, ``fa_bwd_dq_wgmma``; a backward
call is one ``fa_bwd_dkdv_wgmma``) together, at the cell's causal
self-attention shape over every position, prefix included
(``flops.k2_call``)."""
from __future__ import annotations

from portbench import flops
from portbench.metrics._kernels import named, seconds

LAYER = "attention (models/attention.py, kernels/flash_attention)"
UNIT = "%"
MOVES = "train_tokens_per_s.vlm"


def read(ctx):
    ops = ctx.trace.ops
    fwd = named(ops, "flash_wgmma_kernel")
    bwd = named(ops, "fa_bwd_dot") + named(ops, "fa_bwd_dkdv_wgmma") \
        + named(ops, "fa_bwd_dq_wgmma")
    att = ctx.cell.model.get("attention")
    if not (fwd or bwd) or not att:
        return None
    s = ctx.cell.positions_per_row()
    call = flops.k2_call(ctx.cell.traffic["batch"], att["heads"],
                         att["kv_heads"], s, att["head_dim"], att["causal"])
    fb, bb = flops.k2_bounds(call)
    n_bwd = len(named(ops, "fa_bwd_dkdv_wgmma"))
    return 100.0 * (len(fwd) * fb + n_bwd * bb) / seconds(fwd + bwd)
