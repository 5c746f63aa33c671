"""K3 (the WKV6 recurrence) against its roofline: the sum of its calls'
bounds over the sum of their device time, forward (``wkv6_kernel``) and
backward (``wkv6_bwd_kernel``) together, at the cell's shape [B, T, H, N]
in float32 (``flops.k3_call``)."""
from __future__ import annotations

from portbench import flops
from portbench.metrics._kernels import named, seconds

LAYER = "WKV6 (kernels/rwkv_scan)"
UNIT = "%"
MOVES = "train_tokens_per_s"


def read(ctx):
    fwd = named(ctx.trace.ops, "wkv6_kernel")
    bwd = named(ctx.trace.ops, "wkv6_bwd_kernel")
    wkv = ctx.cell.model.get("wkv")
    if not (fwd or bwd) or not wkv:
        return None
    call = flops.k3_call(ctx.cell.traffic["batch"], wkv["heads"],
                         ctx.cell.traffic["seq"], wkv["head_size"])
    fb, bb = flops.k3_bounds(call)
    return 100.0 * (len(fwd) * fb + len(bwd) * bb) / seconds(fwd + bwd)
