"""The whole step's model FLOPs over the host clock's seconds of the
untraced window (the profiler's host cost slows a traced step), as a
share of the card's bf16 peak (989 TFLOP/s).  The count is
``flops.model_flops_per_step``: 6 N a position for every weight in a
product, the head's only over the positions that carry a loss, plus
causal attention; the rematerialised forward is not counted."""
from __future__ import annotations

from portbench import flops
from portbench.traffic import loss_positions

LAYER = "the whole step (models/, launch/train.py)"
UNIT = "%"
MOVES = "train_tokens_per_s"


def read(ctx):
    cell = ctx.cell
    if ctx.window_steps == 0 or ctx.window_s <= 0:
        return None
    per_step = flops.model_flops_per_step(
        cell.model, cell.reference.expected_shapes(cell.model),
        cell.traffic["batch"], cell.positions_per_row(),
        loss_positions(cell.traffic))
    return 100.0 * ctx.window_steps * per_step / ctx.window_s \
        / flops.PEAK_FLOPS["bf16"]
