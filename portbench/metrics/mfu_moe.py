"""The whole step's model FLOPs over the host clock's seconds of the
untraced window, as a share of the card's bf16 peak (989 TFLOP/s), for a
cell with routed experts.  The count is ``flops_moe.model_flops_per_step``:
attention, the shared expert and its gate, the router, the head over the
positions that carry a loss and causal attention as ``flops`` counts them,
and the held experts' weights at top_k / n_experts a token, which is what
a balanced router gives; the rematerialised forward is not counted."""
from __future__ import annotations

from portbench import flops, flops_moe
from portbench.traffic import loss_positions

LAYER = "the whole step (models/, launch/train.py)"
UNIT = "%"
MOVES = "train_tokens_per_s"


def read(ctx):
    cell = ctx.cell
    if "expert_weights" not in cell.model or ctx.window_steps == 0 \
            or ctx.window_s <= 0:
        return None
    per_step = flops_moe.model_flops_per_step(
        cell.model, cell.reference.expected_shapes(cell.model),
        cell.traffic["batch"], cell.positions_per_row(),
        loss_positions(cell.traffic))
    return 100.0 * ctx.window_steps * per_step / ctx.window_s \
        / flops.PEAK_FLOPS["bf16"]
