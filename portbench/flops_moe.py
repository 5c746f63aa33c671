"""The yardstick's arithmetic for a mixture-of-experts cell: a training
step's model FLOPs with its routed experts counted at their share, and
the grouped expert product's operations and bytes (``moe_gmm_*``).

Peaks and the bound of a call are :mod:`portbench.flops`'.  A
configuration's ``model`` names the routed experts' weights
(``expert_weights``, the experts this chip holds), ``n_experts`` (all of
the layer's, over every rank) and ``top_k``.
"""
from __future__ import annotations

from portbench import flops
from portbench.reference.moe import held


def model_flops_per_step(model: dict, shapes: dict, batch: int,
                         positions: int, loss_positions: int) -> float:
    """:func:`portbench.flops.model_flops_per_step` (attention, the shared
    expert and its gate, the router, the head over the positions that
    carry a loss, causal attention), plus the routed experts: 6 N a
    position for the held experts' weights N, times top_k / n_experts, a
    balanced router's share of them a token."""
    dense = flops.model_flops_per_step(model, shapes, batch, positions,
                                       loss_positions)
    experts = flops.product_weights(shapes, model["n_layers"],
                                    model["expert_weights"])
    return dense + 6.0 * experts * model["top_k"] / model["n_experts"] \
        * batch * positions


def expected_pairs(model: dict, tokens: int) -> float:
    """The (token, choice) pairs a layer's held experts take, on average:
    tokens · top_k · held / n_experts."""
    return tokens * model["top_k"] * held(model) / model["n_experts"]


def gmm_call(pairs: float, d: int, f: int, groups: int) -> dict:
    """Operations and bytes of one grouped product over ``pairs`` rows
    between widths d and f, in bf16, with ``groups`` experts' weights:
    2·pairs·d·f FLOPs; each operand read once and the result written once,
    (pairs·d + groups·d·f + pairs·f)·2 B.  Every product of the expert
    block has this count: gate, up and down forward, and the rows' and the
    weights' gradients of each in the backward (6·d·f a pair forward,
    12·d·f backward)."""
    return dict(flops=2.0 * pairs * d * f,
                bytes=2.0 * (pairs * d + groups * d * f + pairs * f))


def gmm_bound_s(call: dict) -> float:
    return flops.bound_s(call["flops"], call["bytes"], "bf16")
