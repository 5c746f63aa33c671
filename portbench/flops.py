"""The yardstick's arithmetic: the card's peaks, a training step's model
FLOPs, and the operations and bytes of each hand-written kernel's call,
worked out from shapes.

Peaks are NVIDIA's for one H100 SXM at 700 W, dense: 989 TFLOP/s in
bf16 on the tensor cores, 67 TFLOP/s in float32 outside them, 3.35 TB/s
of HBM.  A call's bound is the larger of its operations at the peak for
its dtype and its bytes at the HBM rate; the bytes count each input read
once and each output written once, and the operations what the equations
need, whatever a kernel recomputes.
"""
from __future__ import annotations

import fnmatch
import math

PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


# --------------------------------------------------------------------------
# model FLOPs
# --------------------------------------------------------------------------

def product_weights(shapes: dict, n_layers: int, patterns: list) -> int:
    """Weights that take part in a product: the parts of every path that
    matches one of ``patterns`` (a stacked ``layers.*`` path counts once a
    layer); embedding lookups are left out by not being listed."""
    n = 0
    for path, shape in shapes.items():
        if any(fnmatch.fnmatchcase(path, p) for p in patterns):
            n += math.prod(shape) * (n_layers if path.startswith("layers.")
                                     else 1)
    return n


def model_flops_per_step(model: dict, shapes: dict, batch: int,
                         positions: int, loss_positions: int) -> float:
    """A training step's model FLOPs: 6 N a position (forward and
    backward) for every weight of ``product_weights`` over all
    ``batch * positions`` positions, 6 N a position for the head's
    (``head_weights``) over the ``loss_positions`` that carry a loss
    only, and, with attention, 12 L H hd S a position over all positions,
    halved when causal; ``positions`` is S, a row's length.  The
    recomputed forward is not counted."""
    n = product_weights(shapes, model["n_layers"], model["product_weights"])
    head = product_weights(shapes, model["n_layers"], model["head_weights"])
    flops = 6.0 * n * batch * positions + 6.0 * head * loss_positions
    att = model.get("attention")
    if att:
        per = 12.0 * att["layers"] * att["heads"] * att["head_dim"] \
            * positions
        flops += (per / 2 if att["causal"] else per) * batch * positions
    return flops


# --------------------------------------------------------------------------
# K2: flash attention, bf16
# --------------------------------------------------------------------------

def k2_call(b: int, h: int, kv: int, s: int, hd: int, causal: bool) -> dict:
    """Operations and bytes of one forward and one backward call of K2 in
    bf16 self-attention over ``s`` positions: 4 hd FLOPs a (query, key)
    pair forward (Q K^T, P V), 8 hd backward (dV, dP, dQ, dK), counting
    only the s (s + 1) / 2 pairs a causal mask admits; the forward reads
    q, k, v and writes o and its float32 log-sum-exp; the backward reads
    q, k, v, o, dO, the log-sum-exp and writes dq, dk, dv."""
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    q = b * h * s * hd * 2
    kvb = b * kv * s * hd * 2
    lse = b * h * s * 4
    return dict(fwd_flops=4.0 * hd * pairs, bwd_flops=8.0 * hd * pairs,
                fwd_bytes=q + 2 * kvb + q + lse,
                bwd_bytes=(q + 2 * kvb + 2 * q + lse) + (q + 2 * kvb))


def k2_bounds(call: dict) -> tuple:
    """(forward, backward) bound seconds of a :func:`k2_call`."""
    return (bound_s(call["fwd_flops"], call["fwd_bytes"], "bf16"),
            bound_s(call["bwd_flops"], call["bwd_bytes"], "bf16"))


# --------------------------------------------------------------------------
# K3: the WKV6 recurrence, float32
# --------------------------------------------------------------------------

def k3_call(b: int, h: int, t: int, n: int) -> dict:
    """Operations and bytes of one forward and one backward call of K3 in
    float32, per (token, head): forward 2 N^2 for S^T r and 3 N^2 for
    S <- diag(w) S + k v^T; backward 2 N^2 for dr, 3 N^2 for the state's
    gradient, 2 N^2 each for dk, dv and dw.  The forward reads r, k, v, w
    [B, T, H, N] and u [H, N] and writes o; the backward also reads dO and
    writes dr, dk, dv, dw and du."""
    th = b * t * h
    x = th * n * 4
    u = h * n * 4
    return dict(fwd_flops=5.0 * n * n * th, bwd_flops=11.0 * n * n * th,
                fwd_bytes=4 * x + u + x,
                bwd_bytes=(5 * x + u) + (4 * x + u))


def k3_bounds(call: dict) -> tuple:
    return (bound_s(call["fwd_flops"], call["fwd_bytes"], "f32"),
            bound_s(call["bwd_flops"], call["bwd_bytes"], "f32"))
