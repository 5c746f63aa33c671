"""Gradient compression for cross-pod all-reduce.  The port of
:mod:`repro.optim.compression`.

``int8``: per-tensor symmetric quantization with an fp32 scale,
dequantized immediately after (on one device this is the round trip the
reference's all-reduce would carry).  ``torch.round``, like
``jnp.round``, rounds half to even, so the round trip equals the
reference's bit for bit in f32.
"""
from __future__ import annotations

import torch


def _int8_qdq(g: torch.Tensor) -> torch.Tensor:
    if g.dtype == torch.int32 or g.ndim == 0:
        return g
    g32 = g.float()
    scale = torch.clamp(g32.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return (q.float() * scale).to(g.dtype)


def _map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def compress_grads(grads, method: str):
    """``grads`` (a tensor, or a list, tuple or dict of them) through the
    compression ``method``: ``none`` or ``int8``."""
    if method == "none":
        return grads
    if method == "int8":
        return _map(_int8_qdq, grads)
    raise ValueError(f"unknown compression: {method}")
