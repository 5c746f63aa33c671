"""Model-layout wrapper for the flash-attention kernel (the port of
:func:`repro.kernels.flash_attention.ops.flash_sdpa`), with its gradient.

The kernel takes strides, so the [B,S,H,hd] tensors are passed as
transposed views and the output is written in the model layout: no copy
on either side.  When a gradient is wanted, :class:`FlashAttention` runs
the same forward launch and, for the backward,
:func:`~repro_torch.kernels.flash_attention.kernel.flash_attention_bwd`
(the backward kernel on a CUDA tensor, the plain version's autograd on a
CPU tensor); without one (the serving paths, under ``inference_mode``) no
autograd node is made.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import (flash_attention,
                                                        flash_attention_bwd)


def _heads_first(*ts):
    """[B,S,H,hd] views as [B,H,S,hd]."""
    return tuple(t.transpose(1, 2) for t in ts)


def _forward(q, k, v, causal: bool, window: int) -> torch.Tensor:
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    flash_attention(*_heads_first(q, k, v), causal=causal, window=window,
                    out=out.transpose(1, 2))
    return out


class FlashAttention(torch.autograd.Function):
    """o = attention(q, k, v) in the model layout; the backward is K2's
    backward kernel (dq, dk, dv in the input dtype)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        out = _forward(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        grads = tuple(torch.empty(t.shape, dtype=q.dtype, device=q.device)
                      for t in (q, k, v))
        flash_attention_bwd(*_heads_first(q, k, v, out, do.to(q.dtype)),
                            causal=ctx.causal, window=ctx.window,
                            grads=_heads_first(*grads))
        return (*grads, None, None)


def flash_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [B,Sq,H,hd]; k,v: [B,Sk,KV,hd] (model layout) -> [B,Sq,H,hd]."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window)
    return _forward(q, k, v, causal, window)
