"""Model-layout wrapper for the flash-attention kernel (the port of
:func:`repro.kernels.flash_attention.ops.flash_sdpa`), with its gradient.

The kernel takes strides, so the [B,S,H,hd] tensors are passed as
transposed views and the output is written in the model layout: no copy
on either side.  When a gradient is wanted, :class:`FlashAttention` runs
the same forward launch, also writing each row's log-sum-exp where the
backward's ``wgmma`` route reads it, and for the backward
:func:`~repro_torch.kernels.flash_attention.kernel.flash_attention_bwd`
(the backward kernels on a CUDA tensor, their plain versions on a CPU
tensor); without one (the serving paths, under ``inference_mode``) no
autograd node is made and no log-sum-exp written.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import (_bwd_route,
                                                        flash_attention,
                                                        flash_attention_bwd)


def _heads_first(*ts):
    """[B,S,H,hd] views as [B,H,S,hd]."""
    return tuple(t.transpose(1, 2) for t in ts)


def _forward(q, k, v, causal: bool, window: int,
             lse: torch.Tensor | None = None) -> torch.Tensor:
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    flash_attention(*_heads_first(q, k, v), causal=causal, window=window,
                    out=out.transpose(1, 2), lse=lse)
    return out


class FlashAttention(torch.autograd.Function):
    """o = attention(q, k, v) in the model layout; the backward is K2's
    backward kernels (dq, dk, dv in the input dtype), from the forward's
    log-sum-exp on their ``wgmma`` route."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        b, sq, h, hd = q.shape
        lse = None
        if _bwd_route(q.dtype, hd, window) == "wgmma":
            lse = torch.empty((b, h, sq), dtype=torch.float32,
                              device=q.device)
        out = _forward(q, k, v, causal, window, lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        # the wgmma route reads dO with TMA: 16-byte strides
        do = do.to(q.dtype).contiguous()
        grads = tuple(torch.empty(t.shape, dtype=q.dtype, device=q.device)
                      for t in (q, k, v))
        flash_attention_bwd(*_heads_first(q, k, v, out, do),
                            causal=ctx.causal, window=ctx.window,
                            grads=_heads_first(*grads), lse=lse)
        return (*grads, None, None)


def flash_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [B,Sq,H,hd]; k,v: [B,Sk,KV,hd] (model layout) -> [B,Sq,H,hd]."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window)
    return _forward(q, k, v, causal, window)
