"""Model-layout wrapper for the flash-attention kernel (the port of
:func:`repro.kernels.flash_attention.ops.flash_sdpa`).

The kernel takes strides, so the [B,S,H,hd] tensors are passed as
transposed views and the output is written in the model layout: no copy
on either side.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention


def flash_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [B,Sq,H,hd]; k,v: [B,Sk,KV,hd] (model layout) -> [B,Sq,H,hd]."""
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    causal=causal, window=window, out=out.transpose(1, 2))
    return out
