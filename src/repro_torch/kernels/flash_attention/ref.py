"""Plain-torch version of the flash-attention kernel (mirrors
:mod:`repro.kernels.flash_attention.ref`, same [B,H,S,hd] layout).

The CPU path runs it in place of the CUDA kernels, and ``chip_smoke.py``
holds both of the kernel's routes against it on the card.  The softmax
probabilities stay in f32 through the P·V product, as in the ``fma``
route; the ``wgmma`` route (bf16) rounds them to bf16 for the tensor
cores, within the bf16 tolerances.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    b, h, sq, hd = q.shape
    _, kvh, sk, _ = k.shape
    group = h // kvh
    kx = torch.repeat_interleave(k, group, dim=1)
    vx = torch.repeat_interleave(v, group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kx.float()) * hd ** -0.5
    if causal:
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vx.float()).to(q.dtype)
