"""Plain-torch versions of the flash-attention kernel (mirrors
:mod:`repro.kernels.flash_attention.ref`, same [B,H,S,hd] layout) and of
its gradient.

The CPU path runs them in place of the CUDA kernels, and ``chip_smoke.py``
holds both of the kernel's routes and its backward against them on the
card.  The softmax
probabilities stay in f32 through the P·V product, as in the ``fma``
route; the ``wgmma`` route (bf16) rounds them to bf16 for the tensor
cores, within the bf16 tolerances.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """q [B,H,Sq,hd], k/v [B,KV,Sk,hd]; query row i sees key j unless
    ``causal`` and j > i, or ``window`` is set and i - j >= window (the
    reference's ``_sdpa_naive`` mask; masked logits are NEG_INF)."""
    b, h, sq, hd = q.shape
    _, kvh, sk, _ = k.shape
    group = h // kvh
    kx = torch.repeat_interleave(k, group, dim=1)
    vx = torch.repeat_interleave(v, group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kx.float()) * hd ** -0.5
    if causal or window:
        qpos = torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(sk, device=q.device)[None, :]
        mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= qpos >= kpos
        if window:
            mask &= qpos - kpos < window
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vx.float()).to(q.dtype)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      do: torch.Tensor, *, causal: bool = True,
                      window: int = 0) -> tuple:
    """The gradient of :func:`attention_ref` by autograd: (dq, dk, dv) of
    ``<attention_ref(q, k, v), do>``, in q's dtype.  A masked logit gets no
    gradient (``torch.where``, as ``jnp.where`` in the reference), and a
    row that sees no key spreads 1/Sk over every key's dV."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = attention_ref(*leaves, causal=causal, window=window)
        grads = torch.autograd.grad(out, leaves, do.to(out.dtype))
    return tuple(g.to(q.dtype) for g in grads)
