"""Plain-torch versions of the flash-attention kernel (mirrors
:mod:`repro.kernels.flash_attention.ref`, same [B,H,S,hd] layout), of the
log-sum-exp its ``wgmma`` route writes for the backward, and of its
gradient.

The CPU path runs them in place of the CUDA kernels, and ``chip_smoke.py``
holds both of the kernel's routes and both of its backward's against them
on the card.  The softmax
probabilities stay in f32 through the P·V product, as in the ``fma``
route; the ``wgmma`` route (bf16) rounds them to bf16 for the tensor
cores, within the bf16 tolerances.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _mask(sq: int, sk: int, causal: bool, window: int, device):
    """[Sq, Sk] bool: query row i sees key j (the reference's mask)."""
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= qpos - kpos < window
    return mask


def _logits(q: torch.Tensor, k: torch.Tensor, causal: bool,
            window: int) -> torch.Tensor:
    """f32 [B,H,Sq,Sk]: the scaled logits, masked ones NEG_INF."""
    b, h, sq, hd = q.shape
    _, kvh, sk, _ = k.shape
    kx = torch.repeat_interleave(k, h // kvh, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kx.float()) * hd ** -0.5
    if causal or window:
        s = torch.where(_mask(sq, sk, causal, window, q.device), s,
                        torch.full_like(s, NEG_INF))
    return s


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """q [B,H,Sq,hd], k/v [B,KV,Sk,hd]; query row i sees key j unless
    ``causal`` and j > i, or ``window`` is set and i - j >= window (the
    reference's ``_sdpa_naive`` mask; masked logits are NEG_INF)."""
    vx = torch.repeat_interleave(v, q.shape[1] // k.shape[1], dim=1)
    p = torch.softmax(_logits(q, k, causal, window), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vx.float()).to(q.dtype)


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *,
                      causal: bool = True, window: int = 0) -> torch.Tensor:
    """f32 [B,H,Sq]: each query row's log-sum-exp over its scaled logits,
    masked ones NEG_INF (the forward's ``lse``).  A row that sees no key
    gets NEG_INF + log Sk, which is NEG_INF in f32."""
    return torch.logsumexp(_logits(q, k, causal, window), dim=-1)


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


def attention_bwd_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          o: torch.Tensor, do: torch.Tensor,
                          lse: torch.Tensor, *, causal: bool = True,
                          window: int = 0) -> tuple:
    """The gradient of :func:`attention_ref` written out as the ``wgmma``
    backward computes it, from the forward's output ``o`` and log-sum-exp
    ``lse`` (f32 [B,H,Sq]): P = exp(s - lse) where row i sees key j, else
    0; D_i = dO_i·o_i; dS = P (dO·vᵀ - D) where seen, else 0; dq = scale
    dS k, dk = scale dSᵀ q and dv = Pᵀ dO, summed over a KV head's query
    heads.  A row that sees no key (i - (Sk - 1) >= window) has P = 1/Sk
    on every key and dS = 0 (``jnp.where`` over NEG_INF logits): its lse
    cannot say so, so its index does.  In f32, returned in q's dtype."""
    b, h, sq, hd = q.shape
    _, kvh, sk, _ = k.shape
    group = h // kvh
    scale = hd ** -0.5
    qf, of, dof = q.float(), o.float(), do.float()
    kx = torch.repeat_interleave(k.float(), group, dim=1)
    vx = torch.repeat_interleave(v.float(), group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kx) * scale
    seen = _mask(sq, sk, causal, window, q.device)
    p = torch.where(seen, torch.exp(s - lse.float()[..., None]), 0.0)
    if window:
        blind = torch.arange(sq, device=q.device) - (sk - 1) >= window
        p = torch.where(blind[:, None], 1.0 / sk, p)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vx)
    d = (dof * of).sum(-1, keepdim=True)
    ds = torch.where(seen, p * (dp - d), 0.0)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kx) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dk, dv = (g.view(b, kvh, group, sk, hd).sum(2) for g in (dk, dv))
    return tuple(g.to(q.dtype) for g in (dq, dk, dv))
