"""Grouped-query attention: full-sequence (causal, full or windowed;
prefill, forward, encoder and cross attention) and decode.  The port of
:mod:`repro.models.attention`.

Shapes follow the [batch, seq, heads, head_dim] convention.
:func:`_sdpa_train` is the flash-attention kernel
(:func:`repro_torch.kernels.flash_attention.ops.flash_sdpa`): on a CUDA
tensor it launches a hand-written CUDA kernel, on a CPU tensor it runs
the kernel's plain version.  The plain version and the f32 (FMA) kernel
keep the softmax probabilities in f32 through the P·V product, like the
reference's kernel and its chunked jnp twin; in bf16 at head dims 64 and
128 the card's tensor-core (``wgmma``) kernel rounds them to bf16 for the
product, as the reference's ``naive`` form does, with m, l and the
accumulator in f32.  Decode attention is plain PyTorch, as the reference
computes it outside any kernel.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.kernels.flash_attention.ops import flash_sdpa
from repro_torch.models.common import (ArchConfig, apply_rope, dense_init,
                                       param)

NEG_INF = -1e30


class AttnParams(nn.Module):
    """wq [D,H,hd], wk/wv [D,KV,hd], wo [H,hd,D] (the reference's shapes)."""

    def __init__(self, wq, wk, wv, wo):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = (param(t) for t in
                                              (wq, wk, wv, wo))


def init_attn(gen: torch.Generator, cfg: ArchConfig, dtype=None,
              device=None) -> AttnParams:
    dtype = dtype or cfg.dtype
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    init = lambda shape: dense_init(gen, shape, in_axis=0, dtype=dtype,
                                    device=device)
    return AttnParams(wq=init((d, h, hd)), wk=init((d, kv, hd)),
                      wv=init((d, kv, hd)), wo=init((h, hd, d)))


def _group_heads(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """[B,S,H,hd] -> [B,S,KV,G,hd] grouping query heads per KV head."""
    b, s, h, hd = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, hd)


def _sdpa_train(q, k, v, *, causal: bool, window: int = 0,
                q_offset: int = 0):
    """q: [B,Sq,H,hd]; k,v: [B,Sk,KV,hd] -> [B,Sq,H,hd].  No model
    calls it with a query offset, so K2 takes none and a non-zero one
    raises."""
    if q_offset:
        raise ValueError(f"q_offset {q_offset}: the attention kernel takes "
                         "no query offset")
    return flash_sdpa(q, k, v, causal=causal, window=window)


def _qkv(params: AttnParams, x: torch.Tensor):
    q = torch.einsum("bsd,dhk->bshk", x, params.wq)
    k = torch.einsum("bsd,dhk->bshk", x, params.wk)
    v = torch.einsum("bsd,dhk->bshk", x, params.wv)
    return q, k, v


def attention_train(params: AttnParams, x: torch.Tensor, cfg: ArchConfig,
                    *, causal: bool = True, window: int = 0,
                    pos: Optional[torch.Tensor] = None,
                    use_rope: bool = True) -> torch.Tensor:
    b, s, _ = x.shape
    q, k, v = _qkv(params, x)
    if use_rope:
        if pos is None:
            pos = torch.arange(s, device=x.device).expand(b, s)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    o = _sdpa_train(q, k, v, causal=causal, window=window)
    return torch.einsum("bshk,hkd->bsd", o, params.wo)


def cross_attention(params: AttnParams, x: torch.Tensor,
                    kv_src: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Encoder-decoder cross attention (no mask, no rope): queries from
    ``x`` [B,Sq,D], keys and values from ``kv_src`` [B,Sk,D]."""
    q = torch.einsum("bsd,dhk->bshk", x, params.wq)
    k = torch.einsum("bsd,dhk->bshk", kv_src, params.wk)
    v = torch.einsum("bsd,dhk->bshk", kv_src, params.wv)
    o = _sdpa_train(q, k, v, causal=False)
    return torch.einsum("bshk,hkd->bsd", o, params.wo)


class KVCache(NamedTuple):
    """Decode-time KV cache for one attention layer (or stacked [L, ...])."""
    k: torch.Tensor      # [B, S_max, KV, hd]
    v: torch.Tensor      # [B, S_max, KV, hd]

    @staticmethod
    def init(cfg: ArchConfig, batch: int, s_max: int, dtype=None,
             layers: Optional[int] = None, device=None) -> "KVCache":
        dtype = dtype or cfg.dtype
        shape = (batch, s_max, cfg.n_kv_heads, cfg.hd)
        if layers is not None:
            shape = (layers,) + shape
        return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                       v=torch.zeros(shape, dtype=dtype, device=device))


def attention_decode(params: AttnParams, x: torch.Tensor, cache: KVCache,
                     pos: int, cfg: ArchConfig, *, window: int = 0,
                     use_rope: bool = True):
    """One-token decode step.  x: [B, 1, D]; pos: the current position.

    Returns (out [B,1,D], cache).  The new K/V is written into ring slot
    ``pos % s_max`` of ``cache`` in place (the reference returns an
    updated copy; the values are the same).  With ``window`` the keys
    ``window`` or more positions back are masked.
    """
    b = x.shape[0]
    q, k, v = _qkv(params, x)
    if use_rope:
        p = torch.full((b, 1), pos, device=x.device)
        q = apply_rope(q, p, cfg.rope_theta)
        k = apply_rope(k, p, cfg.rope_theta)
    s_max = cache.k.shape[1]
    slot = pos % s_max
    cache.k[:, slot] = k[:, 0]
    cache.v[:, slot] = v[:, 0]

    kvh = cache.k.shape[2]
    qg = _group_heads(q, kvh)                               # [B,1,KV,G,hd]
    scale = cfg.hd ** -0.5
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg.float(),
                          cache.k.float()) * scale
    # ring-buffer aware positions: slot j holds absolute position
    # pos - ((pos - j) mod s_max) (floor mod); entries "from the future"
    # are invalid.
    kpos = torch.arange(s_max, device=x.device)
    abs_pos = pos - torch.remainder(pos - kpos, s_max)
    valid = abs_pos >= 0
    if window:
        valid &= abs_pos > pos - window
    logits = torch.where(valid, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    o = torch.einsum("bkgqs,bskh->bqkgh", probs, cache.v)
    o = o.reshape(b, 1, cfg.n_heads, cfg.hd)
    out = torch.einsum("bshk,hkd->bsd", o, params.wo)
    return out, cache
