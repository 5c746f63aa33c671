"""RecurrentGemma / Griffin (arXiv:2402.19427): RG-LRU recurrent blocks
interleaved with local (sliding-window) attention at a 1:2 ratio.  The
port of :mod:`repro.models.rglru`.

Layers follow the repeating super-block (recurrent, recurrent,
local-attn); ``n_layers % 3`` leftover recurrent blocks form the tail.
The RG-LRU recurrence ``h_t = a_t h_{t-1} + sqrt(1-a_t^2) (i_t x_t)`` is a
linear recurrence: the full-sequence path scans it in f32 with a
log-depth doubling scan of whole-tensor ops (:func:`_rglru_scan`, 12
steps at S = 4096; the reference's ``jax.lax.associative_scan``, which no
Pallas kernel computes); decode keeps an O(1) state.  The local attention
of the full-sequence path is the flash-attention kernel with a window
(``cfg.window``), once per super-block; windowed decode attention is plain
PyTorch over a ring of ``window`` slots.  ``jax.nn.gelu`` is the tanh
approximation, so the port's GELU is ``approximate="tanh"``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import attention as A
from repro_torch.models.common import (ArchConfig, cross_entropy, dense_init,
                                       embed_init, param, rms_norm,
                                       tensor_from_numpy)

LRU_C = 8.0   # Griffin's fixed exponent scale


class GLUParams(nn.Module):
    """w_gate, w_up [D,F]; w_down [F,D]."""

    def __init__(self, w_gate, w_up, w_down):
        super().__init__()
        self.w_gate, self.w_up, self.w_down = (param(t) for t in
                                               (w_gate, w_up, w_down))


#: A recurrent block's own weights in the reference's order (``mlp``, a
#: :class:`GLUParams`, comes last): ln [D]; w_x, w_y [D,R]; conv_w [W,R]
#: (depthwise causal conv); conv_b [R]; lam [R] (f32, RG-LRU Λ); w_a, w_i
#: [R,R] and b_a, b_i [R] (recurrence and input gates); w_o [R,D];
#: ln_mlp [D].
REC_FIELDS = ("ln", "w_x", "w_y", "conv_w", "conv_b", "lam", "w_a", "b_a",
              "w_i", "b_i", "w_o", "ln_mlp")


class RecurrentBlock(nn.Module):
    def __init__(self, mlp: GLUParams, **weights):
        super().__init__()
        for name in REC_FIELDS:
            setattr(self, name, param(weights[name]))
        self.mlp = mlp


class AttnBlock(nn.Module):
    def __init__(self, ln, attn: A.AttnParams, ln_mlp, mlp: GLUParams):
        super().__init__()
        self.ln = param(ln)
        self.attn = attn
        self.ln_mlp = param(ln_mlp)
        self.mlp = mlp


class SuperBlock(nn.Module):
    def __init__(self, rec1: RecurrentBlock, rec2: RecurrentBlock,
                 attn: AttnBlock):
        super().__init__()
        self.rec1, self.rec2, self.attn = rec1, rec2, attn


class GriffinParams(nn.Module):
    """embed [V,D] (also the output head); supers; tail (``max(n_tail,
    1)`` recurrent blocks, as the reference stacks them: without leftover
    layers the one block is never run); ln_f [D]."""

    def __init__(self, embed, supers, tail, ln_f):
        super().__init__()
        self.embed = param(embed)
        self.supers = nn.ModuleList(supers)
        self.tail = nn.ModuleList(tail)
        self.ln_f = param(ln_f)


def n_super(cfg: ArchConfig) -> int:
    return cfg.n_layers // 3


def n_tail(cfg: ArchConfig) -> int:
    return cfg.n_layers % 3


def _init_glu(gen, d, f, dt, device) -> GLUParams:
    init = lambda shape: dense_init(gen, shape, in_axis=0, dtype=dt,
                                    device=device)
    return GLUParams(init((d, f)), init((d, f)), init((f, d)))


def _init_rec(gen, cfg: ArchConfig, device) -> RecurrentBlock:
    d, dt = cfg.d_model, cfg.dtype
    r = cfg.rg_lru_width or d
    init = lambda shape: dense_init(gen, shape, in_axis=0, dtype=dt,
                                    device=device)
    zeros = lambda n: torch.zeros((n,), dtype=dt, device=device)
    return RecurrentBlock(
        ln=zeros(d), w_x=init((d, r)), w_y=init((d, r)),
        conv_w=init((cfg.conv_width, r)), conv_b=zeros(r),
        lam=torch.full((r,), 2.0, dtype=torch.float32, device=device),
        w_a=init((r, r)), b_a=zeros(r), w_i=init((r, r)), b_i=zeros(r),
        w_o=init((r, d)), ln_mlp=zeros(d),
        mlp=_init_glu(gen, d, cfg.d_ff, dt, device))


def _init_attn_block(gen, cfg: ArchConfig, device) -> AttnBlock:
    zeros = lambda: torch.zeros((cfg.d_model,), dtype=cfg.dtype,
                                device=device)
    return AttnBlock(zeros(), A.init_attn(gen, cfg, device=device), zeros(),
                     _init_glu(gen, cfg.d_model, cfg.d_ff, cfg.dtype,
                               device))


def init_griffin(gen: torch.Generator, cfg: ArchConfig,
                 device=None) -> GriffinParams:
    """Random weights drawn from ``gen``, each placed on ``device``.  The
    draws differ from the reference's ``jax.random``;
    :func:`params_from_numpy` carries the reference's own weights
    across."""
    embed = embed_init(gen, (cfg.vocab, cfg.d_model), cfg.dtype, device)
    supers = [SuperBlock(_init_rec(gen, cfg, device),
                         _init_rec(gen, cfg, device),
                         _init_attn_block(gen, cfg, device))
              for _ in range(n_super(cfg))]
    tail = [_init_rec(gen, cfg, device)
            for _ in range(max(n_tail(cfg), 1))]
    return GriffinParams(embed, supers, tail,
                         torch.zeros((cfg.d_model,), dtype=cfg.dtype,
                                     device=device))


def params_from_numpy(tree, cfg: ArchConfig, device=None) -> GriffinParams:
    """The reference's ``GriffinParams`` as nested numpy arrays (super-
    blocks and tail stacked on a leading axis) as the port's module: same
    values, same dtypes, same shapes per block."""
    t = lambda a: tensor_from_numpy(a, device)
    glu = lambda p, i: GLUParams(t(p.w_gate[i]), t(p.w_up[i]),
                                 t(p.w_down[i]))
    rec = lambda p, i: RecurrentBlock(
        glu(p.mlp, i), **{name: t(getattr(p, name)[i])
                          for name in REC_FIELDS})
    sp = tree.supers
    supers = [SuperBlock(rec(sp.rec1, i), rec(sp.rec2, i), AttnBlock(
        t(sp.attn.ln[i]),
        A.AttnParams(t(sp.attn.attn.wq[i]), t(sp.attn.attn.wk[i]),
                     t(sp.attn.attn.wv[i]), t(sp.attn.attn.wo[i])),
        t(sp.attn.ln_mlp[i]), glu(sp.attn.mlp, i)))
        for i in range(n_super(cfg))]
    tail = [rec(tree.tail, i) for i in range(max(n_tail(cfg), 1))]
    return GriffinParams(t(tree.embed), supers, tail, t(tree.ln_f))


def _glu(p: GLUParams, x):
    h = torch.einsum("bsd,df->bsf", x, p.w_gate)
    u = torch.einsum("bsd,df->bsf", x, p.w_up)
    return torch.einsum("bsf,fd->bsd", F.gelu(h, approximate="tanh") * u,
                        p.w_down)


# --------------------------------------------------------------------------
# RG-LRU
# --------------------------------------------------------------------------

def _rglru_scan(a: torch.Tensor, b: torch.Tensor, h0=None) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along axis 1 (f32), by recursive doubling:
    after the step of shift d, element t holds the composition of the
    (up to) 2d steps ending at t, ``(a, b) <- (a_{t-d} a_t, a_t b_{t-d} +
    b_t)``, so ceil(log2 S) steps of whole-tensor ops give every prefix.
    The same associative combine as the reference's
    ``jax.lax.associative_scan``, grouped otherwise (f32 rounding only)."""
    if h0 is not None:
        # fold the carried state into the first step
        b = b.clone()
        b[:, 0] += a[:, 0] * h0
    s = a.shape[1]
    d = 1
    while d < s:
        b = torch.cat([b[:, :d], torch.addcmul(b[:, d:], a[:, d:],
                                               b[:, :-d])], dim=1)
        if 2 * d < s:
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def _gates(p: RecurrentBlock, c: torch.Tensor):
    """The RG-LRU's decay a (f32) and gated input (f32) from the conv
    output ``c``."""
    r = torch.sigmoid(c @ p.w_a + p.b_a).float()
    i = torch.sigmoid(c @ p.w_i + p.b_i)
    softplus = torch.logaddexp(p.lam, torch.zeros_like(p.lam))
    log_a = -LRU_C * softplus * r                       # fp32
    a = torch.exp(log_a)
    gated = (torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                    min=1e-12))
             * (i * c).float())
    return a, gated


def _rec_train(p: RecurrentBlock, x: torch.Tensor) -> torch.Tensor:
    """x: [B,S,D] -> [B,S,D]; full-sequence recurrent branch."""
    xb = torch.einsum("bsd,dr->bsr", x, p.w_x)
    yb = torch.einsum("bsd,dr->bsr", x, p.w_y)
    # causal depthwise conv (width W): tap i reads the input i steps back
    w = p.conv_w
    s = xb.shape[1]
    c = 0
    for i in range(w.shape[0]):
        shifted = F.pad(xb, (0, 0, i, 0))[:, :s]
        c = c + shifted * w[w.shape[0] - 1 - i][None, None, :]
    c = c + p.conv_b
    a, gated = _gates(p, c)
    h = _rglru_scan(a, gated)
    out = h.to(x.dtype) * F.gelu(yb, approximate="tanh")
    return torch.einsum("bsr,rd->bsd", out, p.w_o)


class RecState(NamedTuple):
    conv: torch.Tensor     # [B, W-1, R] last inputs
    h: torch.Tensor        # [B, R] fp32


def _rec_decode(p: RecurrentBlock, x: torch.Tensor, st: RecState):
    """x: [B,1,D] one token -> ([B,1,D], the next state)."""
    xb = torch.einsum("bsd,dr->bsr", x, p.w_x)[:, 0]   # [B,R]
    yb = torch.einsum("bsd,dr->bsr", x, p.w_y)[:, 0]
    hist = torch.cat([st.conv, xb[:, None]], dim=1)     # [B,W,R]
    c = torch.einsum("bwr,wr->br", hist, p.conv_w) + p.conv_b
    a, gated = _gates(p, c)
    h = a * st.h + gated
    out = (h.to(x.dtype) * F.gelu(yb, approximate="tanh")) @ p.w_o
    return out[:, None], RecState(conv=hist[:, 1:], h=h)


# --------------------------------------------------------------------------
# full model
# --------------------------------------------------------------------------

def _rec_block_train(p: RecurrentBlock, x, cfg: ArchConfig):
    x = x + _rec_train(p, rms_norm(x, p.ln, cfg.norm_eps))
    return x + _glu(p.mlp, rms_norm(x, p.ln_mlp, cfg.norm_eps))


def _attn_block_train(p: AttnBlock, x, cfg: ArchConfig):
    x = x + A.attention_train(p.attn, rms_norm(x, p.ln, cfg.norm_eps), cfg,
                              causal=True, window=cfg.window)
    return x + _glu(p.mlp, rms_norm(x, p.ln_mlp, cfg.norm_eps))


def _logits(params: GriffinParams, x, cfg: ArchConfig):
    x = rms_norm(x, params.ln_f, cfg.norm_eps)
    return torch.einsum("...d,dv->...v", x, params.embed.T.to(cfg.dtype))


@torch.inference_mode()
def forward(params: GriffinParams, tokens: torch.Tensor,
            cfg: ArchConfig) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, V]."""
    x = params.embed[tokens].to(cfg.dtype)
    for sb in params.supers:
        x = _rec_block_train(sb.rec1, x, cfg)
        x = _rec_block_train(sb.rec2, x, cfg)
        x = _attn_block_train(sb.attn, x, cfg)
    for tl in list(params.tail)[:n_tail(cfg)]:
        x = _rec_block_train(tl, x, cfg)
    return _logits(params, x, cfg)


def lm_loss(params: GriffinParams, tokens: torch.Tensor,
            cfg: ArchConfig) -> torch.Tensor:
    logits = forward(params, tokens, cfg)
    return cross_entropy(logits[:, :-1], tokens[:, 1:])


class GriffinState(NamedTuple):
    rec1: RecState        # stacked [n_super, ...]
    rec2: RecState
    attn: A.KVCache       # stacked [n_super, B, window, KV, hd]
    tail: RecState        # stacked [max(n_tail, 1), ...]
    pos: int


@torch.inference_mode()
def init_state(cfg: ArchConfig, batch: int, device=None) -> GriffinState:
    r = cfg.rg_lru_width or cfg.d_model
    ns, nt = n_super(cfg), max(n_tail(cfg), 1)
    mk = lambda n: RecState(
        conv=torch.zeros((n, batch, cfg.conv_width - 1, r), dtype=cfg.dtype,
                         device=device),
        h=torch.zeros((n, batch, r), dtype=torch.float32, device=device))
    return GriffinState(
        rec1=mk(ns), rec2=mk(ns),
        attn=A.KVCache.init(cfg, batch, cfg.window, layers=ns,
                            device=device),
        tail=mk(nt), pos=0)


def _rec_block_decode(p: RecurrentBlock, x, st: RecState, n: int,
                      cfg: ArchConfig):
    """Step block ``n`` of the stacked state ``st`` in place."""
    o, new = _rec_decode(p, rms_norm(x, p.ln, cfg.norm_eps),
                         RecState(st.conv[n], st.h[n]))
    st.conv[n], st.h[n] = new
    x = x + o
    return x + _glu(p.mlp, rms_norm(x, p.ln_mlp, cfg.norm_eps))


@torch.inference_mode()
def decode_step(params: GriffinParams, st: GriffinState, token: torch.Tensor,
                cfg: ArchConfig):
    """One serving step: token [B] -> logits [B, V], updated state.  The
    recurrent states and the attention rings are updated in place."""
    x = params.embed[token][:, None, :].to(cfg.dtype)
    for n, sb in enumerate(params.supers):
        x = _rec_block_decode(sb.rec1, x, st.rec1, n, cfg)
        x = _rec_block_decode(sb.rec2, x, st.rec2, n, cfg)
        kv = A.KVCache(st.attn.k[n], st.attn.v[n])
        o, _ = A.attention_decode(sb.attn.attn,
                                  rms_norm(x, sb.attn.ln, cfg.norm_eps),
                                  kv, st.pos, cfg, window=cfg.window)
        x = x + o
        x = x + _glu(sb.attn.mlp, rms_norm(x, sb.attn.ln_mlp, cfg.norm_eps))
    for n, tl in enumerate(list(params.tail)[:n_tail(cfg)]):
        x = _rec_block_decode(tl, x, st.tail, n, cfg)
    logits = _logits(params, x[:, 0], cfg)
    return logits, st._replace(pos=st.pos + 1)
