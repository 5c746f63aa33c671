"""RWKV6 "Finch" (arXiv:2404.05892): linear-time LM with data-dependent
decay.  The port of :mod:`repro.models.rwkv6`.

Time mixing uses the paper's ddlerp token-shift and the diagonal
data-dependent decay ``w_t = exp(-exp(w0 + lora(x)))``; channel mixing is
the squared-ReLU MLP.  The model is an ``nn.Module`` (:class:`RWKV6LM`,
the reference's ``RWKVParams``) with one :class:`RWKVLayer` per layer in an
``nn.ModuleList``.  The full-sequence path (``forward``, the prefill of a
recurrent model) runs the WKV6 recurrence through
:func:`repro_torch.kernels.rwkv_scan.ops.wkv6_seq`: the CUDA kernel on a
CUDA tensor, its plain version on a CPU tensor, once per layer.
``decode_step`` steps one token in plain PyTorch, as the reference does.
``forward`` and ``decode_step`` run under ``torch.inference_mode()``;
``lm_loss`` runs the same layers with gradients enabled (the kernel's
backward once per layer) and, as the reference's ``jax.checkpoint`` over
each layer, rematerialises them: a layer keeps only its input for the
backward, which runs its forward again (the kernel's forward twice a layer
a step; its backward recomputes the states from the saved inputs); its
weights in the reference's tree are :func:`param_tree`.
"""
from __future__ import annotations

from collections import namedtuple
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.rwkv_scan.ops import wkv6_seq
from repro_torch.models.common import (ArchConfig, Layers, dense_init,
                                       embed_init, head_loss, layer_norm,
                                       param, remat_layers,
                                       tensor_from_numpy, tree_to_host)
from repro_torch.obs import spans

TM_LORA = 32      # token-mix lora rank
DW_LORA = 64      # decay lora rank
GN_EPS = 64e-5    # per-head group-norm eps

#: The per-layer weights in the reference's order and shapes.
LAYER_FIELDS = ("ln1_s", "ln1_b", "ln2_s", "ln2_b",
                "mu_x",      # [D]
                "mu",        # [5, D]  (r, k, v, w, g)
                "lora_a",    # [D, 5*TM]
                "lora_b",    # [5, TM, D]
                "w0",        # [D] decay bias (log-log space)
                "w_a",       # [D, DW]
                "w_b",       # [DW, D]
                "u",         # [H, N] per-head bonus
                "wr", "wk", "wv", "wg", "wo",   # [D, D]
                "lnx_s", "lnx_b",               # [D] group-norm affine
                "mu_ck", "mu_cr",               # [D]
                "wck",       # [D, F]
                "wcv",       # [F, D]
                "wcr")       # [D, D]
MODEL_FIELDS = ("embed", "ln0_s", "ln0_b", "lnf_s", "lnf_b", "head")
#: The reference's ``RWKVParams`` and ``RWKVLayer`` nodes.
RWKVTree = namedtuple("RWKVParams",
                    "embed ln0_s ln0_b layers lnf_s lnf_b head")
LayerTree = namedtuple("RWKVLayer", LAYER_FIELDS)


class RWKVLayer(nn.Module):
    def __init__(self, **weights):
        super().__init__()
        for name in LAYER_FIELDS:
            setattr(self, name, param(weights[name]))


class RWKV6LM(nn.Module):
    """embed [V,D]; ln0/lnf affine [D]; layers; head [D,V]."""

    def __init__(self, layers, **weights):
        super().__init__()
        for name in MODEL_FIELDS:
            setattr(self, name, param(weights[name]))
        self.layers = nn.ModuleList(layers)


def n_heads(cfg: ArchConfig) -> int:
    return cfg.d_model // cfg.rwkv_head_dim


def init_layer(gen: torch.Generator, cfg: ArchConfig,
               device=None) -> RWKVLayer:
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.dtype
    h, n = n_heads(cfg), cfg.rwkv_head_dim
    full = lambda shape, v: torch.full(shape, v, dtype=dt, device=device)
    dense = lambda shape, in_axis=0: dense_init(gen, shape, in_axis, dt,
                                                device)
    return RWKVLayer(
        ln1_s=full((d,), 1.0), ln1_b=full((d,), 0.0),
        ln2_s=full((d,), 1.0), ln2_b=full((d,), 0.0),
        mu_x=full((d,), 0.0), mu=full((5, d), 0.5),
        lora_a=dense((d, 5 * TM_LORA)),
        lora_b=dense((5, TM_LORA, d), in_axis=1),
        w0=full((d,), -6.0),
        w_a=dense((d, DW_LORA)), w_b=dense((DW_LORA, d)),
        u=dense((h, n), in_axis=1),
        wr=dense((d, d)), wk=dense((d, d)), wv=dense((d, d)),
        wg=dense((d, d)), wo=dense((d, d)),
        lnx_s=full((d,), 1.0), lnx_b=full((d,), 0.0),
        mu_ck=full((d,), 0.5), mu_cr=full((d,), 0.5),
        wck=dense((d, f)), wcv=dense((f, d)), wcr=dense((d, d)))


def init_rwkv(gen: torch.Generator, cfg: ArchConfig,
              device=None) -> RWKV6LM:
    """Random weights drawn from ``gen``, tensor by tensor, each placed on
    ``device``.  :func:`params_from_numpy` carries the reference's own
    weights across."""
    d, dt = cfg.d_model, cfg.dtype
    embed = embed_init(gen, (cfg.vocab, d), dt, device)
    layers = [init_layer(gen, cfg, device) for _ in range(cfg.n_layers)]
    head = dense_init(gen, (d, cfg.vocab), 0, dt, device)
    ones = lambda: torch.ones((d,), dtype=dt, device=device)
    zeros = lambda: torch.zeros((d,), dtype=dt, device=device)
    return RWKV6LM(layers, embed=embed, ln0_s=ones(), ln0_b=zeros(),
                   lnf_s=ones(), lnf_b=zeros(), head=head)


def params_from_numpy(tree, cfg: ArchConfig, device=None) -> RWKV6LM:
    """The reference's ``RWKVParams`` as nested numpy arrays, layers
    stacked [L, ...], as the port's module: same values, same dtypes, same
    shapes per layer."""
    t = lambda a: tensor_from_numpy(a, device)
    layers = [RWKVLayer(**{name: t(getattr(tree.layers, name)[i])
                           for name in LAYER_FIELDS})
              for i in range(cfg.n_layers)]
    return RWKV6LM(layers, **{name: t(getattr(tree, name))
                              for name in MODEL_FIELDS})


def param_tree(params: RWKV6LM, cfg: ArchConfig) -> RWKVTree:
    """The weights in the reference's ``RWKVParams`` tree, each layer leaf
    a :class:`~repro_torch.models.common.Layers`."""
    ly = list(params.layers)
    return RWKVTree(layers=LayerTree(*(Layers([getattr(lp, f) for lp in ly])
                                       for f in LAYER_FIELDS)),
                    **{f: getattr(params, f) for f in MODEL_FIELDS})


def params_to_numpy(params: RWKV6LM, cfg: ArchConfig) -> RWKVTree:
    """The inverse of :func:`params_from_numpy`: the reference's tree,
    layers stacked [L, ...], on the host (numpy; bfloat16 as CPU
    tensors)."""
    return tree_to_host(param_tree(params, cfg))


class LayerState(NamedTuple):
    """Recurrent state of every layer, stacked [L, ...]."""
    tm_shift: torch.Tensor   # [L, B, D] last token's input to time mix
    cm_shift: torch.Tensor   # [L, B, D] last token's input to channel mix
    wkv: torch.Tensor        # [L, B, H, N, N] fp32 outer-product state


@torch.inference_mode()
def init_state(cfg: ArchConfig, batch: int, device=None) -> LayerState:
    d, h, n = cfg.d_model, n_heads(cfg), cfg.rwkv_head_dim
    shift = (cfg.n_layers, batch, d)
    return LayerState(
        tm_shift=torch.zeros(shift, dtype=cfg.dtype, device=device),
        cm_shift=torch.zeros(shift, dtype=cfg.dtype, device=device),
        wkv=torch.zeros((cfg.n_layers, batch, h, n, n), dtype=torch.float32,
                        device=device))


def _group_norm(out, lp: RWKVLayer, cfg: ArchConfig):
    """Per-head group norm of the f32 WKV output [..., D] (population
    variance, eps 64e-5)."""
    h, n = n_heads(cfg), cfg.rwkv_head_dim
    oh = out.reshape(*out.shape[:-1], h, n)
    mu = oh.mean(-1, keepdim=True)
    var = oh.var(-1, keepdim=True, correction=0)
    oh = (oh - mu) * torch.rsqrt(var + GN_EPS)
    return oh.reshape(out.shape) * lp.lnx_s.float() + lp.lnx_b.float()


def _time_mix_step(lp: RWKVLayer, x, prev_x, s, cfg: ArchConfig):
    """One token of WKV6. x: [B, D]; s: [B, H, N, N] fp32."""
    h, n = n_heads(cfg), cfg.rwkv_head_dim
    b, d = x.shape
    xx = prev_x - x
    xxx = x + xx * lp.mu_x
    lo = torch.tanh(xxx @ lp.lora_a).reshape(b, 5, TM_LORA)
    dd = torch.einsum("bft,ftd->fbd", lo, lp.lora_b)      # [5, B, D]
    mix = x[None] + xx[None] * (lp.mu[:, None, :] + dd)   # [5, B, D]
    mr, mk, mv, mw, mg = mix
    r = (mr @ lp.wr).reshape(b, h, n)
    k = (mk @ lp.wk).reshape(b, h, n)
    v = (mv @ lp.wv).reshape(b, h, n)
    g = F.silu(mg @ lp.wg)
    w = torch.exp(-torch.exp((lp.w0 + torch.tanh(mw @ lp.w_a) @ lp.w_b)
                             .float())).reshape(b, h, n)

    r32, k32, v32 = r.float(), k.float(), v.float()
    kv = k32[..., :, None] * v32[..., None, :]            # [B,H,N,N]
    out = torch.einsum("bhn,bhnm->bhm", r32,
                       s + lp.u.float()[None, :, :, None] * kv)
    s_new = w[..., :, None] * s + kv
    out = _group_norm(out.reshape(b, d), lp, cfg)
    return (out.to(cfg.dtype) * g) @ lp.wo, s_new


def _channel_mix_step(lp: RWKVLayer, x, prev_x):
    xx = prev_x - x
    k = x + xx * lp.mu_ck
    r = x + xx * lp.mu_cr
    kk = torch.square(torch.relu(k @ lp.wck))
    return torch.sigmoid(r @ lp.wcr) * (kk @ lp.wcv)


def _layer_step(lp: RWKVLayer, x, tm_shift, cm_shift, wkv,
                cfg: ArchConfig):
    """One token through one layer. x: [B, D].  Returns the output and the
    layer's new (tm_shift, cm_shift, wkv)."""
    h1 = layer_norm(x, lp.ln1_s, lp.ln1_b)
    tm, wkv = _time_mix_step(lp, h1, tm_shift, wkv, cfg)
    x = x + tm
    h2 = layer_norm(x, lp.ln2_s, lp.ln2_b)
    x = x + _channel_mix_step(lp, h2, cm_shift)
    return x, (h1, h2, wkv)


def _shift(x):
    """The previous token's x (zero before the first): pad(x, 1)[:, :-1]."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _time_mix_seq(lp: RWKVLayer, x: torch.Tensor, cfg: ArchConfig):
    """Full-sequence WKV6: all projections are [B,S,D] matmuls; only the
    state recurrence runs over time, in the WKV6 kernel."""
    b, s, d = x.shape
    h, n = n_heads(cfg), cfg.rwkv_head_dim
    xx = _shift(x) - x
    xxx = x + xx * lp.mu_x
    lo = torch.tanh(torch.einsum("bsd,dt->bst", xxx, lp.lora_a)
                    ).reshape(b, s, 5, TM_LORA)
    dd = torch.einsum("bsft,ftd->fbsd", lo, lp.lora_b)    # [5,B,S,D]
    mix = x[None] + xx[None] * (lp.mu[:, None, None, :] + dd)
    mr, mk, mv, mw, mg = mix
    r = torch.einsum("bsd,de->bse", mr, lp.wr).reshape(b, s, h, n)
    k = torch.einsum("bsd,de->bse", mk, lp.wk).reshape(b, s, h, n)
    v = torch.einsum("bsd,de->bse", mv, lp.wv).reshape(b, s, h, n)
    g = F.silu(torch.einsum("bsd,de->bse", mg, lp.wg))
    w = torch.exp(-torch.exp(
        (lp.w0 + torch.tanh(torch.einsum("bsd,dt->bst", mw, lp.w_a))
         @ lp.w_b).float())).reshape(b, s, h, n)
    out = wkv6_seq(r.float(), k.float(), v.float(), w, lp.u.float())
    out = _group_norm(out.reshape(b, s, d), lp, cfg)
    return (out.to(cfg.dtype) * g) @ lp.wo


def _channel_mix_seq(lp: RWKVLayer, x: torch.Tensor):
    xx = _shift(x) - x
    k = x + xx * lp.mu_ck
    r = x + xx * lp.mu_cr
    kk = torch.square(torch.relu(torch.einsum("bsd,df->bsf", k, lp.wck)))
    return torch.sigmoid(torch.einsum("bsd,de->bse", r, lp.wcr)) \
        * torch.einsum("bsf,fd->bsd", kk, lp.wcv)


def _layer_seq(lp: RWKVLayer, x: torch.Tensor, cfg: ArchConfig):
    h1 = layer_norm(x, lp.ln1_s, lp.ln1_b)
    x = x + _time_mix_seq(lp, h1, cfg)
    h2 = layer_norm(x, lp.ln2_s, lp.ln2_b)
    return x + _channel_mix_seq(lp, h2)


def _hidden(params: RWKV6LM, tokens: torch.Tensor,
            cfg: ArchConfig) -> torch.Tensor:
    """The last layer's output [B,S,D], recording the graph when gradients
    are enabled, with each layer rematerialised (the same ops run again in
    the backward, so the values do not change)."""
    with spans.span(spans.EMBED):
        x = params.embed[tokens].to(cfg.dtype)
        x = layer_norm(x, params.ln0_s, params.ln0_b)
    return remat_layers(_layer_seq, params.layers, x, cfg)


def _forward(params: RWKV6LM, tokens: torch.Tensor,
             cfg: ArchConfig) -> torch.Tensor:
    """Full-sequence logits [B,S,V] (:func:`_hidden`, then the head)."""
    x = _hidden(params, tokens, cfg)
    with spans.span(spans.HEAD):
        y = layer_norm(x, params.lnf_s, params.lnf_b)
        return torch.einsum("bsd,dv->bsv", y, params.head.to(cfg.dtype))


@torch.inference_mode()
def forward(params: RWKV6LM, tokens: torch.Tensor,
            cfg: ArchConfig) -> torch.Tensor:
    """Full-sequence forward (the prefill): tokens [B,S] -> logits
    [B,S,V]."""
    return _forward(params, tokens, cfg)


def lm_loss(params: RWKV6LM, tokens: torch.Tensor, cfg: ArchConfig):
    """The mean next-token loss, the head run only over the positions
    that carry one (:func:`repro_torch.models.common.head_loss`)."""
    return head_loss(_hidden(params, tokens, cfg),
                     lambda h: layer_norm(h, params.lnf_s, params.lnf_b),
                     params.head.to(cfg.dtype).T, tokens)


@torch.inference_mode()
def decode_step(params: RWKV6LM, st: LayerState, token: torch.Tensor,
                cfg: ArchConfig):
    """One serving step: token [B] -> logits [B, V], updated state."""
    x = params.embed[token].to(cfg.dtype)
    x = layer_norm(x, params.ln0_s, params.ln0_b)
    new = []
    for i, lp in enumerate(params.layers):
        x, layer_state = _layer_step(lp, x, st.tm_shift[i], st.cm_shift[i],
                                     st.wkv[i], cfg)
        new.append(layer_state)
    y = layer_norm(x, params.lnf_s, params.lnf_b)
    logits = torch.einsum("bd,dv->bv", y, params.head.to(cfg.dtype))
    return logits, LayerState(*(torch.stack(parts) for parts in zip(*new)))
