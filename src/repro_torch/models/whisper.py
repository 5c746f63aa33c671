"""Whisper-medium backbone (arXiv:2212.04356): encoder-decoder transformer.
The port of :mod:`repro.models.whisper`.

Only the transformer backbone is modelled: the conv/mel frontend is a
stub, and the caller supplies frame embeddings [B, n_frames, D].
Encoder: bidirectional self-attention + GELU MLP.  Decoder: causal
self-attention + cross-attention into the encoder output.  LayerNorm
(with bias), learned decoder positions, sinusoidal encoder positions,
MHA (kv == heads).  The encoder's self-attention, the decoder's causal
self-attention and its cross-attention (Sq != Sk) run the flash-attention
kernel once per layer each; ``decode_step`` is plain PyTorch, as the
reference computes it outside any kernel.  ``jax.nn.gelu`` is the tanh
approximation, so the port's GELU is ``approximate="tanh"``.  ``encode``,
``decode_train``, ``forward``, ``init_decode`` and ``decode_step`` run
under ``torch.inference_mode()``; ``loss`` runs the same layers with
gradients enabled (the attention kernel's backward three times a decoder
layer's pair) and, as the reference's ``jax.checkpoint`` over each
encoder and each decoder layer, rematerialises them: an encoder layer
keeps only its input for the backward, a decoder layer its input and the
encoder's output (one tensor for every layer), and the backward runs each
layer's forward again (the attention kernel's forward twice a call a
step); its weights in the reference's tree are :func:`param_tree`.
"""
from __future__ import annotations

from collections import namedtuple
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import attention as A
from repro_torch.models.common import (ArchConfig, Layers, dense_init,
                                       embed_init, head_loss, layer_norm,
                                       param, remat_layers, stack_fields,
                                       tensor_from_numpy, tree_to_host)
from repro_torch.obs import spans


class FFN(nn.Module):
    """w1 [D,F], b1 [F], w2 [F,D], b2 [D]."""

    def __init__(self, w1, b1, w2, b2):
        super().__init__()
        self.w1, self.b1, self.w2, self.b2 = (param(t) for t in
                                              (w1, b1, w2, b2))


class EncLayer(nn.Module):
    def __init__(self, ln1_s, ln1_b, attn: A.AttnParams, ln2_s, ln2_b,
                 ffn: FFN):
        super().__init__()
        self.ln1_s, self.ln1_b = param(ln1_s), param(ln1_b)
        self.attn = attn
        self.ln2_s, self.ln2_b = param(ln2_s), param(ln2_b)
        self.ffn = ffn


class DecLayer(nn.Module):
    def __init__(self, ln1_s, ln1_b, self_attn: A.AttnParams, ln2_s, ln2_b,
                 cross_attn: A.AttnParams, ln3_s, ln3_b, ffn: FFN):
        super().__init__()
        self.ln1_s, self.ln1_b = param(ln1_s), param(ln1_b)
        self.self_attn = self_attn
        self.ln2_s, self.ln2_b = param(ln2_s), param(ln2_b)
        self.cross_attn = cross_attn
        self.ln3_s, self.ln3_b = param(ln3_s), param(ln3_b)
        self.ffn = ffn


#: The model-level weights in the reference's order (``enc_layers`` and
#: ``dec_layers`` are module lists between them).
MODEL_FIELDS = ("enc_pos", "enc_lnf_s", "enc_lnf_b", "tok_embed", "dec_pos",
                "dec_lnf_s", "dec_lnf_b")


#: The reference's tree nodes.
WhisperTree = namedtuple("WhisperParams",
                       "enc_pos enc_layers enc_lnf_s enc_lnf_b tok_embed "
                       "dec_pos dec_layers dec_lnf_s dec_lnf_b")
EncTree = namedtuple("EncLayer", "ln1_s ln1_b attn ln2_s ln2_b ffn")
DecTree = namedtuple("DecLayer", "ln1_s ln1_b self_attn ln2_s ln2_b "
                   "cross_attn ln3_s ln3_b ffn")
FFNTree = namedtuple("FFN", "w1 b1 w2 b2")


class WhisperParams(nn.Module):
    """enc_pos [n_frames, D] (sinusoidal); enc_layers; enc_lnf; tok_embed
    [V, D] (also the output head); dec_pos [max_pos, D] (learned);
    dec_layers; dec_lnf."""

    def __init__(self, enc_layers, dec_layers, **weights):
        super().__init__()
        for name in MODEL_FIELDS:
            setattr(self, name, param(weights[name]))
        self.enc_layers = nn.ModuleList(enc_layers)
        self.dec_layers = nn.ModuleList(dec_layers)


def _init_ffn(gen, d, f, dt, device) -> FFN:
    return FFN(w1=dense_init(gen, (d, f), in_axis=0, dtype=dt, device=device),
               b1=torch.zeros((f,), dtype=dt, device=device),
               w2=dense_init(gen, (f, d), in_axis=0, dtype=dt, device=device),
               b2=torch.zeros((d,), dtype=dt, device=device))


def _ffn(p: FFN, x):
    h = torch.einsum("bsd,df->bsf", x, p.w1) + p.b1
    return torch.einsum("bsf,fd->bsd", F.gelu(h, approximate="tanh"),
                        p.w2) + p.b2


def _sinusoid(n: int, d: int, device=None) -> torch.Tensor:
    pos = torch.arange(n, device=device)[:, None].float()
    dim = torch.arange(d // 2, device=device)[None, :].float()
    ang = pos / torch.pow(torch.tensor(10000.0, device=device), 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def init_whisper(gen: torch.Generator, cfg: ArchConfig, max_pos: int = 4096,
                 device=None) -> WhisperParams:
    """Random weights drawn from ``gen``, each placed on ``device``.  The
    draws differ from the reference's ``jax.random``;
    :func:`params_from_numpy` carries the reference's own weights
    across."""
    dt, d = cfg.dtype, cfg.d_model
    ones = lambda: torch.ones((d,), dtype=dt, device=device)
    zeros = lambda: torch.zeros((d,), dtype=dt, device=device)
    attn = lambda: A.init_attn(gen, cfg, device=device)

    def enc_layer():
        return EncLayer(ones(), zeros(), attn(), ones(), zeros(),
                        _init_ffn(gen, d, cfg.d_ff, dt, device))

    def dec_layer():
        return DecLayer(ones(), zeros(), attn(), ones(), zeros(), attn(),
                        ones(), zeros(),
                        _init_ffn(gen, d, cfg.d_ff, dt, device))

    n_enc = cfg.n_enc_layers or cfg.n_layers
    return WhisperParams(
        [enc_layer() for _ in range(n_enc)],
        [dec_layer() for _ in range(cfg.n_layers)],
        enc_pos=_sinusoid(cfg.n_frames, d, device).to(dt),
        enc_lnf_s=ones(), enc_lnf_b=zeros(),
        tok_embed=embed_init(gen, (cfg.vocab, d), dt, device),
        dec_pos=embed_init(gen, (max_pos, d), dt, device),
        dec_lnf_s=ones(), dec_lnf_b=zeros())


def _attn_from_numpy(tree, i, t) -> A.AttnParams:
    return A.AttnParams(t(tree.wq[i]), t(tree.wk[i]), t(tree.wv[i]),
                        t(tree.wo[i]))


def _ffn_from_numpy(tree, i, t) -> FFN:
    return FFN(t(tree.w1[i]), t(tree.b1[i]), t(tree.w2[i]), t(tree.b2[i]))


def params_from_numpy(tree, cfg: ArchConfig, device=None) -> WhisperParams:
    """The reference's ``WhisperParams`` as nested numpy arrays, layers
    stacked [L, ...], as the port's module: same values, same dtypes, same
    shapes per layer."""
    t = lambda a: tensor_from_numpy(a, device)
    el, dl = tree.enc_layers, tree.dec_layers
    enc = [EncLayer(t(el.ln1_s[i]), t(el.ln1_b[i]),
                    _attn_from_numpy(el.attn, i, t), t(el.ln2_s[i]),
                    t(el.ln2_b[i]), _ffn_from_numpy(el.ffn, i, t))
           for i in range(len(el.ln1_s))]
    dec = [DecLayer(t(dl.ln1_s[i]), t(dl.ln1_b[i]),
                    _attn_from_numpy(dl.self_attn, i, t), t(dl.ln2_s[i]),
                    t(dl.ln2_b[i]), _attn_from_numpy(dl.cross_attn, i, t),
                    t(dl.ln3_s[i]), t(dl.ln3_b[i]),
                    _ffn_from_numpy(dl.ffn, i, t))
           for i in range(cfg.n_layers)]
    return WhisperParams(enc, dec, **{name: t(getattr(tree, name))
                                      for name in MODEL_FIELDS})


def _layers_tree(cls, layers, subtrees: dict):
    """``cls`` over the stacked ``layers``: the fields in ``subtrees``
    (name -> node type) stacked node by node, the rest tensor by tensor."""
    ly = list(layers)
    return cls(**{f: stack_fields(subtrees[f], [getattr(lp, f) for lp in ly])
                  if f in subtrees else Layers([getattr(lp, f) for lp in ly])
                  for f in cls._fields})


def param_tree(params: WhisperParams, cfg: ArchConfig) -> WhisperTree:
    """The weights in the reference's ``WhisperParams`` tree, each layer
    leaf a :class:`~repro_torch.models.common.Layers`."""
    enc = _layers_tree(EncTree, params.enc_layers,
                       {"attn": A.AttnTree, "ffn": FFNTree})
    dec = _layers_tree(DecTree, params.dec_layers,
                       {"self_attn": A.AttnTree, "cross_attn": A.AttnTree,
                        "ffn": FFNTree})
    return WhisperTree(enc_layers=enc, dec_layers=dec,
                       **{f: getattr(params, f) for f in MODEL_FIELDS})


def params_to_numpy(params: WhisperParams, cfg: ArchConfig) -> WhisperTree:
    """The inverse of :func:`params_from_numpy`: the reference's tree,
    layers stacked [L, ...], on the host (numpy; bfloat16 as CPU
    tensors)."""
    return tree_to_host(param_tree(params, cfg))


def _enc_layer(lp: EncLayer, x, cfg: ArchConfig):
    h = layer_norm(x, lp.ln1_s, lp.ln1_b)
    x = x + A.attention_train(lp.attn, h, cfg, causal=False, use_rope=False)
    h = layer_norm(x, lp.ln2_s, lp.ln2_b)
    return x + _ffn(lp.ffn, h)


def _encode(params: WhisperParams, frames: torch.Tensor, cfg: ArchConfig):
    with spans.span(spans.EMBED):
        x = frames.to(cfg.dtype) + params.enc_pos[None]
    x = remat_layers(_enc_layer, params.enc_layers, x, cfg)
    return layer_norm(x, params.enc_lnf_s, params.enc_lnf_b)


@torch.inference_mode()
def encode(params: WhisperParams, frames: torch.Tensor, cfg: ArchConfig):
    """frames: [B, T, D] stubbed frame embeddings -> encoder states."""
    return _encode(params, frames, cfg)


def _dec_layer(lp: DecLayer, x, enc_out, cfg: ArchConfig):
    """One decoder layer; ``enc_out`` is an input, so under the
    rematerialisation the cross-attention's K/V are recomputed from it and
    its gradient reaches the encoder."""
    h = layer_norm(x, lp.ln1_s, lp.ln1_b)
    x = x + A.attention_train(lp.self_attn, h, cfg, causal=True,
                              use_rope=False)
    h = layer_norm(x, lp.ln2_s, lp.ln2_b)
    x = x + A.cross_attention(lp.cross_attn, h, enc_out, cfg)
    h = layer_norm(x, lp.ln3_s, lp.ln3_b)
    return x + _ffn(lp.ffn, h)


def _decode_hidden(params: WhisperParams, tokens: torch.Tensor,
                   enc_out: torch.Tensor, cfg: ArchConfig):
    """The decoder's last layer's output [B, S, D] over ``tokens``."""
    s = tokens.shape[1]
    with spans.span(spans.EMBED):
        x = params.tok_embed[tokens].to(cfg.dtype) \
            + params.dec_pos[None, :s]
    return remat_layers(_dec_layer, params.dec_layers, x, enc_out, cfg)


def _decode_train(params: WhisperParams, tokens: torch.Tensor,
                  enc_out: torch.Tensor, cfg: ArchConfig):
    x = _decode_hidden(params, tokens, enc_out, cfg)
    with spans.span(spans.HEAD):
        x = layer_norm(x, params.dec_lnf_s, params.dec_lnf_b)
        return torch.einsum("bsd,vd->bsv", x,
                            params.tok_embed.to(cfg.dtype))


@torch.inference_mode()
def decode_train(params: WhisperParams, tokens: torch.Tensor,
                 enc_out: torch.Tensor, cfg: ArchConfig):
    """tokens [B, S] and encoder states [B, T, D] -> logits [B, S, V]."""
    return _decode_train(params, tokens, enc_out, cfg)


def _forward(params: WhisperParams, frames: torch.Tensor,
             tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    return _decode_train(params, tokens, _encode(params, frames, cfg), cfg)


@torch.inference_mode()
def forward(params: WhisperParams, frames: torch.Tensor,
            tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Encode ``frames``, then the decoder's logits over ``tokens``."""
    return _forward(params, frames, tokens, cfg)


def loss(params: WhisperParams, frames: torch.Tensor, tokens: torch.Tensor,
         cfg: ArchConfig) -> torch.Tensor:
    """The decoder's mean next-token loss, the tied head run only over the
    positions that carry one (:func:`repro_torch.models.common.head_loss`)."""
    x = _decode_hidden(params, tokens, _encode(params, frames, cfg), cfg)
    return head_loss(x, lambda h: layer_norm(h, params.dec_lnf_s,
                                             params.dec_lnf_b),
                     params.tok_embed.to(cfg.dtype), tokens)


class WhisperState(NamedTuple):
    self_cache: A.KVCache     # [L, B, S_max, KV, hd]
    cross_k: torch.Tensor     # [L, B, T, KV, hd] precomputed
    cross_v: torch.Tensor
    pos: int


@torch.inference_mode()
def init_decode(params: WhisperParams, frames: torch.Tensor,
                cfg: ArchConfig, s_max: int) -> WhisperState:
    """Encode once, precompute cross K/V (the serving fast path)."""
    enc = encode(params, frames, cfg)
    ck = torch.stack([torch.einsum("btd,dhk->bthk", enc, lp.cross_attn.wk)
                      for lp in params.dec_layers])
    cv = torch.stack([torch.einsum("btd,dhk->bthk", enc, lp.cross_attn.wv)
                      for lp in params.dec_layers])
    return WhisperState(
        self_cache=A.KVCache.init(cfg, frames.shape[0], s_max,
                                  layers=cfg.n_layers, device=frames.device),
        cross_k=ck, cross_v=cv, pos=0)


@torch.inference_mode()
def decode_step(params: WhisperParams, st: WhisperState, token: torch.Tensor,
                cfg: ArchConfig):
    """One decoder step: token [B] -> logits [B, V], updated state (the
    self-attention cache is updated in place)."""
    b = token.shape[0]
    pe = params.dec_pos[min(st.pos, params.dec_pos.shape[0] - 1)]
    x = (params.tok_embed[token] + pe)[:, None, :].to(cfg.dtype)
    for i, lp in enumerate(params.dec_layers):
        cache = A.KVCache(st.self_cache.k[i], st.self_cache.v[i])
        ck, cv = st.cross_k[i], st.cross_v[i]
        h = layer_norm(x, lp.ln1_s, lp.ln1_b)
        o, _ = A.attention_decode(lp.self_attn, h, cache, st.pos, cfg,
                                  use_rope=False)
        x = x + o
        h = layer_norm(x, lp.ln2_s, lp.ln2_b)
        q = torch.einsum("bsd,dhk->bshk", h, lp.cross_attn.wq)
        qg = A._group_heads(q, ck.shape[2])
        logits = torch.einsum("bqkgh,bskh->bkgqs", qg.float(),
                              ck.float()) * cfg.hd ** -0.5
        p = torch.softmax(logits, dim=-1).to(x.dtype)
        o = torch.einsum("bkgqs,bskh->bqkgh", p, cv)
        o = o.reshape(b, 1, cfg.n_heads, cfg.hd)
        x = x + torch.einsum("bshk,hkd->bsd", o, lp.cross_attn.wo)
        h = layer_norm(x, lp.ln3_s, lp.ln3_b)
        x = x + _ffn(lp.ffn, h)
    x = layer_norm(x[:, 0], params.dec_lnf_s, params.dec_lnf_b)
    logits = torch.einsum("bd,vd->bv", x, params.tok_embed.to(cfg.dtype))
    return logits, st._replace(pos=st.pos + 1)
