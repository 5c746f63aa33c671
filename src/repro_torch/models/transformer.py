"""Decoder-only transformer LM, dense and MoE.  The port of
:mod:`repro.models.transformer` (granite, smollm, command-r, deepseek,
qwen2-moe, llama4-scout, the InternVL LM).

The model is an ``nn.Module`` (:class:`TransformerLM`) holding the
reference's weights in the reference's shapes, one :class:`LayerParams`
per layer in an ``nn.ModuleList`` where the reference stacks them on a
leading ``L`` axis; a layer holds a dense MLP or, in an MoE config, an
:class:`repro_torch.models.moe.MoEParams`.  ``forward`` (with the VLM's
patch prefix), ``prefill`` and ``decode_step`` are the serving paths and
run under ``torch.inference_mode()``; forward and prefill run the
flash-attention kernel once per layer.  ``lm_loss`` runs the same layers
with gradients enabled (the kernel's backward once per layer) and, as the
reference's ``jax.checkpoint`` over each layer (``forward(...,
remat=True)``, the default ``lm_loss`` takes), rematerialises them: a
layer keeps only its input for the backward, which runs its forward again
(the kernel's forward twice a layer a step; an MoE layer's routing comes
out the same on the second pass, :mod:`repro_torch.models.moe`); its
weights in the reference's tree are :func:`param_tree`.
"""
from __future__ import annotations

from collections import namedtuple
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import attention as A
from repro_torch.models import moe as M
from repro_torch.models.common import (ArchConfig, Layers, apply_rope,
                                       dense_init, embed_init, head_loss,
                                       param, remat_layers, rms_norm,
                                       stack_fields, tensor_from_numpy,
                                       tree_to_host)
from repro_torch.obs import spans

#: The reference's ``LMParams``, ``LayerParams`` and ``MLPParams`` nodes.
LMTree = namedtuple("LMParams", "embed layers ln_f lm_head")
LayerTree = namedtuple("LayerParams", "ln_attn attn ln_mlp mlp moe")
MLPTree = namedtuple("MLPParams", "w_gate w_up w_down")


class MLPParams(nn.Module):
    """w_gate, w_up [D,F]; w_down [F,D]."""

    def __init__(self, w_gate, w_up, w_down):
        super().__init__()
        self.w_gate, self.w_up, self.w_down = (param(t) for t in
                                               (w_gate, w_up, w_down))


def init_mlp(gen, d, f, dtype, device=None) -> MLPParams:
    init = lambda shape: dense_init(gen, shape, in_axis=0, dtype=dtype,
                                    device=device)
    return MLPParams(init((d, f)), init((d, f)), init((f, d)))


def mlp(params: MLPParams, x: torch.Tensor) -> torch.Tensor:
    h = torch.einsum("bsd,df->bsf", x, params.w_gate)
    u = torch.einsum("bsd,df->bsf", x, params.w_up)
    return torch.einsum("bsf,fd->bsd", F.silu(h) * u, params.w_down)


class LayerParams(nn.Module):
    """One layer: ``mlp`` in a dense config, ``moe`` in an MoE one (the
    other None)."""

    def __init__(self, ln_attn, attn: A.AttnParams, ln_mlp,
                 mlp: Optional[MLPParams] = None,
                 moe: Optional[M.MoEParams] = None):
        super().__init__()
        self.ln_attn = param(ln_attn)
        self.attn = attn
        self.ln_mlp = param(ln_mlp)
        self.mlp = mlp
        self.moe = moe


def _ffn(lp: LayerParams, h, cfg: ArchConfig):
    return M.moe_ffn(lp.moe, h, cfg) if cfg.is_moe else mlp(lp.mlp, h)


class TransformerLM(nn.Module):
    """embed [V,D]; layers; ln_f [D]; lm_head [D,V] (None when tied: the
    head is ``embed.T``)."""

    def __init__(self, embed, layers, ln_f, lm_head=None):
        super().__init__()
        self.embed = param(embed)
        self.layers = nn.ModuleList(layers)
        self.ln_f = param(ln_f)
        self.lm_head = None if lm_head is None else param(lm_head)

    def head(self) -> torch.Tensor:
        return self.embed.T if self.lm_head is None else self.lm_head


def init_layer(gen: torch.Generator, cfg: ArchConfig, dtype=None,
               device=None) -> LayerParams:
    dtype = dtype or cfg.dtype
    d = cfg.d_model
    zeros = lambda: torch.zeros((d,), dtype=dtype, device=device)
    return LayerParams(
        ln_attn=zeros(), attn=A.init_attn(gen, cfg, dtype, device),
        ln_mlp=zeros(),
        mlp=None if cfg.is_moe else init_mlp(gen, d, cfg.d_ff, dtype,
                                             device),
        moe=M.init_moe(gen, cfg, dtype, device) if cfg.is_moe else None)


def init_lm(gen: torch.Generator, cfg: ArchConfig,
            device=None) -> TransformerLM:
    """Random weights drawn from ``gen``, tensor by tensor, each placed on
    ``device`` (no f32 copy of the whole model exists).  The draws differ
    from the reference's ``jax.random``; :func:`params_from_numpy` carries
    the reference's own weights across."""
    d = cfg.d_model
    embed = embed_init(gen, (cfg.vocab, d), cfg.dtype, device)
    layers = [init_layer(gen, cfg, device=device)
              for _ in range(cfg.n_layers)]
    head = None if cfg.tie_embeddings else dense_init(
        gen, (d, cfg.vocab), in_axis=0, dtype=cfg.dtype, device=device)
    return TransformerLM(embed, layers,
                         torch.zeros((d,), dtype=cfg.dtype, device=device),
                         head)


def params_from_numpy(tree, cfg: ArchConfig, device=None) -> TransformerLM:
    """The reference's ``LMParams`` as nested numpy arrays (for example
    ``jax.tree_util.tree_map(np.asarray, params)``), layers stacked
    [L, ...], as the port's module: same values, same dtypes, same shapes
    per layer (the MoE leaves too; absent shared experts stay None)."""
    t = lambda a: tensor_from_numpy(a, device)
    ly = tree.layers
    layers = [LayerParams(
        ln_attn=t(ly.ln_attn[i]),
        attn=A.AttnParams(t(ly.attn.wq[i]), t(ly.attn.wk[i]),
                          t(ly.attn.wv[i]), t(ly.attn.wo[i])),
        ln_mlp=t(ly.ln_mlp[i]),
        mlp=None if ly.mlp is None else MLPParams(
            t(ly.mlp.w_gate[i]), t(ly.mlp.w_up[i]), t(ly.mlp.w_down[i])),
        moe=None if ly.moe is None else M.layer_from_numpy(ly.moe, i, t))
        for i in range(cfg.n_layers)]
    return TransformerLM(t(tree.embed), layers, t(tree.ln_f),
                         None if tree.lm_head is None else t(tree.lm_head))


def param_tree(params: TransformerLM, cfg: ArchConfig) -> LMTree:
    """The weights in the reference's ``LMParams`` tree, each layer leaf a
    :class:`~repro_torch.models.common.Layers`."""
    ly = list(params.layers)
    return LMTree(
        embed=params.embed,
        layers=LayerTree(
            ln_attn=Layers([lp.ln_attn for lp in ly]),
            attn=stack_fields(A.tree_class(ly[0].attn),
                              [lp.attn for lp in ly]),
            ln_mlp=Layers([lp.ln_mlp for lp in ly]),
            mlp=None if cfg.is_moe else stack_fields(
                MLPTree, [lp.mlp for lp in ly]),
            moe=stack_fields(M.tree_class(ly[0].moe), [lp.moe for lp in ly])
            if cfg.is_moe else None),
        ln_f=params.ln_f, lm_head=params.lm_head)


def params_to_numpy(params: TransformerLM, cfg: ArchConfig) -> LMTree:
    """The inverse of :func:`params_from_numpy`: the reference's tree,
    layers stacked [L, ...], on the host (numpy; bfloat16 as CPU
    tensors)."""
    return tree_to_host(param_tree(params, cfg))


def _layer_fwd(lp: LayerParams, x, cfg: ArchConfig, pos):
    h = rms_norm(x, lp.ln_attn, cfg.norm_eps)
    x = x + A.attention_train(lp.attn, h, cfg, causal=True, pos=pos)
    h = rms_norm(x, lp.ln_mlp, cfg.norm_eps)
    return x + _ffn(lp, h, cfg)


def _logits(params: TransformerLM, x, cfg: ArchConfig):
    with spans.span(spans.HEAD):
        x = rms_norm(x, params.ln_f, cfg.norm_eps)
        return torch.einsum("bsd,dv->bsv", x, params.head().to(cfg.dtype))


def _hidden(params: TransformerLM, tokens: torch.Tensor, cfg: ArchConfig,
            prefix_embed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens [B, S] -> the last layer's output [B, S(+P), D], recording
    the graph when gradients are enabled, with each layer rematerialised
    (the same ops run again in the backward, so the values do not change).

    ``prefix_embed`` [B, P, D] prepends precomputed embeddings (the VLM
    patch stub)."""
    with spans.span(spans.EMBED):
        x = params.embed[tokens].to(cfg.dtype)
        if prefix_embed is not None:
            x = torch.cat([prefix_embed.to(cfg.dtype), x], dim=1)
    b, s, _ = x.shape
    pos = torch.arange(s, device=x.device).expand(b, s)
    return remat_layers(_layer_fwd, params.layers, x, cfg, pos)


def _forward(params: TransformerLM, tokens: torch.Tensor,
             cfg: ArchConfig, *,
             prefix_embed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S(+P), V] (:func:`_hidden`, then the
    head over every position)."""
    return _logits(params, _hidden(params, tokens, cfg, prefix_embed), cfg)


@torch.inference_mode()
def forward(params: TransformerLM, tokens: torch.Tensor, cfg: ArchConfig,
            *, prefix_embed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S(+P), V] (the serving path)."""
    return _forward(params, tokens, cfg, prefix_embed=prefix_embed)


def lm_loss(params: TransformerLM, tokens: torch.Tensor, cfg: ArchConfig,
            prefix_embed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The mean next-token loss over the text positions (after the
    prefix's rows), the head run only over those that carry a loss
    (:func:`repro_torch.models.common.head_loss`)."""
    x = _hidden(params, tokens, cfg, prefix_embed)
    return head_loss(x, lambda h: rms_norm(h, params.ln_f, cfg.norm_eps),
                     params.head().to(cfg.dtype).T, tokens,
                     prefix=0 if prefix_embed is None
                     else prefix_embed.shape[1])


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

class DecodeState(NamedTuple):
    cache: A.KVCache        # stacked [L, B, S_max, KV, hd]
    pos: int                # next position to write


@torch.inference_mode()
def init_decode(cfg: ArchConfig, batch: int, s_max: int,
                device=None) -> DecodeState:
    return DecodeState(
        cache=A.KVCache.init(cfg, batch, s_max, layers=cfg.n_layers,
                             device=device),
        pos=0)


@torch.inference_mode()
def decode_step(params: TransformerLM, state: DecodeState,
                token: torch.Tensor, cfg: ArchConfig):
    """One serving step: token [B] -> logits [B, V], updated state.  The
    cache is updated in place."""
    x = params.embed[token][:, None, :].to(cfg.dtype)       # [B,1,D]
    for i, lp in enumerate(params.layers):
        layer_cache = A.KVCache(state.cache.k[i], state.cache.v[i])
        h = rms_norm(x, lp.ln_attn, cfg.norm_eps)
        a, _ = A.attention_decode(lp.attn, h, layer_cache, state.pos, cfg)
        x = x + a
        h = rms_norm(x, lp.ln_mlp, cfg.norm_eps)
        x = x + _ffn(lp, h, cfg)
    logits = _logits(params, x, cfg)[:, 0]
    return logits, DecodeState(cache=state.cache, pos=state.pos + 1)


@torch.inference_mode()
def prefill(params: TransformerLM, tokens: torch.Tensor, cfg: ArchConfig,
            s_max: int) -> tuple[torch.Tensor, DecodeState]:
    """Prefill the KV cache with a full prompt; returns last-token logits.

    Full-sequence attention (the flash-attention kernel, once per layer)
    with K/V written to the cache, zero past the prompt — one pass, no
    token loop."""
    b, s = tokens.shape
    x = params.embed[tokens].to(cfg.dtype)
    pos = torch.arange(s, device=x.device).expand(b, s)
    cache = A.KVCache.init(cfg, b, s_max, layers=cfg.n_layers,
                           device=x.device)
    for i, lp in enumerate(params.layers):
        h = rms_norm(x, lp.ln_attn, cfg.norm_eps)
        q, k, v = A._qkv(lp.attn, h)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
        o = A._sdpa_train(q, k, v, causal=True)
        x = x + torch.einsum("bshk,hkd->bsd", o, lp.attn.wo)
        h2 = rms_norm(x, lp.ln_mlp, cfg.norm_eps)
        x = x + _ffn(lp, h2, cfg)
        cache.k[i, :, :s] = k
        cache.v[i, :, :s] = v
    x = rms_norm(x, params.ln_f, cfg.norm_eps)
    logits = torch.einsum("bd,dv->bv", x[:, -1],
                          params.head().to(cfg.dtype))
    return logits, DecodeState(cache=cache, pos=s)
