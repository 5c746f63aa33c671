"""Mixture-of-Experts FFN with capacity-bounded token dispatch.  The port of
:mod:`repro.models.moe`.

Tokens are routed top-k by an f32 router, each expert processes a fixed
capacity ``cap`` of tokens (a (token, choice) pair whose place in its
expert's queue is ``cap`` or later is dropped), and the expert products
batch over the expert dimension (``torch.bmm``: plain batched matrix
products, which the reference leaves to XLA outside any kernel).  Two
places where PyTorch's defaults differ from JAX's:

* the top k come from a stable descending sort, so equal gates pick the
  lower expert index first, as ``jax.lax.top_k`` does (``torch.topk``
  promises no order);
* the combine gathers each kept (token, choice)'s expert output and adds
  a token's k contributions in choice order, where the reference
  scatter-adds: ``index_add_`` on CUDA adds with atomics, in no fixed
  order, so its bf16 sums would change from run to run.

A training step rematerialises each layer (:mod:`repro_torch.models.
transformer`), so the routing runs twice on the same input, and the
backward's second pass must route every pair as the forward did.  It
does: the router's product and softmax are the same ops on the same
values, the top k come from the stable sort, the queue positions from a
cumsum over the pairs in token-major order, the dispatch writes each kept
pair to its own (expert, slot) (only the dropped pairs share a column,
which is cut off), and the combine gathers; nothing accumulates in an
order that can change between the two passes.
"""
from __future__ import annotations

from collections import namedtuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import ArchConfig, dense_init, param

#: The weights in the reference's order: router [D, E] (f32); w_gate,
#: w_up [E, D, F]; w_down [E, F, D]; shared_gate, shared_up [D, Fs] and
#: shared_down [Fs, D], or None without shared experts.
FIELDS = ("router", "w_gate", "w_up", "w_down", "shared_gate", "shared_up",
          "shared_down")
#: The reference's ``MoEParams`` node.
MoETree = namedtuple("MoEParams", FIELDS)


class MoEParams(nn.Module):
    def __init__(self, router, w_gate, w_up, w_down, shared_gate=None,
                 shared_up=None, shared_down=None):
        super().__init__()
        for name, t in zip(FIELDS, (router, w_gate, w_up, w_down,
                                    shared_gate, shared_up, shared_down)):
            setattr(self, name, None if t is None else param(t))


def padded_experts(cfg: ArchConfig) -> int:
    """Expert-array size: padded to a multiple of 16 when the EP knob is on
    (padded experts receive no tokens — the router stays at n_experts)."""
    if cfg.moe_pad_experts:
        return -(-cfg.n_experts // 16) * 16
    return cfg.n_experts


def init_moe(gen: torch.Generator, cfg: ArchConfig, dtype=None,
             device=None) -> MoEParams:
    dtype = dtype or cfg.dtype
    d, e, f = cfg.d_model, padded_experts(cfg), cfg.d_ff
    fs = cfg.shared_expert_ff or (cfg.n_shared_experts * f)
    init = lambda shape, in_axis, dt=dtype: dense_init(
        gen, shape, in_axis=in_axis, dtype=dt, device=device)
    shared = cfg.n_shared_experts > 0
    return MoEParams(
        router=init((d, cfg.n_experts), 0, torch.float32),
        w_gate=init((e, d, f), 1), w_up=init((e, d, f), 1),
        w_down=init((e, f, d), 1),
        shared_gate=init((d, fs), 0) if shared else None,
        shared_up=init((d, fs), 0) if shared else None,
        shared_down=init((fs, d), 0) if shared else None)


def capacity(cfg: ArchConfig, n: int) -> int:
    """Slots per expert for ``n`` tokens (the reference's formula)."""
    return max(1, int(cfg.capacity_factor * n * cfg.top_k / cfg.n_experts))


def route(params: MoEParams, xt: torch.Tensor, cfg: ArchConfig):
    """xt [n, D] -> (gate weights [n, k] f32, experts [n, k], queue
    positions [n, k]): each (token, choice)'s place in its expert's queue,
    counted over the n·k pairs in token-major order."""
    k = cfg.top_k
    logits = xt.float() @ params.router
    gates = torch.softmax(logits, dim=-1)
    topv, topi = torch.sort(gates, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :k], topi[:, :k]
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    onehot = F.one_hot(topi.reshape(-1), padded_experts(cfg))   # [n·k, e]
    pos = onehot.cumsum(0).gather(1, topi.reshape(-1, 1)) - 1
    return topv, topi, pos.reshape(topi.shape)


def moe_ffn(params: MoEParams, x: torch.Tensor,
            cfg: ArchConfig) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D].  Top-k routing with capacity dropping."""
    b, s, d = x.shape
    n = b * s
    e, k = padded_experts(cfg), cfg.top_k
    cap = capacity(cfg, n)

    xt = x.reshape(n, d)
    topv, topi, pos = route(params, xt, cfg)
    keep = pos < cap
    # dispatch: slot (e, p) holds token id + 1 (0 = empty); dropped pairs
    # land in column cap, which is cut off
    flat_e = topi.reshape(-1)
    flat_pos = torch.where(keep, pos, cap).reshape(-1)
    token_id = torch.arange(n, device=x.device).repeat_interleave(k)
    slots = torch.zeros((e, cap + 1), dtype=torch.int64, device=x.device)
    slots[flat_e, flat_pos] = token_id + 1
    slots = slots[:, :cap]
    occupied = slots > 0
    xe = xt[torch.clamp(slots - 1, min=0)] * occupied[..., None]  # [e,cap,d]

    h = torch.bmm(xe, params.w_gate)
    u = torch.bmm(xe, params.w_up)
    y = torch.bmm(F.silu(h) * u, params.w_down)                 # [e,cap,d]

    # combine: each kept pair's output times its gate, a token's k pairs
    # added in choice order (dropped pairs add a zero)
    gate = torch.where(keep, topv, 0.0).to(y.dtype)             # [n, k]
    picked = y[topi, torch.clamp(pos, max=cap - 1)]             # [n,k,d]
    contrib = picked * gate[..., None]
    out = contrib[:, 0]
    for j in range(1, k):
        out = out + contrib[:, j]

    if params.shared_gate is not None:
        hs = xt @ params.shared_gate
        us = xt @ params.shared_up
        out = out + (F.silu(hs) * us) @ params.shared_down
    return out.reshape(b, s, d).to(x.dtype)


def aux_load_balance_loss(x: torch.Tensor, params: MoEParams,
                          cfg: ArchConfig) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss."""
    n = x.shape[0] * x.shape[1]
    logits = x.reshape(n, -1).float() @ params.router
    gates = torch.softmax(logits, dim=-1)
    top1 = torch.argmax(gates, dim=-1)
    frac = F.one_hot(top1, cfg.n_experts).float().mean(0)
    prob = gates.mean(0)
    return cfg.n_experts * torch.sum(frac * prob)


def layer_from_numpy(tree, i: int, t) -> MoEParams:
    """Layer ``i`` of the reference's stacked ``MoEParams`` (numpy leaves,
    ``None`` for absent shared experts), each leaf through ``t``."""
    return MoEParams(*(None if getattr(tree, f) is None else
                       t(getattr(tree, f)[i]) for f in FIELDS))
