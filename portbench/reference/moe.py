"""The Qwen2-MoE language model (Qwen1.5-MoE-A2.7B) in plain float32
PyTorch, with one expert-parallel rank's share of each layer's experts.

A layer is the Qwen2 block with its MLP replaced by the sparse block
(Hugging Face's ``Qwen2MoeSparseMoeBlock``), written from its definition:

* attention: RMS norm, q/k/v projections with their biases, rotary
  embeddings on the two halves of each head, causal softmax attention
  worked out from the scores, the output projection (no bias);
* the sparse block, on the RMS-normed input x: the router's logits
  ``x · W_r`` over all ``n_experts``, their softmax, the top ``top_k``
  experts and their probabilities as gates (renormalised only with
  ``norm_topk_prob``); of the experts ``[r·E/ep, (r+1)·E/ep)`` this rank
  holds, each takes the rows routed to it, unsorted, through its SwiGLU
  ``(silu(x W_g) * (x W_u)) W_d``, times each row's gate; plus the shared
  expert's SwiGLU times ``sigmoid(x · w_sg)``.  What the other ranks'
  experts would add is left out, as in the program;
* no auxiliary loss (``output_router_logits`` false).

Departures from the published model, each the program's too: the RMS
norms' gain is ``1 + scale`` with the scale starting at zero (the
program's parametrisation; a published checkpoint's gain g loads as
g − 1); the router's weight, like every weight, is held at the
configuration's precision and read as float32, and its logits are not
rounded to bfloat16 (the program rounds them, as a bfloat16 ``gate``
Linear does).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.common import layers, nll_sum, rms_norm, rope
from portbench.reference.transformer import attention

LAYER = ("ln_attn", "attn.wq", "attn.wk", "attn.wv", "attn.wo", "attn.bq",
         "attn.bk", "attn.bv", "ln_mlp", "moe.router", "moe.w_gate",
         "moe.w_up", "moe.w_down", "moe.shared_gate", "moe.shared_up",
         "moe.shared_down", "moe.shared_expert_gate")


def held(m: dict) -> int:
    """Experts this rank holds."""
    if m["n_experts"] % m["ep_size"]:
        raise ValueError("the ranks must share the experts evenly")
    return m["n_experts"] // m["ep_size"]


def expected_shapes(m: dict) -> dict:
    d, v, e = m["d_model"], m["vocab"], held(m)
    h, kv, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    f, fs = m["moe_d_ff"], m["shared_d_ff"]
    out = {"embed": (v, d)}
    out.update({f"layers.{k}": s for k, s in {
        "ln_attn": (d,), "attn.wq": (d, h, hd), "attn.wk": (d, kv, hd),
        "attn.wv": (d, kv, hd), "attn.wo": (h, hd, d), "attn.bq": (h, hd),
        "attn.bk": (kv, hd), "attn.bv": (kv, hd), "ln_mlp": (d,),
        "moe.router": (d, m["n_experts"]), "moe.w_gate": (e, d, f),
        "moe.w_up": (e, d, f), "moe.w_down": (e, f, d),
        "moe.shared_gate": (d, fs), "moe.shared_up": (d, fs),
        "moe.shared_down": (fs, d), "moe.shared_expert_gate": (d, 1)}.items()})
    out["ln_f"] = (d,)
    out["lm_head"] = (d, v)
    return out


def sparse_block(lw: dict, x, m: dict, prod):
    """x [n, D] (normed) -> this rank's part of the sparse block, [n, D]."""
    probs = torch.softmax(prod("nd,de->ne", x, lw["moe.router"]), dim=-1)
    gates, experts = torch.topk(probs, m["top_k"], dim=-1)
    if m["norm_topk_prob"]:
        gates = gates / gates.sum(-1, keepdim=True)
    lo = m["ep_rank"] * held(m)
    out = torch.zeros_like(x)
    for i in range(held(m)):
        rows, choice = torch.where(experts == lo + i)
        if rows.numel() == 0:
            continue
        xe = x[rows]
        y = prod("nf,fd->nd",
                 F.silu(prod("nd,df->nf", xe, lw["moe.w_gate"][i]))
                 * prod("nd,df->nf", xe, lw["moe.w_up"][i]),
                 lw["moe.w_down"][i])
        out = out.index_add(0, rows, y * gates[rows, choice, None])
    shared = prod("nf,fd->nd",
                  F.silu(prod("nd,df->nf", x, lw["moe.shared_gate"]))
                  * prod("nd,df->nf", x, lw["moe.shared_up"]),
                  lw["moe.shared_down"])
    gate = torch.sigmoid(prod("nd,do->no", x, lw["moe.shared_expert_gate"]))
    return out + gate * shared


def _layer(lw, x, m, prod, pos):
    h = rms_norm(x, lw["ln_attn"], m["norm_eps"])
    q = rope(prod("bsd,dhk->bshk", h, lw["attn.wq"]) + lw["attn.bq"], pos,
             m["rope_theta"])
    k = rope(prod("bsd,dhk->bshk", h, lw["attn.wk"]) + lw["attn.bk"], pos,
             m["rope_theta"])
    v = prod("bsd,dhk->bshk", h, lw["attn.wv"]) + lw["attn.bv"]
    x = x + prod("bshk,hkd->bsd", attention(q, k, v, prod), lw["attn.wo"])
    h = rms_norm(x, lw["ln_mlp"], m["norm_eps"])
    b, s, d = h.shape
    return x + sparse_block(lw, h.reshape(b * s, d), m, prod).view(b, s, d)


def logits(w: dict, tokens, m: dict, prod):
    """tokens [B, S] -> logits [B, S, V] at every position."""
    x = w["embed"][tokens.long()]
    pos = torch.arange(x.shape[1], device=x.device)
    per_layer = [{f: w[f"layers.{f}"][i] for f in LAYER}
                 for i in range(m["n_layers"])]
    x = layers(_layer, per_layer, x, m, prod, pos)
    return prod("bsd,dv->bsv", rms_norm(x, w["ln_f"], m["norm_eps"]),
                w["lm_head"])


def loss_sums(w: dict, rows: dict, m: dict, prod):
    """(sum of next-token NLL over the rows, number of positions)."""
    tokens = rows["tokens"].long()
    labels = tokens[:, 1:]
    return nll_sum(logits(w, tokens, m, prod)[:, :-1], labels), \
        labels.numel()
