"""A decoder-only transformer LM in plain float32 PyTorch: the Qwen2 block
(RMS norm with a ``1 + scale`` gain, grouped-query attention with rotary
embeddings on the two halves of each head, a SwiGLU MLP), a tied or
separate head, and an optional prefix of given embeddings (a vision
tower's patches) in front of the text.  The loss is the mean next-token
cross-entropy over the text.

Attention is causal over every position, prefix included, and is worked
out from its definition: the scaled scores, the mask, the softmax, the
weighted values.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.common import layers, nll_sum, rms_norm, rope

LAYER = ("ln_attn", "attn.wq", "attn.wk", "attn.wv", "attn.wo", "ln_mlp",
         "mlp.w_gate", "mlp.w_up", "mlp.w_down")


def expected_shapes(m: dict) -> dict:
    if m.get("qkv_bias"):
        raise NotImplementedError("q/k/v biases: the program has none")
    d, f, v = m["d_model"], m["d_ff"], m["vocab"]
    h, kv, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    out = {"embed": (v, d)}
    out.update({f"layers.{k}": s for k, s in dict(
        ln_attn=(d,), **{"attn.wq": (d, h, hd), "attn.wk": (d, kv, hd),
                         "attn.wv": (d, kv, hd), "attn.wo": (h, hd, d)},
        ln_mlp=(d,), **{"mlp.w_gate": (d, f), "mlp.w_up": (d, f),
                        "mlp.w_down": (f, d)}).items()})
    out["ln_f"] = (d,)
    if not m["tie_embeddings"]:
        out["lm_head"] = (d, v)
    return out


def attention(q, k, v, prod):
    """Causal attention, q [B, S, H, hd], k/v [B, S, KV, hd]; query head
    i reads key/value head i // (H / KV)."""
    b, s, h, hd = q.shape
    g = h // k.shape[2]
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    scores = prod("bqhd,bkhd->bhqk", q, k) * hd ** -0.5
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    return prod("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)


def _layer(lw, x, m, prod, pos):
    h = rms_norm(x, lw["ln_attn"], m["norm_eps"])
    q = rope(prod("bsd,dhk->bshk", h, lw["attn.wq"]), pos, m["rope_theta"])
    k = rope(prod("bsd,dhk->bshk", h, lw["attn.wk"]), pos, m["rope_theta"])
    v = prod("bsd,dhk->bshk", h, lw["attn.wv"])
    x = x + prod("bshk,hkd->bsd", attention(q, k, v, prod), lw["attn.wo"])
    h = rms_norm(x, lw["ln_mlp"], m["norm_eps"])
    u = F.silu(prod("bsd,df->bsf", h, lw["mlp.w_gate"])) \
        * prod("bsd,df->bsf", h, lw["mlp.w_up"])
    return x + prod("bsf,fd->bsd", u, lw["mlp.w_down"])


def loss_sums(w: dict, rows: dict, m: dict, prod):
    """(sum of next-token NLL over the rows' text, number of positions)."""
    tokens = rows["tokens"].long()
    x = w["embed"][tokens]
    p = 0
    if m.get("prefix"):
        prefix = rows[m["prefix"]["key"]].float()
        p = prefix.shape[1]
        x = torch.cat([prefix, x], dim=1)
    pos = torch.arange(x.shape[1], device=x.device)
    per_layer = [{f: w[f"layers.{f}"][i] for f in LAYER}
                 for i in range(m["n_layers"])]
    x = layers(_layer, per_layer, x, m, prod, pos)
    y = rms_norm(x[:, p:-1], w["ln_f"], m["norm_eps"])
    head = w["embed"].T if m["tie_embeddings"] else w["lm_head"]
    logits = prod("bsd,dv->bsv", y, head)
    labels = tokens[:, 1:]
    return nll_sum(logits, labels), labels.numel()
