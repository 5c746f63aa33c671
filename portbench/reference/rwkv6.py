"""RWKV-6 "Finch" (arXiv:2404.05892) in plain float32 PyTorch.

Time mixing: the data-dependent token shift (ddlerp, a low-rank mix of
rank ``tm_lora`` for r, k, v, w, g), the decay ``w = exp(-exp(w0 +
tanh(x W_a) W_b))`` per channel, the WKV recurrence with its bonus ``u``

    o_t = S_t^T r_t + (r_t . (u * k_t)) v_t,   S_{t+1} = diag(w_t) S_t + k_t v_t^T

per head, a per-head group norm (eps ``gn_eps``), the SiLU gate and the
output projection.  Channel mixing: token shift, squared ReLU, sigmoid
receptance.  Layer norms (eps ``ln_eps``) before each block, after the
embedding and before the head.  The loss is the mean next-token
cross-entropy.

The recurrence is computed exactly in chunks of ``CHUNK`` steps: inside a
chunk from the pairwise decays ``exp(a_{t-1} - a_s)`` (never above 1),
across chunks from the carried state, so autograd gives its gradient at
matrix-product speed.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.common import layer_norm, layers, nll_sum

CHUNK = 32
LAYER = ("ln1_s", "ln1_b", "ln2_s", "ln2_b", "mu_x", "mu", "lora_a",
         "lora_b", "w0", "w_a", "w_b", "u", "wr", "wk", "wv", "wg", "wo",
         "lnx_s", "lnx_b", "mu_ck", "mu_cr", "wck", "wcv", "wcr")


def expected_shapes(m: dict) -> dict:
    """{path: shape of one part} of the model's weights."""
    d, f, v = m["d_model"], m["d_ff"], m["vocab"]
    h, n = d // m["head_size"], m["head_size"]
    tm, dw = m["tm_lora"], m["dw_lora"]
    lay = dict(ln1_s=(d,), ln1_b=(d,), ln2_s=(d,), ln2_b=(d,), mu_x=(d,),
               mu=(5, d), lora_a=(d, 5 * tm), lora_b=(5, tm, d), w0=(d,),
               w_a=(d, dw), w_b=(dw, d), u=(h, n), wr=(d, d), wk=(d, d),
               wv=(d, d), wg=(d, d), wo=(d, d), lnx_s=(d,), lnx_b=(d,),
               mu_ck=(d,), mu_cr=(d,), wck=(d, f), wcv=(f, d), wcr=(d, d))
    out = {"embed": (v, d), "ln0_s": (d,), "ln0_b": (d,)}
    out.update({f"layers.{k}": s for k, s in lay.items()})
    out.update({"lnf_s": (d,), "lnf_b": (d,), "head": (d, v)})
    return out


def wkv(r, k, v, logw, u):
    """r, k, v, logw (log of the decay, <= 0): [B, T, H, N]; u [H, N]
    -> o [B, T, H, N]."""
    b, t, h, n = r.shape
    c = min(CHUNK, t)
    pad = (-t) % c
    if pad:     # zero keys, values and log-decays after the end
        r, k, v, logw = (F.pad(x, (0, 0, 0, 0, 0, pad))
                         for x in (r, k, v, logw))
    nc = (t + pad) // c
    # [B, H, nc, C, N]
    r, k, v, logw = (x.transpose(1, 2).reshape(b, h, nc, c, n)
                     for x in (r, k, v, logw))
    a = torch.cumsum(logw, dim=3)              # decay through step s
    a_prev = a - logw                          # decay through step t - 1
    below = torch.tril(torch.ones(c, c, dtype=torch.bool, device=r.device),
                       -1)
    # inside a chunk: sum_n r_t k_s exp(a_{t-1} - a_s), s < t
    dec = a_prev[..., :, None, :] - a[..., None, :, :]
    dec = torch.exp(dec.masked_fill(~below[..., None], float("-inf")))
    att = torch.einsum("bhctn,bhcsn,bhctsn->bhcts", r, k, dec)
    bonus = torch.einsum("bhctn,hn,bhctn->bhct", r, u, k)
    out = torch.einsum("bhcts,bhcsn->bhctn", att, v) + bonus[..., None] * v
    # across chunks: the state entering each chunk
    kd = k * torch.exp(a[..., -1:, :] - a)
    kv = torch.einsum("bhcsn,bhcsm->bhcnm", kd, v)
    carry = torch.exp(a[..., -1, :])           # [B, H, nc, N]
    s = torch.zeros((b, h, n, n), dtype=r.dtype, device=r.device)
    states = []
    for i in range(nc):
        states.append(s)
        s = carry[:, :, i, :, None] * s + kv[:, :, i]
    states = torch.stack(states, dim=2)        # [B, H, nc, N, N]
    out = out + torch.einsum("bhctn,bhcnm->bhctm", r * torch.exp(a_prev),
                             states)
    out = out.reshape(b, h, nc * c, n)[:, :, :t].transpose(1, 2)
    return out


def _shift(x):
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _time_mix(lw, x, m, prod):
    b, s, d = x.shape
    n = m["head_size"]
    h = d // n
    xx = _shift(x) - x
    xxx = x + xx * lw["mu_x"]
    lo = torch.tanh(prod("bsd,dt->bst", xxx, lw["lora_a"])).reshape(
        b, s, 5, m["tm_lora"])
    dd = prod("bsft,ftd->fbsd", lo, lw["lora_b"])
    mr, mk, mv, mw, mg = x[None] + xx[None] * (lw["mu"][:, None, None, :]
                                               + dd)
    r = prod("bsd,de->bse", mr, lw["wr"]).reshape(b, s, h, n)
    k = prod("bsd,de->bse", mk, lw["wk"]).reshape(b, s, h, n)
    v = prod("bsd,de->bse", mv, lw["wv"]).reshape(b, s, h, n)
    g = F.silu(prod("bsd,de->bse", mg, lw["wg"]))
    logw = -torch.exp(lw["w0"] + prod(
        "bst,td->bsd", torch.tanh(prod("bsd,dt->bst", mw, lw["w_a"])),
        lw["w_b"])).reshape(b, s, h, n)
    o = wkv(r, k, v, logw, lw["u"])
    mu = o.mean(-1, keepdim=True)
    var = ((o - mu) ** 2).mean(-1, keepdim=True)
    o = ((o - mu) * torch.rsqrt(var + m["gn_eps"])).reshape(b, s, d)
    o = o * lw["lnx_s"] + lw["lnx_b"]
    return prod("bsd,de->bse", o * g, lw["wo"])


def _channel_mix(lw, x, prod):
    xx = _shift(x) - x
    k = x + xx * lw["mu_ck"]
    r = x + xx * lw["mu_cr"]
    kk = torch.square(torch.relu(prod("bsd,df->bsf", k, lw["wck"])))
    return torch.sigmoid(prod("bsd,de->bse", r, lw["wcr"])) \
        * prod("bsf,fd->bsd", kk, lw["wcv"])


def _layer(lw, x, m, prod):
    x = x + _time_mix(lw, layer_norm(x, lw["ln1_s"], lw["ln1_b"],
                                     m["ln_eps"]), m, prod)
    return x + _channel_mix(lw, layer_norm(x, lw["ln2_s"], lw["ln2_b"],
                                           m["ln_eps"]), prod)


def loss_sums(w: dict, rows: dict, m: dict, prod):
    """(sum of next-token NLL over the rows, number of positions)."""
    tokens = rows["tokens"].long()
    x = w["embed"][tokens]
    x = layer_norm(x, w["ln0_s"], w["ln0_b"], m["ln_eps"])
    per_layer = [{f: w[f"layers.{f}"][i] for f in LAYER}
                 for i in range(m["n_layers"])]
    x = layers(_layer, per_layer, x, m, prod)
    y = layer_norm(x, w["lnf_s"], w["lnf_b"], m["ln_eps"])
    logits = prod("bsd,dv->bsv", y[:, :-1], w["head"])
    labels = tokens[:, 1:]
    return nll_sum(logits, labels), labels.numel()
