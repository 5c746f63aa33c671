"""Plain-torch versions of the WKV6 kernel (mirrors
:mod:`repro.kernels.rwkv_scan.ref`: a loop over time) and of its gradient.

The CPU path runs them in place of the CUDA kernels, and ``chip_smoke.py``
holds the kernels against them on the card.
"""
from __future__ import annotations

import torch


def wkv6_ref(r, k, v, w, u):
    """r/k/v/w: [B, H, T, N]; u: [H, N] -> o [B, H, T, N] (fp32)."""
    b, h, t, n = r.shape
    r32, k32, v32, w32 = (x.float() for x in (r, k, v, w))
    u32 = u.float()
    s = torch.zeros((b, h, n, n), dtype=torch.float32, device=r.device)
    out = torch.empty((b, h, t, n), dtype=torch.float32, device=r.device)
    for i in range(t):
        rt, kt, vt, wt = (x[:, :, i] for x in (r32, k32, v32, w32))
        kv = kt[..., :, None] * vt[..., None, :]           # [B, H, N, N]
        out[:, :, i] = ((s + u32[None, :, :, None] * kv)
                        * rt[..., :, None]).sum(-2)
        s = wt[..., :, None] * s + kv
    return out


def wkv6_bwd_ref(r, k, v, w, u, do):
    """The gradient of :func:`wkv6_ref` by autograd: (dr, dk, dv, dw, du)
    of ``<wkv6_ref(r, k, v, w, u), do>``, in f32 (the last step's w
    reaches no output: its gradient is zero)."""
    with torch.enable_grad():
        leaves = [x.detach().float().requires_grad_(True)
                  for x in (r, k, v, w, u)]
        out = wkv6_ref(*leaves)
        return torch.autograd.grad(out, leaves, do.float(),
                                   allow_unused=True, materialize_grads=True)
