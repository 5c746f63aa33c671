"""Model-layout wrapper for the WKV6 kernel: the recurrence that
:func:`repro.models.rwkv6._time_mix_seq` scans over time.

The kernel takes strides, so the [B,T,H,N] tensors are passed as
transposed views and the output is written in the model layout: no copy
on either side.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rwkv_scan.kernel import wkv6


def wkv6_seq(r, k, v, w, u) -> torch.Tensor:
    """r/k/v/w: [B,T,H,N] (model layout); u: [H,N] -> [B,T,H,N] f32."""
    out = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    wkv6(*(x.transpose(1, 2) for x in (r, k, v, w)), u,
         out=out.transpose(1, 2))
    return out
