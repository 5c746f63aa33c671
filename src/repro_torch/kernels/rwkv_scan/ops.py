"""Model-layout wrapper for the WKV6 kernel: the recurrence that
:func:`repro.models.rwkv6._time_mix_seq` scans over time, with its
gradient.

The kernel takes strides, so the [B,T,H,N] tensors are passed as
transposed views and the output is written in the model layout: no copy
on either side.  When a gradient is wanted, :class:`WKV6` runs the same
forward launch and, for the backward,
:func:`~repro_torch.kernels.rwkv_scan.kernel.wkv6_bwd` (the backward
kernel on a CUDA tensor, the plain version's autograd on a CPU tensor);
without one (the serving paths) no autograd node is made.

On fake tensors (``FakeTensorMode``: shapes only, as the dry-run planner
traces a rank's program) neither direction traces the recurrence, a
Python loop over time in the plain version: the outputs are made, the
kernel is not called, and the planner adds the recurrence's known cost
(``launch/dryrun.py::_rwkv_time_corrected``, as the reference adds it to
a scan XLA counts once).
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.kernels import tma_able
from repro_torch.kernels.rwkv_scan.kernel import wkv6, wkv6_bwd


def _time_second(*xs):
    """[B,T,H,N] views as [B,H,T,N]."""
    return tuple(x.transpose(1, 2) for x in xs)


def _forward(r, k, v, w, u) -> torch.Tensor:
    out = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    if not isinstance(r, FakeTensor):
        wkv6(*_time_second(r, k, v, w), u, out=out.transpose(1, 2))
    return out


class WKV6(torch.autograd.Function):
    """o = wkv6(r, k, v, w, u) in the model layout; the backward is K3's
    backward kernel (f32 gradients, cast to each input's dtype).  A dO
    the kernel's TMA cannot read (an expanded or offset gradient) is copied
    first, so the backward always launches the kernel on a CUDA tensor."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        ctx.save_for_backward(r, k, v, w, u)
        return _forward(r, k, v, w, u)

    @staticmethod
    def backward(ctx, do):
        r, k, v, w, u = ctx.saved_tensors
        grads = tuple(torch.empty(r.shape, dtype=torch.float32,
                                  device=r.device) for _ in range(4))
        if isinstance(r, FakeTensor):
            du = torch.empty(u.shape, dtype=torch.float32, device=u.device)
        else:
            if not tma_able(do):
                do = torch.empty(do.shape, dtype=do.dtype,
                                 device=do.device).copy_(do)
            *_, du = wkv6_bwd(*_time_second(r, k, v, w), u,
                              do.transpose(1, 2), grads=_time_second(*grads))
        return tuple(g.to(x.dtype) for g, x in zip((*grads, du),
                                                    (r, k, v, w, u)))


def wkv6_seq(r, k, v, w, u) -> torch.Tensor:
    """r/k/v/w: [B,T,H,N] (model layout); u: [H,N] -> [B,T,H,N] f32."""
    if torch.is_grad_enabled() and any(x.requires_grad
                                       for x in (r, k, v, w, u)):
        return WKV6.apply(r, k, v, w, u)
    return _forward(r, k, v, w, u)
