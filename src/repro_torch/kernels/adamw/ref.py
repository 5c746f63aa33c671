"""Plain-torch versions of the AdamW kernels
(:func:`repro_torch.kernels.adamw.kernel.sumsq` and
:func:`~repro_torch.kernels.adamw.kernel.update`).

The CPU path runs them in place of the CUDA kernels, and the tests on the
card hold the kernels against them.  They are the optimizer's loop as it
was before the kernels, moved here op for op: ``update_ref`` on CUDA
tensors gives the bits the update kernel gives for the same norm.
"""
from __future__ import annotations

import torch


def global_norm_ref(leaves) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares, leaf by leaf in
    order (None leaves add 0)."""
    sq = sum(torch.sum(torch.square(x.float())) for x in leaves
             if x is not None)
    return torch.sqrt(torch.as_tensor(sq, dtype=torch.float32))


def update_ref(grads, ms, vs, params, lr, scale, bc1, bc2, b1: float,
               b2: float, eps: float, weight_decay: float) -> None:
    """One AdamW step in place over the lists, tensor by tensor in f32: a
    None gradient is zero.  ``lr``, ``scale`` (the clip factor), ``bc1``
    and ``bc2`` (the bias corrections) are 0-d f32 tensors."""
    for g, m, v, p in zip(grads, ms, vs, params):
        g = (torch.zeros_like(m) if g is None else g.float()) * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        p32 = p.float()
        delta = (m / bc1) / (torch.sqrt(v / bc2) + eps) \
            + weight_decay * p32
        p.copy_((p32 - lr * delta).to(p.dtype))
