"""The grouped product as an autograd op, for the dropless MoE dispatch
(``models/moe.py``).

:func:`grouped_mm` multiplies each group's rows of a sorted batch by its
expert's weight, the groups given by their cumulative ends on the device.
The backward is the same grouped kernel twice over: the rows' gradient
with the transposed weights (:func:`~repro_torch.kernels.moe_gmm.kernel.
gmm`), and each expert's weight gradient as a reduction over that
expert's rows (:func:`~repro_torch.kernels.moe_gmm.kernel.gmm_dw`).  Rows
past the last group get 0 forward and backward.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.moe_gmm.kernel import gmm, gmm_dw


class GroupedMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, w, ends):
        ctx.save_for_backward(a, w, ends)
        return gmm(a, w, ends)

    @staticmethod
    def backward(ctx, dc):
        a, w, ends = ctx.saved_tensors
        dc = dc.contiguous()
        da = gmm(dc, w.transpose(1, 2), ends) \
            if ctx.needs_input_grad[0] else None
        dw = gmm_dw(a, dc, ends) if ctx.needs_input_grad[1] else None
        return da, dw, None


def grouped_mm(a: torch.Tensor, w: torch.Tensor,
               ends: torch.Tensor) -> torch.Tensor:
    """a [M, K] sorted rows, w [G, K, N], ends [G] int32 the groups'
    cumulative ends -> [M, N]: group i's rows times ``w[i]``, rows past the
    groups 0."""
    return GroupedMM.apply(a, w, ends)
