"""Plain-torch version of the head-and-loss kernel
(:func:`repro_torch.kernels.head_loss.kernel.loss_rows`).

The CPU path runs it in place of the CUDA kernel, and the tests on the
card hold the kernel against it.  Its arithmetic is the f32 composition's
(``models/common.py::cross_entropy``) and that of the composition's
autograd for an incoming gradient of 1, op for op, so on the CPU it gives
the composition's bits.
"""
from __future__ import annotations

import torch


def loss_rows_ref(buf: torch.Tensor, v: int, labels: torch.Tensor,
                  scale: torch.Tensor, write_grad: bool = True
                  ) -> torch.Tensor:
    """buf [N, V_pad] logits (columns from ``v`` on are pad), labels [N]
    int64, scale [N] f32 (each row's weight in the loss: mask / count) ->
    nll [N] f32, the rows' logsumexp minus the gold logit.  With
    ``write_grad`` the buffer is overwritten with the loss's gradient
    (softmax − one-hot) · scale in its own dtype, pad columns 0."""
    x = buf[:, :v].float()
    logz = torch.logsumexp(x, dim=-1)
    idx = labels[:, None]
    nll = logz - torch.gather(x, -1, idx)[:, 0]
    if write_grad:
        # logsumexp's backward, then the gather's added at the label
        g = scale[:, None] * (x - logz[:, None]).exp()
        g.scatter_add_(-1, idx, -scale[:, None])
        buf[:, :v] = g
        buf[:, v:] = 0
    return nll
