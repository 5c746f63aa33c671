"""The head's product and its f32 next-token loss as one autograd op, for
the training path (``models/common.py::head_loss``).

:class:`HeadLoss` takes the normed hidden states of the positions that
carry a loss, h [N, D], the head as [V, D] (the tied embedding, or a
transposed view of an untied [D, V] head), the labels and an optional
mask, and returns the mean f32 negative log-likelihood, as
``common.cross_entropy`` over the logits does.  Its forward writes the
logits into one buffer [N, V_pad], V_pad the next multiple of
:data:`~repro_torch.kernels.head_loss.kernel.ALIGN` (64) columns, so every
row of the buffer starts on a 16-byte boundary and cuBLAS takes Hopper's
kernels, forward and in both backward products; a head whose V is not such
a multiple is copied with zero rows for the step (V alone decides).  The
loss kernel (:func:`~repro_torch.kernels.head_loss.kernel.loss_rows`)
then overwrites the buffer with the logits' gradient, which the backward
multiplies into dh = dlogits · W and dW = dlogitsᵀ · h, one product each
over all N rows (cuBLAS sums over the rows in f32), scaled by the incoming
gradient; the pad rows of dW are dropped.  Without a gradient wanted
(grad mode off, or no input requiring one) the buffer is only read.

On fake tensors (``FakeTensorMode``: the dry-run planner traces a rank's
program) the products are traced and counted, and the loss kernel is not
called.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.kernels.head_loss.kernel import ALIGN, loss_rows
from repro_torch.obs import spans


def padded(v: int) -> int:
    """The buffer's row length for a vocabulary of ``v``: the next
    multiple of :data:`ALIGN`."""
    return -(-v // ALIGN) * ALIGN


def _transposed(w: torch.Tensor) -> bool:
    """Whether the [V, D] head ``w`` is a view of a [D, V] weight (its
    vocabulary runs along memory)."""
    return w.stride(1) != 1


def pad_vocab(w: torch.Tensor) -> torch.Tensor:
    """The [V, D] head ``w`` with zero rows up to :func:`padded` (V), in
    the layout it has: ``w`` itself when V is a multiple of
    :data:`ALIGN`, else a copy."""
    v, d = w.shape
    vp = padded(v)
    if vp == v:
        return w
    if _transposed(w):
        out = w.new_empty((d, vp))
        out[:, :v] = w.T
        out[:, v:] = 0
        return out.T
    out = w.new_empty((vp, d))
    out[:v] = w
    out[v:] = 0
    return out


def _mean(nll: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return nll.mean()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1)


def _row_scale(n: int, mask: Optional[torch.Tensor], device) -> torch.Tensor:
    """Each row's weight in the mean, as :func:`_mean`'s autograd gives it
    for an incoming gradient of 1: 1/N, or (1 / count) · mask."""
    one = torch.ones((), dtype=torch.float32, device=device)
    if mask is None:
        return (one / n).expand(n).contiguous()
    return ((one / torch.clamp(mask.sum(), min=1)) * mask).float() \
        .contiguous()


class HeadLoss(torch.autograd.Function):
    """mean f32 NLL of (h · Wᵀ) at ``labels``: h [N, D], w [V, D], labels
    [N], mask [N] or None; ``write``: a backward will follow, so the loss
    kernel writes the logits' gradient over them and they are kept.  The
    loss kernel runs in the span ``rt/loss``."""

    @staticmethod
    def forward(ctx, h, w, labels, mask, write):
        n, v = h.shape[0], w.shape[0]
        wp = pad_vocab(w)
        buf = h @ wp.T                                  # [N, V_pad] logits
        with spans.span(spans.LOSS):
            labels = labels.long().contiguous()
            if isinstance(buf, FakeTensor):
                nll = buf.new_empty((n,), dtype=torch.float32)
            else:
                nll = loss_rows(buf, v, labels,
                                _row_scale(n, mask, buf.device),
                                write_grad=write)
            loss = _mean(nll, mask)
        if write:
            ctx.save_for_backward(h, wp, buf)
            ctx.v, ctx.transposed = v, _transposed(w)
        return loss

    @staticmethod
    def backward(ctx, g):
        h, wp, dlogits = ctx.saved_tensors
        v = ctx.v
        dh = dw = None
        if ctx.needs_input_grad[0]:
            dh = (dlogits @ wp).mul_(g)
        if ctx.needs_input_grad[1]:
            hg = h * g
            if ctx.transposed:
                dw = (hg.T @ dlogits)[:, :v].T
            else:
                dw = (dlogits.T @ hg)[:v]
        return dh, dw, None, None, None


def head_loss(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The mean f32 next-token loss of the head ``w`` [V, D] over the
    normed rows ``h`` [..., D] at ``labels`` [...], weighted by ``mask``
    [...] when given (the mean over its sum, at least 1).  Under
    ``no_grad`` or ``inference_mode`` (an eval loss), or with neither
    ``h`` nor ``w`` requiring a gradient, the logits are only read."""
    d = h.shape[-1]
    write = torch.is_grad_enabled() and (h.requires_grad or w.requires_grad)
    return HeadLoss.apply(h.reshape(-1, d), w, labels.reshape(-1),
                          None if mask is None else mask.reshape(-1), write)
