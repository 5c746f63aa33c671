"""AdamW with fp32 moments over bf16 params, plus cosine schedule and
global-norm clipping.  The port of :mod:`repro.optim.adamw`.

The parameters, gradients and moments are lists of tensors in the
reference's leaf order (a model's ``flat_params(api.param_tree(model))``,
a stacked leaf's layers in layer order), so :func:`global_norm` sums the
squares in the reference's order.  :func:`update` computes the
reference's update in f32, tensor by tensor, in plain PyTorch (the
reference leaves it to XLA outside any kernel), and writes the new
parameters and moments in place where the reference returns new arrays:
no second copy of the model or of its moments exists.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.obs import spans


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor     # int32, 0-d
    m: list                # f32, one tensor a parameter
    v: list


def init(params) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    dev = params[0].device if params else None
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=[zeros(p) for p in params],
                      v=[zeros(p) for p in params])


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an int tensor), in f32."""
    step = torch.as_tensor(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares, leaf by leaf in
    order (None leaves, a weight the loss does not reach, add 0)."""
    with spans.span(spans.GRAD_NORM):
        sq = sum(torch.sum(torch.square(x.float())) for x in tree
                 if x is not None)
        return torch.sqrt(torch.as_tensor(sq, dtype=torch.float32))


@torch.no_grad()
def update(cfg: AdamWConfig, grads, state: AdamWState, params,
           grad_norm=None):
    """One AdamW step: ``params`` and the state's moments are updated in
    place; returns ``(params, new state, info)`` as the reference does.
    A None gradient is zero (the reference's gradient of an unused
    leaf).  ``grad_norm``, the whole gradient's norm, is given where
    ``grads``, ``params`` and the moments are one rank's blocks of them
    (the sharded train step); else it is ``global_norm(grads)``."""
    with spans.span(spans.OPTIMIZER):
        return _update(cfg, grads, state, params, grad_norm)


def _update(cfg: AdamWConfig, grads, state: AdamWState, params, grad_norm):
    step = state.step + 1
    lr = schedule(cfg, step)
    gn = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.clip_norm / (gn + 1e-9), max=1.0)
    stepf = step.float()
    bc1 = 1 - cfg.b1 ** stepf
    bc2 = 1 - cfg.b2 ** stepf
    for g, m, v, p in zip(grads, state.m, state.v, params):
        g = (torch.zeros_like(m) if g is None else g.float()) * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        p32 = p.float()
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) \
            + cfg.weight_decay * p32
        p.copy_((p32 - lr * delta).to(p.dtype))
    return params, AdamWState(step=step, m=state.m, v=state.v), dict(
        loss=None, grad_norm=gn, lr=lr)
