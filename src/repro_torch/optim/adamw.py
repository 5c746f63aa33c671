"""AdamW with fp32 moments over bf16 params, plus cosine schedule and
global-norm clipping.  The port of :mod:`repro.optim.adamw`.

The parameters, gradients and moments are lists of tensors in the
reference's leaf order (a model's ``flat_params(api.param_tree(model))``,
a stacked leaf's layers in layer order).  :func:`update` computes the
reference's update in f32 (the reference leaves it to XLA outside any
kernel) and writes the new parameters and moments in place where the
reference returns new arrays: no second copy of the model or of its
moments exists.  On the card the norm and the update over the whole list
are the CUDA kernels of :mod:`repro_torch.kernels.adamw` (a handful of
launches a step, the schedule's and the clip's 0-d tensors read on the
device); on the CPU, their plain version, a loop over the tensors that
sums the norm's squares in the reference's leaf order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.kernels.adamw import kernel
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
    """sqrt of the sum of every leaf's sum of squares (None leaves, a
    weight the loss does not reach, add 0), as a 0-d f32 tensor."""
    with spans.span(spans.GRAD_NORM):
        return kernel.sumsq(tree)


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
    kernel.update(grads, state.m, state.v, params, lr, scale, bc1, bc2,
                  b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
                  weight_decay=cfg.weight_decay)
    return params, AdamWState(step=step, m=state.m, v=state.v), dict(
        loss=None, grad_norm=gn, lr=lr)
