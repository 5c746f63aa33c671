"""Plain float32 building blocks shared by the reference models, and the
reference's training step.

Every operation runs in float32 with TF32 off.  The weights are held at
the precision the configuration states for them (bfloat16: each update is
worked out in float32 and the new weight rounded to bfloat16, as a model
that stores bfloat16 weights must do) and read as float32.

``Products`` carries the precision of the model's products.  ``"f32"`` is
the reference.  ``"fp8"`` is its control, the model computed one step
below bfloat16: each operand of a product and its result are rounded to
float8 e4m3 with a per-tensor scale, the sums inside the product in
float32 (as a float8 product path would keep its operands and what it
writes).
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0      # largest finite float8 e4m3fn


def exact_f32() -> None:
    """Turn TF32 off for float32 products and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, as float32;
    the gradient passes straight through."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = FP8_MAX / amax
    q = (x.detach() * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (q - x.detach())


class Products:
    """The precision of a model's products: ``"f32"`` or ``"fp8"``."""

    def __init__(self, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision

    def __call__(self, eq: str, *ops: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp8":
            return _fp8_round(torch.einsum(eq, *(_fp8_round(x)
                                                 for x in ops)))
        return torch.einsum(eq, *ops)


def layer_norm(x, scale, bias, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def rms_norm(x, scale, eps):
    """RMS norm with the ``1 + scale`` gain (the scale starts at zero)."""
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1 + scale)


def rope(x, pos, theta):
    """Rotary embedding of x [B, S, H, hd] at positions pos [S]: the first
    and second halves of each head rotate against each other."""
    hd = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=x.device) / hd)
    ang = pos.float()[:, None] * freqs                      # [S, hd/2]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def nll_sum(logits, labels):
    """Sum over positions of -log softmax(logits)[label]."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (logz - gold).sum()


def layers(fn, per_layer: list, x, *args):
    """x through ``fn(layer, x, *args)`` for each layer's weights, each
    layer recomputed in the backward so that only its input is kept."""
    for lw in per_layer:
        if torch.is_grad_enabled():
            x = checkpoint(fn, lw, x, *args, use_reentrant=False)
        else:
            x = fn(lw, x, *args)
    return x


# --------------------------------------------------------------------------
# the training step
# --------------------------------------------------------------------------

def _leaf_norms(tensors: dict) -> dict:
    """{path: float32 norm over the leaf's parts}."""
    out = {}
    for path, parts in tensors.items():
        parts = parts if isinstance(parts, list) else [parts]
        out[path] = torch.sqrt(sum(torch.sum(p.double() ** 2)
                                   for p in parts)).float()
    return out


def lr_at(opt: dict, step: int) -> float:
    """The learning rate at ``step`` (1 for the first): linear warm-up,
    then a cosine down to ``min_lr_frac`` of ``lr`` at ``total_steps``."""
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    t = min(max((step - opt["warmup_steps"])
                / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0), 1.0)
    cos = opt["min_lr_frac"] + (1 - opt["min_lr_frac"]) * 0.5 * (
        1 + math.cos(math.pi * t))
    return opt["lr"] * warm * cos


class Trainer:
    """AdamW over a model's weights: float32 moments, global-norm
    clipping, bias correction and decoupled weight decay; the weights kept
    at ``weight_dtype`` (rounded after every update).

    ``weights`` is ``{path: tensor or [tensor a layer]}`` in float32;
    ``loss_sums(weights, rows) -> (nll_sum, count)`` is the model's loss
    over a block of batch rows (a dict of tensors [rows, ...])."""

    def __init__(self, weights: dict, loss_sums, opt: dict,
                 weight_dtype=torch.bfloat16, rows_per_block: int = 1):
        self.w = {p: [t.detach().clone().requires_grad_(True) for t in v]
                  if isinstance(v, list) else
                  v.detach().clone().requires_grad_(True)
                  for p, v in weights.items()}
        self.loss_sums = loss_sums
        self.opt = opt
        self.weight_dtype = weight_dtype
        self.rows_per_block = rows_per_block
        self.m = {p: [torch.zeros_like(t) for t in v] if isinstance(v, list)
                  else torch.zeros_like(v) for p, v in self.w.items()}
        self.v = {p: [torch.zeros_like(t) for t in v] if isinstance(v, list)
                  else torch.zeros_like(v) for p, v in self.w.items()}
        self.step_no = 0

    def _flat(self, tree: dict) -> list:
        return [t for v in tree.values()
                for t in (v if isinstance(v, list) else [v])]

    def grads(self, batch: dict, count: int):
        """The loss over the whole batch (the mean over ``count``
        positions) and every weight's gradient, summed over row blocks."""
        params = self._flat(self.w)
        for p in params:
            p.grad = None
        rows = next(iter(batch.values())).shape[0]
        total = 0.0
        for r0 in range(0, rows, self.rows_per_block):
            block = {k: v[r0:r0 + self.rows_per_block]
                     for k, v in batch.items()}
            nll, _ = self.loss_sums(self.w, block)
            (nll / count).backward()
            total += float(nll.detach())
        grads = {p: [t.grad if t.grad is not None else torch.zeros_like(t)
                     for t in v] if isinstance(v, list) else
                 (v.grad if v.grad is not None else torch.zeros_like(v))
                 for p, v in self.w.items()}
        return total / count, grads

    @torch.no_grad()
    def update(self, grads: dict) -> float:
        """One AdamW step; returns the clipping factor it applied to the
        gradients."""
        o = self.opt
        self.step_no += 1
        t = self.step_no
        lr = lr_at(o, t)
        gn = math.sqrt(sum(float(torch.sum(g.double() ** 2))
                           for g in self._flat(grads)))
        scale = min(o["clip_norm"] / (gn + 1e-9), 1.0)
        bc1 = 1 - o["b1"] ** t
        bc2 = 1 - o["b2"] ** t
        for w, g, m, v in zip(self._flat(self.w), self._flat(grads),
                              self._flat(self.m), self._flat(self.v)):
            g = g * scale
            m.mul_(o["b1"]).add_((1 - o["b1"]) * g)
            v.mul_(o["b2"]).add_((1 - o["b2"]) * g * g)
            delta = (m / bc1) / (torch.sqrt(v / bc2) + o["eps"]) \
                + o["weight_decay"] * w
            w.copy_((w - lr * delta).to(self.weight_dtype).float())
        return scale


def follow(trainer: Trainer, batches: list, count: int) -> dict:
    """The reference's readings over ``len(batches)`` steps: each step's
    loss, the first step's gradient norm a leaf as the optimizer gets it
    (clipped) and as the backward gives it (raw), and each leaf's change
    over all the steps (a norm)."""
    keep = lambda t: t.detach().to(trainer.weight_dtype, copy=True)  # exact
    w0 = {p: [keep(t) for t in v] if isinstance(v, list) else keep(v)
          for p, v in trainer.w.items()}
    losses = []
    grad = grad_raw = None
    for batch in batches:
        loss, grads = trainer.grads(batch, count)
        losses.append(loss)
        raw = _leaf_norms(grads)
        scale = trainer.update(grads)
        if grad is None:
            grad_raw = raw
            grad = {p: n * scale for p, n in raw.items()}
        del grads
    change = {}
    for p, v in trainer.w.items():
        parts = v if isinstance(v, list) else [v]
        base = w0[p] if isinstance(v, list) else [w0[p]]
        change[p] = _leaf_norms({p: [a.detach() - b.float()
                                     for a, b in zip(parts, base)]})[p]
    return dict(losses=losses, grad=grad, grad_raw=grad_raw, change=change)
