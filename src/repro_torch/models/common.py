"""Shared model components: config, norms, rotary embeddings, init.

The port of :mod:`repro.models.common`.  Functions take tensors on an
explicit device and compute where their inputs lie; random init draws from
a ``torch.Generator`` that the caller passes.

The port keeps one module per layer where the reference stacks a leading
``L`` axis, so each model module also gives its weights in the
reference's tree (:class:`Layers` leaves, one per stacked reference leaf):
the optimizer walks them in the reference's leaf order
(:func:`flat_params`), and :func:`tree_to_host` stacks them for a gradient
check or a checkpoint.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.checkpoint.manager import tree_flatten
from repro_torch.kernels.head_loss.ops import head_loss as fused_head_loss
from repro_torch.obs import spans


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One unified config covering every assigned architecture family.

    The fields are the reference's, so the config files copy verbatim.
    ``unroll_layers``, ``attn_impl``, ``attn_chunk`` and ``rwkv_chunk`` are
    XLA lowering knobs there: they choose among schedules of one function.
    The port ignores them; its attention and WKV recurrence each have one
    route, a CUDA kernel on a CUDA tensor and its plain version on a CPU
    tensor.
    """

    name: str
    family: str                       # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                      # 0 for attention-free archs
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                 # derived when 0
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 1
    n_shared_experts: int = 0
    shared_expert_ff: int = 0
    moe_every: int = 1                # MoE layer stride (1 = every layer)
    capacity_factor: float = 1.25
    # --- recurrent / hybrid ---
    rwkv_head_dim: int = 64
    rg_lru_width: int = 0             # RG-LRU hidden width (0 => d_model)
    conv_width: int = 4
    window: int = 2048                # local-attention window (hybrid)
    attn_every: int = 3               # hybrid pattern: 1 attn per N blocks
    # --- enc-dec (audio) ---
    n_enc_layers: int = 0
    n_frames: int = 1500              # stubbed audio frame embeddings
    # --- vlm ---
    n_patches: int = 256              # stubbed vision patch embeddings
    # --- common ---
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    dtype: Any = torch.bfloat16
    # full-attention archs cannot run the 500k-token cell
    subquadratic: bool = False
    # --- the reference's lowering knobs, ignored by the port ---
    unroll_layers: bool = False
    attn_impl: str = "naive"
    attn_chunk: int = 1024
    moe_pad_experts: bool = False
    rwkv_chunk: int = 0

    # The port's own options (:data:`PORT_OPTIONS`) are plain class
    # attributes here, with :class:`PortArchConfig`'s defaults, so an
    # ArchConfig keeps the reference's fields one for one.

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def held_experts(self) -> int:
        """Routed experts this rank holds: ``n_experts / ep_size``."""
        if self.n_experts % self.ep_size or not 0 <= self.ep_rank \
                < self.ep_size:
            raise ValueError(f"{self.n_experts} experts cannot be shared "
                             f"by ep_size {self.ep_size} at rank "
                             f"{self.ep_rank}")
        return self.n_experts // self.ep_size

    def reduced(self, **overrides) -> "ArchConfig":
        """A smoke-test-sized config of the same family (CPU friendly)."""
        small = dict(
            n_layers=min(self.n_layers, 2),
            d_model=min(self.d_model, 64),
            n_heads=min(self.n_heads, 4) if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_ff=min(self.d_ff, 128),
            vocab=min(self.vocab, 512),
            n_experts=min(self.n_experts, 4),
            n_shared_experts=min(self.n_shared_experts, 1),
            shared_expert_ff=min(self.shared_expert_ff, 128),
            n_enc_layers=min(self.n_enc_layers, 2),
            n_frames=min(self.n_frames, 32),
            n_patches=min(self.n_patches, 8),
            window=min(self.window, 32),
            rg_lru_width=min(self.rg_lru_width, 64) if self.rg_lru_width
            else 0,
            rwkv_head_dim=min(self.rwkv_head_dim, 16),
            head_dim=0,
            dtype=torch.float32,
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclasses.dataclass(frozen=True)
class PortArchConfig(ArchConfig):
    """An :class:`ArchConfig` with the port's own options as fields, for
    a configuration the reference does not have (a published model's
    variant that needs them); ``dataclasses.replace`` takes them."""

    # each default is the reference's behaviour
    norm_topk_prob: bool = True       # renormalise the top-k gates to sum 1
    shared_expert_gate: bool = False  # the shared expert times sigmoid(x·w_sg)
    moe_dropless: bool = False        # sorted dispatch, no capacity or drop
    moe_router_f32: bool = True       # the router's weight in f32, else dtype
    ep_size: int = 1                  # expert-parallel ranks sharing a layer
    ep_rank: int = 0                  # this rank: experts [r·E/ep, (r+1)·E/ep)
    qkv_bias: bool = False            # biases on the q, k and v projections


#: The port's own options: :class:`PortArchConfig`'s fields past
#: :class:`ArchConfig`'s, which has each as a class attribute with the same
#: default.
PORT_OPTIONS = tuple(f.name for f in dataclasses.fields(PortArchConfig)
                     [len(dataclasses.fields(ArchConfig)):])
for _name in PORT_OPTIONS:
    setattr(ArchConfig, _name, getattr(PortArchConfig, _name))
del _name


# --------------------------------------------------------------------------
# numerics
# --------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    dt = x.dtype
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (y * (1.0 + scale.float())).to(dt)


def layer_norm(x, scale, bias, eps=1e-5):
    dt = x.dtype
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(dt)


def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float):
    """x: [..., S, H, hd]; pos: [..., S] absolute positions.  The halves
    rotate against each other (no interleaving)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                # [hd/2]
    ang = pos[..., None].float() * freqs                   # [..., S, hd/2]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def _normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Standard normal f32 drawn on the generator's device, then moved.
    On ``meta`` (a model's shapes, nothing allocated) nothing is drawn and
    ``gen`` may be None."""
    if torch.device(device or "cpu").type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    t = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return t.to(device)


def dense_init(gen: torch.Generator, shape, in_axis: int = -2,
               dtype=torch.bfloat16, device=None) -> torch.Tensor:
    std = 1.0 / math.sqrt(shape[in_axis])
    return _normal(gen, shape, device).mul_(std).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype=torch.bfloat16,
               device=None) -> torch.Tensor:
    return _normal(gen, shape, device).mul_(0.02).to(dtype)


def remat_layers(fn: Callable, layers, x: torch.Tensor,
                 *args) -> torch.Tensor:
    """``x`` through ``fn(layer, x, *args)`` for each of ``layers`` in
    turn.  When gradients are enabled, each call runs under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` over a
    layer): it keeps only its tensor inputs for the backward, which runs
    it again, so the values do not change.  No layer draws random numbers,
    so the RNG state is not saved and restored around each call.  Each
    call runs in the span ``rt/layer``, and its run again in the backward
    in ``rt/remat_replay`` (:func:`repro_torch.obs.spans.layer_span`)."""
    def layer(lp, x, *args):
        with spans.layer_span():
            return fn(lp, x, *args)

    remat = torch.is_grad_enabled()
    for lp in layers:
        if remat:
            x = checkpoint(layer, lp, x, *args, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = layer(lp, x, *args)
    return x


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token CE in fp32. logits [..., V], labels int [...].

    The reference's composition over full logits.  The training path
    takes :func:`head_loss` instead, which the tests hold to this."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1)
    return nll.mean()


def head_input(x: torch.Tensor) -> torch.Tensor:
    """``x``, the input of a model's final norm and head: the span
    ``rt/backward/head_loss``, opened by :func:`head_loss`'s backward,
    closes once ``x`` has its gradient."""
    spans.close_in_backward(x, spans.HEAD_LOSS_BACKWARD)
    return x


def head_loss(x: torch.Tensor, norm: Callable, w: torch.Tensor,
              tokens: torch.Tensor, *, prefix: int = 0,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The training path's mean f32 next-token loss: ``x`` [B, P+S, D],
    the last layer's output over ``prefix`` (P) rows and the S positions
    of ``tokens`` [B, S]; ``norm`` the final norm; ``w`` the head as
    [V, D]; ``mask`` [B, S−1] weights the positions that carry a loss.
    Only those rows, the text positions but the last, are normed and
    multiplied by the head, and the loss and the logits' gradient are one
    kernel (:class:`repro_torch.kernels.head_loss.ops.HeadLoss`): no f32
    copy of the logits exists.  The value of ``cross_entropy(logits[:, P:]
    [:, :-1], tokens[:, 1:], mask)`` over the full logits.  The norm and
    the head's product run in the span ``rt/head``, the loss in
    ``rt/loss`` inside it, and their backward in
    ``rt/backward/head_loss``."""
    with spans.span(spans.HEAD):
        h = norm(head_input(x)[:, prefix:-1])
        loss = fused_head_loss(h, w, tokens[:, 1:], mask)
    spans.open_in_backward(loss, spans.HEAD_LOSS_BACKWARD)
    return loss


def param(t: torch.Tensor) -> torch.nn.Parameter:
    """A model weight, trainable: ``loss`` takes its gradient, while the
    serving paths run under ``torch.inference_mode()`` and record none."""
    return torch.nn.Parameter(t, requires_grad=True)


def tensor_from_numpy(a, device) -> torch.Tensor:
    """A numpy array (ml_dtypes bfloat16 included), or a host tensor, as a
    tensor of the same dtype and values on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(device, copy=True)
    a = np.array(a)                 # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


# --------------------------------------------------------------------------
# the reference's parameter tree
# --------------------------------------------------------------------------

class Layers:
    """One leaf of the reference's tree stacked on a leading ``L`` axis:
    the port's per-layer tensors, in layer order.  ``like`` (a tensor, a
    ``meta`` one will do) gives a part's shape and dtype when there are no
    parts, as for a Griffin config without super-blocks."""

    def __init__(self, parts, like: Optional[torch.Tensor] = None):
        self.parts = list(parts)
        self.like = self.parts[0] if self.parts else like

    @property
    def shape(self) -> tuple:
        return (len(self.parts),) + tuple(self.like.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.like.dtype


def stack_fields(cls, mods, like=None):
    """``cls`` (a NamedTuple of a reference node's fields, in its order)
    whose every field is a
    :class:`Layers` of that tensor attribute over the modules ``mods``
    (``like``, a module of the same fields, stands in for a part when
    ``mods`` is empty); None where the attribute is None."""
    mods = list(mods)
    like = mods[0] if mods else like
    return cls(*(None if getattr(like, f) is None else
                 Layers([getattr(m, f) for m in mods], getattr(like, f))
                 for f in cls._fields))


def tree_map(fn: Callable, tree):
    """``tree`` with ``fn`` applied to each leaf (a tensor or a
    :class:`Layers`), in the reference's structure."""
    leaves, rebuild = tree_flatten(tree)
    return rebuild(iter([fn(x) for x in leaves]))


def flat_params(tree) -> list:
    """Every tensor of the tree in the reference's leaf order, a stacked
    leaf's layers in layer order."""
    leaves, _ = tree_flatten(tree)
    return [p for x in leaves
            for p in (x.parts if isinstance(x, Layers) else [x])]


def _to_host(t: torch.Tensor):
    """numpy, except bfloat16 (which numpy has no dtype for without
    ml_dtypes): a CPU tensor."""
    t = t.detach().cpu()
    return t if t.dtype == torch.bfloat16 else t.numpy()


def tree_to_host(tree, value: Callable = lambda p: p, dtype=None):
    """The reference's tree with each leaf stacked on the host: ``value(p)``
    of each part (a parameter, or its gradient, or its optimizer moment),
    as numpy (a bfloat16 leaf as a CPU tensor).  ``dtype`` is that of an
    empty stack's values (the parameters' when None)."""
    def leaf(x):
        if not isinstance(x, Layers):
            return _to_host(value(x))
        if not x.parts:
            return _to_host(torch.zeros(x.shape, dtype=dtype or x.dtype))
        return _to_host(torch.stack([value(p).detach().cpu()
                                     for p in x.parts]))
    return tree_map(leaf, tree)


@torch.no_grad()
def tree_from_host(tree, loaded, value: Callable = lambda p: p) -> None:
    """Copy ``loaded`` (the reference's tree on the host, as
    :func:`tree_to_host` gives it or a checkpoint restores it) into
    ``value(p)`` of each part of ``tree``, layer by layer."""
    leaves, _ = tree_flatten(tree)
    arrays, _ = tree_flatten(loaded)
    if len(arrays) != len(leaves):
        raise ValueError(f"{len(arrays)} leaves for a tree of "
                         f"{len(leaves)}")
    for x, a in zip(leaves, arrays):
        a = a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.asarray(a))
        if tuple(a.shape) != tuple(x.shape):
            raise ValueError(f"leaf of shape {tuple(a.shape)} for "
                             f"{tuple(x.shape)}")
        if isinstance(x, Layers):
            for i, p in enumerate(x.parts):
                value(p).copy_(a[i])
        else:
            value(x).copy_(a)
