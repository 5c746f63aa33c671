"""Shared model components: config, norms, rotary embeddings, init.

The port of :mod:`repro.models.common`.  Functions take tensors on an
explicit device and compute where their inputs lie; random init draws from
a ``torch.Generator`` that the caller passes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch


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

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

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
    """Standard normal f32 drawn on the generator's device, then moved."""
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


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token CE in fp32. logits [..., V], labels int [...]."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1)
    return nll.mean()


def param(t: torch.Tensor) -> torch.nn.Parameter:
    """A model weight: the serving paths need no gradient."""
    return torch.nn.Parameter(t, requires_grad=False)


def tensor_from_numpy(a, device) -> torch.Tensor:
    """A numpy array (ml_dtypes bfloat16 included) as a tensor of the same
    dtype and values on ``device``."""
    a = np.array(a)                 # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)
