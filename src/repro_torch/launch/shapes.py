"""Assigned input-shape cells and their ``meta``-device stand-ins.  The port
of :mod:`repro.launch.shapes`.

Every LM-family arch pairs with four shapes; ``decode_*`` / ``long_*`` run
``decode_step`` (one token against a seq_len KV cache / recurrent state),
not the train step.  ``long_500k`` requires sub-quadratic attention and is
skipped (with a reason) for pure full-attention archs.  Where the
reference gives ``ShapeDtypeStruct``s from ``eval_shape``, the port gives
tensors on the ``meta`` device: shapes and dtypes, nothing allocated.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.checkpoint.manager import tree_flatten
from repro_torch.models import registry
from repro_torch.models.common import ArchConfig
from repro_torch.models.registry import ModelAPI


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def cell_supported(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("full O(L^2) attention at 524288 tokens — "
                       "sub-quadratic archs only (DESIGN.md §6)")
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """``meta`` stand-ins for the data batch (no allocation)."""
    out = {"tokens": _meta((shape.batch, shape.seq), torch.int32)}
    if cfg.family == "audio":
        out["frames"] = _meta((shape.batch, cfg.n_frames, cfg.d_model),
                              torch.float32)
    if cfg.family == "vlm":
        out["patches"] = _meta((shape.batch, cfg.n_patches, cfg.d_model),
                               torch.float32)
    return out


def params_specs(api: ModelAPI):
    """The model on ``meta`` (``api.init`` draws nothing there), in the
    reference's tree (``api.param_tree``: stacked leaves' ``.shape`` with
    ``L``).  ``api`` may be built on any device."""
    meta = registry.build(api.cfg, device="meta")
    return meta.param_tree(meta.init(None))


def decode_state_specs(api: ModelAPI, shape: ShapeSpec):
    """The decode state's ``meta`` stand-ins.  ``decode_init`` runs on a
    model of fake CPU tensors (``FakeTensorMode``: shapes only, nothing
    drawn or allocated; whisper's runs its encoder, whose attention takes
    its plain version there), and each leaf is given as a ``meta``
    tensor.  (The reference also takes the parameters' stand-ins, which
    its ``eval_shape`` traces; the fake model takes their place.)"""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = api.cfg
    tok = batch_specs(cfg, dataclasses.replace(shape, seq=1))
    with FakeTensorMode():
        cpu = registry.build(cfg, device="cpu")
        state = cpu.decode_init(
            cpu.init(torch.Generator()),
            {k: torch.empty(v.shape, dtype=v.dtype) for k, v in tok.items()},
            shape.seq)
    leaves, rebuild = tree_flatten(state)
    return rebuild(iter([_meta(x.shape, x.dtype)
                         if isinstance(x, torch.Tensor) else x
                         for x in leaves]))


def token_spec(shape: ShapeSpec) -> torch.Tensor:
    return _meta((shape.batch,), torch.int32)
