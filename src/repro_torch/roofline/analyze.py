"""Roofline terms of one rank's program.  The port of
:mod:`repro.roofline.analyze`.

Three terms per (arch × shape × mesh), all in seconds (lower bounds):

* compute    = FLOPs (one rank's program) / the bf16 tensor-core rate
* memory     = bytes accessed (one rank's program) / HBM bytes/s
* collective = collective bytes (one rank's) / NVLink bytes/s a direction

The rates are the H100 SXM's (:mod:`repro_torch.launch.mesh`).  Where the
reference reads XLA's ``cost_analysis`` of the compiled, partitioned
module, :func:`analyze_program` runs the rank's program on fake tensors
(``FakeTensorMode``: shapes only, nothing allocated; the CPU route, so
attention and WKV6 are their plain versions) and counts FLOPs with
``torch.utils.flop_counter.FlopCounterMode`` (matmuls and convolutions),
bytes with a dispatch mode that sums each op's input and output bytes (a
view moves none), and collective bytes from what the program's
collectives move (:class:`CountingCollectives`).  :func:`collective_bytes`
is the reference's parser of XLA HLO text, kept as it is.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any

import torch
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.launch.mesh import (BF16_TENSOR_OPS_S, HBM_BYTES_S,
                                     NVLINK_BYTES_S)
from repro_torch.models.common import Layers

PEAK_FLOPS_BF16 = BF16_TENSOR_OPS_S
HBM_BW = HBM_BYTES_S
LINK_BW = NVLINK_BYTES_S

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute", "collective-broadcast")

_SHAPE_RE = re.compile(r"\b([a-z0-9]+)\[([0-9,]*)\]")
_OP_RE = re.compile(
    r"=\s+[a-z0-9]+\[[0-9,]*\][^=]*?\b(" + "|".join(COLLECTIVES)
    + r")(?:-start|-done)?\(")
_TUPLE_OP_RE = re.compile(
    r"=\s+\([^)]*\)[^=]*?\b(" + "|".join(COLLECTIVES)
    + r")(?:-start|-done)?\(")


def _shape_bytes(dtype: str, dims: str) -> int:
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 4)


def collective_bytes(hlo_text: str) -> dict:
    """Sum per-op-kind transfer bytes over the (per-device) HLO module."""
    out: dict[str, float] = {k: 0.0 for k in COLLECTIVES}
    counts: dict[str, int] = {k: 0 for k in COLLECTIVES}
    for line in hlo_text.splitlines():
        m = _OP_RE.search(line) or _TUPLE_OP_RE.search(line)
        if not m:
            continue
        kind = m.group(1)
        if f" {kind}-done(" in line or f"{kind}-done(" in line:
            continue  # count start/done pairs once (the -start carries data)
        sizes = [_shape_bytes(d, s) for d, s in _SHAPE_RE.findall(line)]
        if not sizes:
            continue
        out[kind] += max(sizes)
        counts[kind] += 1
    total = sum(out.values())
    return dict(per_kind=out, counts=counts, total=total)


def roofline(flops: float, bytes_accessed: float, coll_bytes: float,
             peak=PEAK_FLOPS_BF16, hbm=HBM_BW, ici=LINK_BW) -> dict:
    compute_s = flops / peak
    memory_s = bytes_accessed / hbm
    collective_s = coll_bytes / ici
    terms = dict(compute_s=compute_s, memory_s=memory_s,
                 collective_s=collective_s)
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    useful = max(compute_s, 1e-30)
    return dict(**terms, dominant=dominant, bound_s=bound,
                roofline_fraction=useful / bound if bound else 0.0)


def model_flops(n_params_active: float, tokens: float,
                training: bool) -> float:
    """6ND for training, 2ND for inference forward."""
    return (6.0 if training else 2.0) * n_params_active * tokens


# --------------------------------------------------------------------------
# one rank's program on fake tensors
# --------------------------------------------------------------------------

class CountingCollectives:
    """Stands in for :class:`repro_torch.launch.mesh.Collectives` in a
    counted program: each call gives a tensor of the collective's output
    shape (the inputs' values are not read) and counts the bytes the
    collective moves for this rank, the larger of its input and output, as
    :func:`collective_bytes` reads an HLO op."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.per_kind = {k: 0.0 for k in COLLECTIVES}
        self.counts = {k: 0 for k in COLLECTIVES}

    def _count(self, kind: str, n_bytes: int) -> None:
        self.per_kind[kind] += n_bytes
        self.counts[kind] += 1

    def gather_model(self, row: torch.Tensor) -> torch.Tensor:
        m = self.mesh.shape["model"]
        out = row.new_empty((m,) + tuple(row.shape))
        if m > 1:
            self._count("all-gather", out.numel() * out.element_size())
        return out

    def all_reduce(self, buf: torch.Tensor) -> torch.Tensor:
        if self.mesh.size > 1:
            self._count("all-reduce", buf.numel() * buf.element_size())
        return buf


#: ops that read and write no tensor's bytes
_NO_BYTES = ("aten::empty", "aten::empty_strided", "aten::empty_like",
             "aten::detach", "aten::lift_fresh", "aten::_local_scalar_dense")


class _ByteCount(TorchDispatchMode):
    """Sums each op's input and output tensor bytes (a view's none)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func._schema.name not in _NO_BYTES:
            self.bytes += sum(t.numel() * t.element_size()
                              for t in tree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        return out


def _tensor_bytes(obj, seen: set) -> int:
    """Bytes of the distinct tensors reachable from ``obj`` (lists,
    tuples, dicts, dataclasses, modules' parameters, ``Layers``)."""
    if isinstance(obj, torch.Tensor):
        if id(obj) in seen:
            return 0
        seen.add(id(obj))
        return obj.numel() * obj.element_size()
    if isinstance(obj, torch.nn.Module):
        return sum(_tensor_bytes(p, seen) for p in obj.parameters())
    if isinstance(obj, Layers):
        return _tensor_bytes(obj.parts, seen)
    if isinstance(obj, dict):
        return sum(_tensor_bytes(v, seen) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_tensor_bytes(v, seen) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return sum(_tensor_bytes(getattr(obj, f.name), seen)
                   for f in dataclasses.fields(obj))
    return 0


def analyze_program(fn, *fake_args, collectives: Any = None) -> dict:
    """Run ``fn(*fake_args)`` (fake tensors, inside the caller's
    ``FakeTensorMode``) and count it: FLOPs, bytes accessed, the bytes of
    ``collectives`` (the :class:`CountingCollectives` the program calls,
    read after the run), the tensors' bytes in and out, and the roofline
    of the three.  The keys are ``analyze_compiled``'s."""
    bytes_mode = _ByteCount()
    with FlopCounterMode(display=False) as fc, bytes_mode:
        out = fn(*fake_args)
    flops = float(fc.get_total_flops())
    per_kind = dict(collectives.per_kind) if collectives else \
        {k: 0.0 for k in COLLECTIVES}
    counts = dict(collectives.counts) if collectives else \
        {k: 0 for k in COLLECTIVES}
    coll = dict(per_kind=per_kind, counts=counts,
                total=sum(per_kind.values()))
    seen: set = set()
    mem = dict(argument_size_in_bytes=_tensor_bytes(fake_args, seen),
               output_size_in_bytes=_tensor_bytes(out, set()),
               temp_size_in_bytes=None, alias_size_in_bytes=None,
               generated_code_size_in_bytes=None)
    return dict(flops=flops, bytes_accessed=float(bytes_mode.bytes),
                collectives=coll, memory=mem,
                roofline=roofline(flops, bytes_mode.bytes, coll["total"]))
