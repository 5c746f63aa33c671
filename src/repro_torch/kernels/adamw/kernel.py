"""AdamW's step and its gradient norm over a whole list of leaves:
hand-written CUDA C++ kernels bound with ctypes.

* **Replaces** no TPU kernel.  The reference leaves AdamW to XLA
  (``repro/optim/adamw.py``); the port ran it as a Python loop of about
  21 PyTorch elementwise ops a leaf and the norm as a cast and a sum a
  leaf: 14,865 launches of rwkv6-1.6b's 23,764 a training step.
* **Bound:** bytes.  24 B a weight (the bf16 gradient read by the norm
  and again by the update, the bf16 weight and the f32 moments read and
  written): 38.4 GB, 11.46 ms at 3.35 TB/s, for rwkv6-1.6b's 1.60 B
  weights; 67.1 GB, 20.04 ms for the MoE cell's 2.80 B; 11.9 GB, 3.54 ms
  for internvl2-1b's 0.49 B.
* **Design** (``src/repro_torch/csrc/adamw.cu``): one block a chunk of
  65,536 elements of a leaf, every leaf of the list in one launch (up to
  640 leaves a launch, their table by value in the parameter space: no
  copy to the device), 16-byte accesses where a leaf's pointers allow.
  :func:`sumsq` writes one f64 partial a chunk and a one-block finalize
  sums them in a fixed order; :func:`update` reads g, p, m and v once and
  writes p, m and v once, in the plain loop's f32 arithmetic op for op.

For CPU tensors each wrapper runs its plain version
(:mod:`repro_torch.kernels.adamw.ref`); for CUDA tensors it launches its
kernels or raises.  ``sumsq.launches`` and ``update.launches`` count
launches (the norm's finalize included); ``update.leaves`` the leaves the
update kernel was given; ``update.copied`` the gradients that needed a
contiguous copy first (the sharded step's blocks of a dimension other
than the first).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.adamw import ops
from repro_torch.kernels.adamw.ref import global_norm_ref, update_ref

_P = ctypes.c_void_p
_INT = ctypes.c_int
_ARGTYPES = {
    "adamw_update_launch": [_INT] + [_P] * 11 + [ctypes.c_float] * 6 + [_P],
    "adamw_sumsq_launch": [_INT] + [_P] * 6,
    "adamw_sumsq_finalize_launch": [_P, _INT, _P, _P],
    "adamw_max_leaves": [],
    "adamw_chunk": [],
}


def _lib() -> ctypes.CDLL:
    lib = build.load("adamw")
    if lib.adamw_chunk.argtypes is None:
        for name, types in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = types
            fn.restype = ctypes.c_int
        got = (lib.adamw_chunk(), lib.adamw_max_leaves())
        if got != (ops.CHUNK, ops.MAX_LEAVES):
            raise RuntimeError(f"csrc/adamw.cu has chunk and table {got}, "
                               f"ops.py {(ops.CHUNK, ops.MAX_LEAVES)}")
    return lib


def _launched(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")


def _arrays(launch, table: ops.Table) -> list:
    """One launch's leaves as the C entry points take them: a numpy array
    each of the pointer columns, the element counts (int64), the first
    chunks (int32) and the kinds (uint8)."""
    idx = np.asarray(launch.leaves, dtype=np.int64)
    return [np.asarray(col, dtype=np.uint64)[idx] for col in table.ptrs] + [
        np.asarray(table.numels, dtype=np.int64)[idx],
        np.asarray(launch.first, dtype=np.int32),
        np.asarray(table.kinds, dtype=np.uint8)[idx]]


def _device(tensors, what: str) -> torch.device:
    """The first tensor's device, cpu or cuda (the tables check that the
    others are on it)."""
    dev = tensors[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, not {dev}")
    return dev


def sumsq(leaves) -> torch.Tensor:
    """sqrt of the sum of the squares of every element of ``leaves`` (None
    leaves add nothing), as a 0-d f32 tensor: the gradient's global
    norm.  On the card the sum is taken in f64 in a fixed order."""
    given = [x for x in leaves if x is not None]
    if not given or _device(given, "sumsq").type == "cpu":
        return global_norm_ref(given)
    dev = given[0].device
    table = ops.norm_table(given)
    launches = ops.plan(table.numels)
    partial = torch.empty((max(ops.blocks(launches), 1),),
                          dtype=torch.float64, device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for launch in launches:
        arrays = _arrays(launch, table)
        _launched(lib.adamw_sumsq_launch(
            len(launch.leaves), *[a.ctypes.data for a in arrays],
            partial.data_ptr() + 8 * launch.base, stream), "adamw_sumsq")
        sumsq.launches += 1
    _launched(lib.adamw_sumsq_finalize_launch(
        partial.data_ptr(), ops.blocks(launches), out.data_ptr(), stream),
        "adamw_sumsq_finalize")
    sumsq.launches += 1
    return out


def _scalar(x: torch.Tensor, dev: torch.device, name: str) -> torch.Tensor:
    if x.dtype != torch.float32 or x.numel() != 1:
        raise ValueError(f"{name} must be a 0-d float32 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    return x.to(dev)


def update(grads, ms, vs, params, lr, scale, bc1, bc2, *, b1: float,
           b2: float, eps: float, weight_decay: float) -> None:
    """One AdamW step in place over the lists of gradients (None: zero),
    first and second moments (f32) and weights (bf16 or f32; on the card
    the weights and moments contiguous): the plain
    loop's arithmetic (:func:`~repro_torch.kernels.adamw.ref.update_ref`).
    ``lr``, ``scale`` (the clip factor), ``bc1`` and ``bc2`` (the bias
    corrections) are 0-d f32 tensors, read by the kernel on the device."""
    if not params:
        return
    dev = _device(params, "update")
    if dev.type == "cpu":
        update_ref(grads, ms, vs, params, lr, scale, bc1, bc2, b1, b2, eps,
                   weight_decay)
        return
    table, copied = ops.update_table(grads, ms, vs, params)
    scalars = [_scalar(x, dev, name) for x, name in (
        (lr, "lr"), (scale, "scale"), (bc1, "bc1"), (bc2, "bc2"))]
    launches = ops.plan(table.numels)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for launch in launches:
        arrays = _arrays(launch, table)
        _launched(lib.adamw_update_launch(
            len(launch.leaves), *[a.ctypes.data for a in arrays],
            *[x.data_ptr() for x in scalars], b1, 1 - b1, b2, 1 - b2, eps,
            weight_decay, stream), "adamw_update")
        update.launches += 1
        update.leaves += len(launch.leaves)
    update.copied += copied


sumsq.launches = 0
update.launches = 0
update.leaves = 0
update.copied = 0
