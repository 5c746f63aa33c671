"""Leaf search on Hopper: a hand-written CUDA C++ kernel bound with ctypes.

* **Replaces** the Pallas TPU kernel
  ``repro/kernels/leaf_search/kernel.py::leaf_search``: for each query lane,
  scan its own unsorted leaf row for the first slot equal to the query and
  select that slot's value under the two-level version check (paper Fig. 9).
* **Bound:** launch latency, not bytes.  Its inputs hold B·(10F+16) bytes
  (uint8 versions), but a lane needs only its key row and 16 B of node
  fields, one value and version pair where the row holds the query, and
  6 B of outputs: at most B·(4F+28) bytes, about 47 KB at B=512, F=16, or
  about 14 ns at the H100's 3.35 TB/s — far below the few microseconds a
  launch costs.
* **Design:** simple and right first (``src/repro_torch/csrc/leaf_search.cu``):
  one warp per query lane with the slots strided over its 32 threads,
  ``__ballot_sync`` + ``__ffs`` to take the first match of the lowest
  32-slot chunk, lane 0 writing the three outputs.  A later design gathers
  the rows from the pool inside the kernel (leaf ids in, no [B,F] copies).

For a CPU tensor the wrapper runs the plain version
(:func:`repro_torch.kernels.leaf_search.ref.leaf_search_ref`); for a CUDA
tensor it launches the kernel or raises.  ``leaf_search.launches`` counts
kernel launches, so a run can show that its main path went through here.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.leaf_search.ref import leaf_search_ref

#: Widest leaf row the kernel takes (the reference kernel's test shapes
#: go up to 64; the tree's own fanout is 16).
MAX_FANOUT = 256

_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int64, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_void_p]


def _lib() -> ctypes.CDLL:
    lib = build.load("leaf_search")
    fn = lib.leaf_search_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _check(qkeys, keys, vals, fev, rev, fnv, rnv, free) -> None:
    if keys.ndim != 2:
        raise ValueError(f"keys must be [B, F], got {tuple(keys.shape)}")
    b, f = keys.shape
    if b and not 1 <= f <= MAX_FANOUT:
        raise ValueError(f"fanout {f} outside 1..{MAX_FANOUT}")
    if fev.dtype not in (torch.uint8, torch.int32) or rev.dtype != fev.dtype:
        raise TypeError("fev/rev must both be uint8 or both int32, got "
                        f"{fev.dtype}/{rev.dtype}")
    want = dict(qkeys=((b,), torch.int32), keys=((b, f), torch.int32),
                vals=((b, f), torch.int32), fev=((b, f), fev.dtype),
                rev=((b, f), fev.dtype), fnv=((b,), torch.int32),
                rnv=((b,), torch.int32), free=((b,), torch.int32))
    got = dict(qkeys=qkeys, keys=keys, vals=vals, fev=fev, rev=rev, fnv=fnv,
               rnv=rnv, free=free)
    for name, (shape, dtype) in want.items():
        t = got[name]
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype} {shape}, got "
                            f"{t.dtype} {tuple(t.shape)}")
        if t.device != qkeys.device:
            raise ValueError(f"{name} is on {t.device}, qkeys on "
                             f"{qkeys.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def leaf_search(qkeys, keys, vals, fev, rev, fnv, rnv, free):
    """qkeys [B] int32; keys/vals [B, F] int32; fev/rev [B, F] uint8 or
    int32; fnv/rnv/free [B] int32.

    Returns (value [B] int32, found [B] bool, consistent [B] bool).
    """
    _check(qkeys, keys, vals, fev, rev, fnv, rnv, free)
    dev = qkeys.device
    if dev.type == "cpu":
        return leaf_search_ref(qkeys, keys, vals, fev, rev, fnv, rnv, free)
    if dev.type != "cuda":
        raise ValueError(f"leaf_search runs on cpu or cuda, not {dev}")
    b, f = keys.shape
    value = torch.empty((b,), dtype=torch.int32, device=dev)
    found = torch.empty((b,), dtype=torch.bool, device=dev)
    consistent = torch.empty((b,), dtype=torch.bool, device=dev)
    if b == 0:
        return value, found, consistent
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib().leaf_search_launch(
        qkeys.data_ptr(), keys.data_ptr(), vals.data_ptr(), fev.data_ptr(),
        rev.data_ptr(), fnv.data_ptr(), rnv.data_ptr(), free.data_ptr(),
        value.data_ptr(), found.data_ptr(), consistent.data_ptr(),
        b, f, fev.element_size(), stream)
    if rc != 0:
        raise RuntimeError(f"leaf_search launch failed: CUDA error {rc}")
    leaf_search.launches += 1
    return value, found, consistent


leaf_search.launches = 0
