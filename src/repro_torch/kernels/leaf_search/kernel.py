"""Leaf search on Hopper: a hand-written CUDA C++ kernel bound with ctypes.

* **Replaces** the Pallas TPU kernel
  ``repro/kernels/leaf_search/kernel.py::leaf_search`` and the gather of
  ``repro/kernels/leaf_search/ops.py::lookup_leaves`` around it: for each
  query lane, scan its unsorted leaf row for the first slot equal to the
  query and select that slot's value under the two-level version check
  (paper Fig. 9).
* **Two entries, one kernel body** (``src/repro_torch/csrc/leaf_search.cu``):
  :func:`leaf_search_pool` takes the node pool and int32 leaf ids and reads
  each lane's row where it lies in the pool (the main path's, through
  :func:`repro_torch.kernels.leaf_search.ops.lookup_leaves`);
  :func:`leaf_search` takes rows already gathered, the TPU kernel's own
  signature, which the tests hold against the Pallas kernel.
* **Bound:** latency, not bytes.  A pool lane needs its query and leaf id,
  its key row and 3 B of node fields, 6 B more where the row holds the
  query, and writes 6 B: about 45 KB at B=512, F=16, or about 13 ns at the
  H100's 3.35 TB/s, far below a launch and the dependent DRAM round trip
  to a cold pool row.
* **Design:** a group of F threads per lane (16 at F=16, so 2 lanes share
  a warp), one slot each; every load of the row (key, value, entry and
  node versions) is issued at once when the leaf id arrives, one memory
  round trip, and selected in registers; a ballot masked to the group
  takes the first match.  Variants (a warp per lane, a dependent select,
  lanes per block) are edited copies of the source timed by
  ``scripts/leaf_search_variant_timing.py``.

For CPU tensors the wrappers run the plain versions
(:mod:`repro_torch.kernels.leaf_search.ref`); for CUDA tensors they launch
the kernel or raise.  ``leaf_search.launches`` counts the kernel's
launches from either entry and ``leaf_search.launches_pool`` those of the
pool entry, so a run can show that its main path went through here.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.leaf_search.ref import (leaf_search_pool_ref,
                                                 leaf_search_ref)

#: Widest leaf row the kernel takes (the reference kernel's test shapes
#: go up to 64; the tree's own fanout is 16).
MAX_FANOUT = 256

_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int64, ctypes.c_int64,
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_void_p]
_I32, _U8, _BOOL = torch.int32, torch.uint8, torch.bool
#: dtypes of the pool entry's inputs: qkeys, leaf, keys, vals, fev, rev,
#: fnv, rnv, free_bit (the tree's own)
_POOL_DTYPES = (_I32, _I32, _I32, _I32, _U8, _U8, _U8, _U8, _BOOL)


def _lib() -> ctypes.CDLL:
    lib = build.load("leaf_search")
    fn = lib.leaf_search_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _launch(qkeys, leaf, keys, vals, fev, rev, fnv, rnv, free, n_rows):
    """Allocate the outputs and launch the kernel on the current stream;
    ``leaf`` None is the gathered-row entry, else the pool entry."""
    dev = qkeys.device
    b, f = qkeys.shape[0], keys.shape[1]
    value = torch.empty((b,), dtype=_I32, device=dev)
    found = torch.empty((b,), dtype=_BOOL, device=dev)
    consistent = torch.empty((b,), dtype=_BOOL, device=dev)
    if b == 0:
        return value, found, consistent
    rc = _lib().leaf_search_launch(
        qkeys.data_ptr(), None if leaf is None else leaf.data_ptr(),
        keys.data_ptr(), vals.data_ptr(), fev.data_ptr(), rev.data_ptr(),
        fnv.data_ptr(), rnv.data_ptr(), free.data_ptr(), value.data_ptr(),
        found.data_ptr(), consistent.data_ptr(), b, n_rows, f,
        fev.element_size(), fnv.element_size(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"leaf_search launch failed: CUDA error {rc}")
    leaf_search.launches += 1
    if leaf is not None:
        leaf_search.launches_pool += 1
    return value, found, consistent


def _check_device(tensors) -> str:
    """'cpu' or 'cuda' when every tensor lies there (and on one card)."""
    dev = tensors[0].device
    if dev.type == "cpu":
        if any(t.is_cuda for t in tensors):
            raise ValueError("leaf search inputs mix cpu and cuda tensors")
        return "cpu"
    if dev.type != "cuda":
        raise ValueError(f"leaf search runs on cpu or cuda, not {dev}")
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError(f"leaf search inputs must all lie on {dev}")
    return "cuda"


def leaf_search(qkeys, keys, vals, fev, rev, fnv, rnv, free):
    """The gathered-row entry: qkeys [B] int32; keys/vals [B, F] int32;
    fev/rev [B, F] uint8 or int32; fnv/rnv/free [B] int32.

    Returns (value [B] int32, found [B] bool, consistent [B] bool).
    """
    args = (qkeys, keys, vals, fev, rev, fnv, rnv, free)
    if keys.ndim != 2:
        raise ValueError(f"keys must be [B, F], got {tuple(keys.shape)}")
    b, f = keys.shape
    if b and not 1 <= f <= MAX_FANOUT:
        raise ValueError(f"fanout {f} outside 1..{MAX_FANOUT}")
    if fev.dtype not in (_U8, _I32) or (
            qkeys.dtype, keys.dtype, vals.dtype, rev.dtype, fnv.dtype,
            rnv.dtype, free.dtype) != (_I32, _I32, _I32, fev.dtype, _I32,
                                       _I32, _I32):
        raise TypeError("leaf_search takes int32 qkeys/keys/vals/fnv/rnv/"
                        "free and uint8 or int32 fev/rev, got "
                        f"{[a.dtype for a in args]}")
    if not (qkeys.shape == fnv.shape == rnv.shape == free.shape == (b,)
            and keys.shape == vals.shape == fev.shape == rev.shape):
        raise TypeError("leaf_search takes [B] qkeys/fnv/rnv/free and "
                        f"[B, F] rows, got {[tuple(a.shape) for a in args]}")
    if not all(a.is_contiguous() for a in args):
        raise ValueError("leaf_search inputs must be contiguous")
    if _check_device(args) == "cpu":
        return leaf_search_ref(*args)
    return _launch(qkeys, None, keys, vals, fev, rev, fnv, rnv, free, b)


def leaf_search_pool(qkeys, leaf, keys, vals, fev, rev, fnv, rnv, free_bit):
    """The pool entry: qkeys [B] int32 and leaf [B] int32 row ids into the
    pool's own tensors, keys/vals [N, F] int32, fev/rev [N, F] uint8,
    fnv/rnv [N] uint8 and free_bit [N] bool (:class:`TreeState`'s).  A
    leaf id is wrapped like a negative index and clamped to the pool, as
    JAX's gather does.

    Returns (value [B] int32, found [B] bool, consistent [B] bool).
    """
    args = (qkeys, leaf, keys, vals, fev, rev, fnv, rnv, free_bit)
    if tuple(a.dtype for a in args) != _POOL_DTYPES:
        raise TypeError("leaf_search_pool takes int32 qkeys/leaf/keys/vals, "
                        "uint8 fev/rev/fnv/rnv and bool free_bit, got "
                        f"{[a.dtype for a in args]}")
    n, f = keys.shape
    if not (qkeys.ndim == 1 and leaf.shape == qkeys.shape
            and keys.shape == vals.shape == fev.shape == rev.shape
            and fnv.shape == rnv.shape == free_bit.shape == (n,)):
        raise TypeError("leaf_search_pool takes [B] qkeys/leaf, [N, F] "
                        "rows and [N] node fields, got "
                        f"{[tuple(a.shape) for a in args]}")
    if not 1 <= f <= MAX_FANOUT or (n == 0 and qkeys.shape[0]):
        raise ValueError(f"pool of {n} rows of fanout {f}: need 1..."
                         f"{MAX_FANOUT} slots and a row per lookup")
    if not all(a.is_contiguous() for a in args):
        raise ValueError("leaf_search_pool inputs must be contiguous")
    if _check_device(args) == "cpu":
        return leaf_search_pool_ref(*args)
    return _launch(qkeys, leaf, keys, vals, fev, rev, fnv, rnv, free_bit, n)


leaf_search.launches = 0
leaf_search.launches_pool = 0
