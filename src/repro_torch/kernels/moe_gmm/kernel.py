"""The grouped matrix product over variable-sized expert groups, bf16 in
and f32 accumulation: hand-written CUDA C++ kernels bound with ctypes.

* **Replaces** no TPU kernel.  The reference batches its experts with
  capacity-bounded einsums that it leaves to XLA, which the port ran as
  ``torch.bmm`` over every expert at capacity.  A dropless dispatch sorts
  the (token, choice) pairs by expert, so each expert's rows are one run
  of the sorted rows whose length only the device knows; no library
  product takes such groups without a host sync.
* **Bound:** operations, nearly balanced with bytes.  At the
  ``train-qwen1.5-moe-a2.7b`` cell's shape (15 groups, 16,384 rows in
  all, D 2,048, F 1,408) a product does 2·M·D·F = 9.45e10 FLOPs, 95.5 µs
  at 989 TFLOP/s, and reads and writes (M·D + G·D·F + M·F)·2 B = 0.20 GB,
  59.6 µs at 3.35 TB/s.
* **Design** (``src/repro_torch/csrc/moe_gmm.cu``): ``wgmma`` fed by TMA,
  two consumer warpgroups and a producer warp a block, a ring of three
  64-deep stages.  :func:`gmm` (``moe_gmm_kernel``): one block a 128-row
  tile of one group and a 128-column block of the output; each block
  finds its tile from the groups' ends on the device, and the tiles past
  the groups exit at once, so the grid's size (an upper bound) needs no
  host read.  The weight may be a transposed view of a contiguous tensor
  (the rows' gradient), read K-major.  :func:`gmm_dw`
  (``moe_gmm_dw_kernel``): one block a (group, 128 × 128 block of the
  weight's gradient), summing the group's rows in slices of 64, the rows
  of the last slice past the group zeroed in shared memory; an empty
  group writes 0.  Nothing is added by atomics, so every call gives the
  same bits.

For a CPU tensor each wrapper runs its plain version
(:mod:`repro_torch.kernels.moe_gmm.ref`); for a CUDA tensor it launches
its kernel or raises.  ``gmm.launches`` and ``gmm_dw.launches`` count
launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.moe_gmm.ref import gmm_dw_ref, gmm_ref

_GMM_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_DW_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _lib() -> ctypes.CDLL:
    lib = build.load("moe_gmm")
    for fn, types in ((lib.moe_gmm_launch, _GMM_ARGTYPES),
                      (lib.moe_gmm_dw_launch, _DW_ARGTYPES)):
        if fn.argtypes is None:
            fn.argtypes = types
            fn.restype = ctypes.c_int
    return lib


def _launched(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")


def _check(a: torch.Tensor, other: torch.Tensor, ends: torch.Tensor,
           what: str) -> None:
    if a.ndim != 2:
        raise ValueError(f"{what}: a must be [M, K], got {tuple(a.shape)}")
    if ends.ndim != 1 or ends.dtype != torch.int32 \
            or not ends.is_contiguous():
        raise ValueError(f"{what}: ends must be a contiguous int32 [G], "
                         f"got {ends.dtype} {tuple(ends.shape)}")
    for name, t in (("other", other), ("ends", ends)):
        if t.device != a.device:
            raise ValueError(f"{what}: {name} is on {t.device}, a on "
                             f"{a.device}")
    if other.dtype != a.dtype:
        raise ValueError(f"{what}: dtypes {a.dtype} and {other.dtype}")
    if a.device.type == "cuda" and a.dtype != torch.bfloat16:
        raise ValueError(f"{what}: the kernel takes bfloat16, got "
                         f"{a.dtype}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, not {a.device}")
    if a.device.type == "cuda" and (a.shape[1] % 8 or other.shape[-1] % 8):
        raise ValueError(f"{what}: the kernel's widths are multiples of 8, "
                         f"got {a.shape[1]} and {other.shape[-1]}")


def gmm(a: torch.Tensor, w: torch.Tensor,
        ends: torch.Tensor) -> torch.Tensor:
    """a [M, K] rows sorted by group, w [G, K, N] (contiguous, or a
    transposed view of a contiguous [G, N, K]: the input's gradient; any
    other strides are copied), ends [G] int32 the groups' cumulative ends
    -> c [M, N] in a's dtype: group g's rows are ``a[rows] @ w[g]``, rows
    from ``ends[-1]`` on 0."""
    _check(a, w, ends, "gmm")
    if w.ndim != 3 or w.shape[0] != ends.shape[0] or w.shape[1] != a.shape[1]:
        raise ValueError(f"gmm: w {tuple(w.shape)} for a {tuple(a.shape)} "
                         f"and {ends.shape[0]} groups")
    if a.device.type == "cpu":
        return gmm_ref(a, w, ends)
    m, k = a.shape
    n = w.shape[2]
    a = a.contiguous()
    k_major = not w.is_contiguous() and w.transpose(1, 2).is_contiguous()
    if not k_major:
        w = w.contiguous()
    c = torch.zeros((m, n), dtype=a.dtype, device=a.device)
    _launched(_lib().moe_gmm_launch(
        a.data_ptr(), w.data_ptr(), c.data_ptr(), ends.data_ptr(), m, k, n,
        ends.shape[0], int(k_major),
        torch.cuda.current_stream(a.device).cuda_stream), "moe_gmm")
    gmm.launches += 1
    return c


def gmm_dw(a: torch.Tensor, d: torch.Tensor,
           ends: torch.Tensor) -> torch.Tensor:
    """a [M, K], d [M, N], ends [G] int32 -> dw [G, K, N] in a's dtype:
    each group's ``a[rows]ᵀ @ d[rows]`` summed in f32, 0 for an empty
    group."""
    _check(a, d, ends, "gmm_dw")
    if d.ndim != 2 or d.shape[0] != a.shape[0]:
        raise ValueError(f"gmm_dw: d {tuple(d.shape)} for a "
                         f"{tuple(a.shape)}")
    if a.device.type == "cpu":
        return gmm_dw_ref(a, d, ends)
    m, k = a.shape
    n = d.shape[1]
    a, d = a.contiguous(), d.contiguous()
    dw = torch.empty((ends.shape[0], k, n), dtype=a.dtype, device=a.device)
    _launched(_lib().moe_gmm_dw_launch(
        a.data_ptr(), d.data_ptr(), dw.data_ptr(), ends.data_ptr(), m, k, n,
        ends.shape[0], torch.cuda.current_stream(a.device).cuda_stream),
        "moe_gmm_dw")
    gmm_dw.launches += 1
    return dw


gmm.launches = 0
gmm_dw.launches = 0
