"""Flash attention on Hopper: a hand-written CUDA C++ kernel bound with
ctypes.

* **Replaces** the Pallas TPU kernel
  ``repro/kernels/flash_attention/kernel.py::flash_attention``: causal or
  full grouped-query attention, online softmax with f32 running max, sum
  and accumulator, scale hd^-0.5, query head h reading KV head
  h // (H / KV), output in q's dtype; and the sliding window of the
  reference's ``_sdpa_naive``/``_sdpa_chunked``
  (``repro/models/attention.py``), which that kernel lacks: row i sees
  key j unless causal and j > i, or a window is set and i - j >= window.
* **Bound:** at the dense prefill's shapes, operations.  The function needs
  4·B·H·pairs·hd flops (pairs = unmasked (query, key) pairs, about
  Sq·Sk/2 when causal) against moving q, k, v and o once: at granite's
  B=4, S=4096, H=32, KV=8, hd=128 that is 5.50e11 flops (0.556 ms at the
  H100 SXM's 989 TFLOP/s bf16 tensor rate) against 335 MB (0.100 ms at
  3.35 TB/s).
* **Two routes, one entry point** (``csrc/flash_attention.cu``), picked
  by :func:`_route` from the dtype, the head dim and the window:

  - ``"wgmma"`` — bf16 at hd 64 and 128 without a window
    (``csrc/flash_attention_wgmma.cuh``),
    FlashAttention-3's shape: a persistent block per SM walks 128-row
    query tiles (the longest causal ones first); two consumer warpgroups
    of 64 rows and a producer warpgroup whose one thread loads Q and K/V
    tiles of 128 keys with TMA into a ring of shared-memory stages
    (mbarrier full/empty pairs, 128-byte swizzle, zero fill past Sq/Sk);
    S = Q·Kᵀ and O += P·V on ``wgmma``, the online softmax on S's
    accumulator fragments while the previous tile's P·V runs, the two
    warpgroups taking turns on the tensor cores.  P is rounded to bf16 as
    the P·V product's A operand; m, l and the accumulator stay f32.
  - ``"fma"`` — every other call: f32 at every head dim, bf16 at hd 16,
    32 and 256, and every windowed call: one 256-thread block
    per query tile and head, four threads per row (64-row tiles, K/V
    tiles of 32 rows) or eight at hd 256 (32-row tiles, K/V tiles of 16
    rows), K/V as f32 in shared memory, P kept in f32, on the f32 FMA
    units (f32 must stay within 2e-5 of the plain version, which TF32
    tensor cores cannot give); the key loop visits only the tiles that
    the window and the causal mask leave visible to some row of the
    query tile.  The window is a template flag of the kernel, so calls
    without one run no window code.

  Tensors are addressed through strides, so the model layout [B,S,H,hd]
  runs without a copy; the ``wgmma`` route's TMA needs every stride of a
  dim longer than 1, and every base address, 16-byte aligned.

For a CPU tensor the wrapper runs the plain version
(:func:`repro_torch.kernels.flash_attention.ref.attention_ref`); for a CUDA
tensor it launches the route's kernel or raises: no route is taken on
failure.  ``flash_attention.launches`` counts kernel launches,
``launches_wgmma`` and ``launches_fma`` each route's.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, check_tma
from repro_torch.kernels.flash_attention.ref import attention_ref

#: Head dims the kernels are compiled for (the ``fma`` route's).
HEAD_DIMS = (16, 32, 64, 128, 256)
#: Head dims of the ``wgmma`` route (bf16 only).
WGMMA_HEAD_DIMS = (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTES = {"fma": 0, "wgmma": 1}

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
             + [ctypes.c_int64] * 12
             + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def _route(dtype: torch.dtype, hd: int, window: int = 0) -> str:
    """The kernel a CUDA call takes: ``"wgmma"`` for bf16 at hd 64 and
    128 without a window, ``"fma"`` otherwise."""
    if dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS and not window:
        return "wgmma"
    return "fma"


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _check(q, k, v, out, window: int) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.ndim != 4:
            raise ValueError(f"{name} must be 4-d, got {tuple(t.shape)}")
    b, h, sq, hd = q.shape
    _, kvh, sk, _ = k.shape
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k, v must share a dtype, float32 or bfloat16; "
                        f"got {q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if kvh == 0 or h % kvh:
        raise ValueError(f"{h} query heads are not a multiple of {kvh} "
                         "KV heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if sq and not sk:
        raise ValueError("attention over no keys")
    if window < 0:
        raise ValueError(f"window {window} must be >= 0")
    tensors = [("q", q), ("k", k), ("v", v)]
    if out is not None:
        if out.shape != q.shape or out.dtype != q.dtype:
            raise ValueError(f"out must be {q.dtype} {tuple(q.shape)}")
        tensors.append(("out", out))
    for name, t in tensors:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous")


def _strides(t: torch.Tensor) -> list[int]:
    """(batch, seq, head) element strides; a dim of length 1 is never
    stepped along, so its stride is replaced by one any route takes."""
    return [t.stride(d) if t.shape[d] > 1 else t.shape[3]
            for d in (0, 2, 1)]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """q: [B, H, Sq, hd]; k, v: [B, KV, Sk, hd] -> [B, H, Sq, hd] in q's
    dtype, written into ``out`` when given.  Any strides with the head
    dim contiguous.  ``window`` 0 is none."""
    _check(q, k, v, out, window)
    dev = q.device
    if dev.type == "cpu":
        o = attention_ref(q, k, v, causal=causal, window=window)
        return o if out is None else out.copy_(o)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {dev}")
    if out is None:
        out = torch.empty(q.shape, dtype=q.dtype, device=dev)
    b, h, sq, hd = q.shape
    _, kvh, sk, _ = k.shape
    if out.numel() == 0:
        return out
    route = _route(q.dtype, hd, window)
    tensors = (("q", q), ("k", k), ("v", v), ("out", out))
    if route == "wgmma":
        check_tma(tensors)
    strides = [st for _, t in tensors for st in _strides(t)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, kvh, sq, sk, hd, *strides, hd ** -0.5, int(causal), window,
        _DTYPES[q.dtype], _ROUTES[route], stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed on the {route} "
                           f"route: CUDA error {rc}")
    flash_attention.launches += 1
    if route == "wgmma":
        flash_attention.launches_wgmma += 1
    else:
        flash_attention.launches_fma += 1
    return out


flash_attention.launches = 0
flash_attention.launches_wgmma = 0
flash_attention.launches_fma = 0
