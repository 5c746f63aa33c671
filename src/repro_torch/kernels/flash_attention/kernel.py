"""Flash attention on Hopper: a hand-written CUDA C++ kernel bound with
ctypes.

* **Replaces** the Pallas TPU kernel
  ``repro/kernels/flash_attention/kernel.py::flash_attention``: causal or
  full grouped-query attention, online softmax with f32 running max, sum
  and accumulator, scale hd^-0.5, query head h reading KV head
  h // (H / KV), output in q's dtype.
* **Bound:** at the dense prefill's shapes, operations.  The function needs
  4·B·H·pairs·hd flops (pairs = unmasked (query, key) pairs, about
  Sq·Sk/2 when causal) against moving q, k, v and o once: at granite's
  B=4, S=4096, H=32, KV=8, hd=128 that is 5.50e11 flops (0.556 ms at the
  H100 SXM's 989 TFLOP/s bf16 tensor rate) against 335 MB (0.100 ms at
  3.35 TB/s).
* **Design:** simple and right first (``src/repro_torch/csrc/flash_attention.cu``):
  one 256-thread block per 64-row query tile and head, four threads per
  query row splitting the head dim, K/V tiles of 32 rows staged in shared
  memory as f32, causal tiles above the diagonal skipped, ragged Sq/Sk
  masked in the kernel.  It runs on the f32 FMA units; tensor cores
  (``wgmma``) and TMA are a later design.  Tensors are addressed through
  strides, so the model layout [B,S,H,hd] runs without a copy.

For a CPU tensor the wrapper runs the plain version
(:func:`repro_torch.kernels.flash_attention.ref.attention_ref`); for a CUDA
tensor it launches the kernel or raises.  ``flash_attention.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import attention_ref

#: Head dims the kernel is compiled for.
HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
             + [ctypes.c_int64] * 12
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _check(q, k, v, out) -> None:
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """q: [B, H, Sq, hd]; k, v: [B, KV, Sk, hd] -> [B, H, Sq, hd] in q's
    dtype, written into ``out`` when given.  Any strides with the head
    dim contiguous."""
    _check(q, k, v, out)
    dev = q.device
    if dev.type == "cpu":
        o = attention_ref(q, k, v, causal=causal)
        return o if out is None else out.copy_(o)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {dev}")
    if out is None:
        out = torch.empty(q.shape, dtype=q.dtype, device=dev)
    b, h, sq, hd = q.shape
    _, kvh, sk, _ = k.shape
    if out.numel() == 0:
        return out
    strides = []
    for t in (q, k, v, out):
        strides += [t.stride(0), t.stride(2), t.stride(1)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, kvh, sq, sk, hd, *strides, hd ** -0.5, int(causal),
        _DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
