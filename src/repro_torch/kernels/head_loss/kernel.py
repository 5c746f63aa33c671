"""The f32 next-token loss over a buffer of logits, with the logits'
gradient written over them in place: a hand-written CUDA C++ kernel bound
with ctypes.

* **Replaces** no TPU kernel.  It replaces
  ``repro/models/common.py::cross_entropy`` (the f32 cast, ``logsumexp``,
  the gather and the mean) and its autograd on the port's training path,
  where the f32 copy of the logits and each of its passes made a tensor of
  N × V f32 (9.94 GB for internvl2-1b's 16,380 loss rows of 151,655).
* **Bound:** bytes.  The buffer read once and written once, 2·N·V_pad·2 B
  in bf16: 9.94 GB, 2.97 ms at 3.35 TB/s for internvl2-1b (V_pad
  151,680); 4.29 GB, 1.28 ms for rwkv6-1.6b (65,536).
* **Design** (``src/repro_torch/csrc/head_loss.cu``): one block a row.  A
  first pass keeps an online max and sum of exponentials in f32 over the
  row's V logits (the pad columns masked out), combined over the block in
  a fixed order; the second overwrites the row with
  (softmax − one-hot) · scale, rounded to the buffer's dtype once, and the
  pad columns with 0.  A row is read at most twice and written once.

For a CPU tensor the wrapper runs the plain version
(:func:`repro_torch.kernels.head_loss.ref.loss_rows_ref`); for a CUDA
tensor it launches the kernel or raises.  ``loss_rows.launches`` counts
kernel launches: one a training step.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.head_loss.ref import loss_rows_ref

#: The buffer's row length is a multiple of this many columns.
ALIGN = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
             + [ctypes.c_longlong] + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def _lib() -> ctypes.CDLL:
    lib = build.load("head_loss")
    fn = lib.head_loss_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _check(buf, v, labels, scale) -> None:
    if buf.ndim != 2 or buf.dtype not in _DTYPES:
        raise ValueError(f"buf must be a float32 or bfloat16 [N, V_pad], "
                         f"got {buf.dtype} {tuple(buf.shape)}")
    n, v_pad = buf.shape
    if v_pad % ALIGN or not 0 < v <= v_pad:
        raise ValueError(f"buf's {v_pad} columns must be a multiple of "
                         f"{ALIGN} holding the {v} logits")
    if buf.stride(1) != 1 or buf.stride(0) % ALIGN or buf.data_ptr() % 16:
        raise ValueError("buf's rows must be contiguous, 16-byte aligned "
                         f"and {ALIGN} columns' multiples apart")
    for name, t, dt in (("labels", labels, torch.int64),
                        ("scale", scale, torch.float32)):
        if tuple(t.shape) != (n,) or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} [{n}], got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != buf.device:
            raise ValueError(f"{name} is on {t.device}, buf on {buf.device}")


def loss_rows(buf: torch.Tensor, v: int, labels: torch.Tensor,
              scale: torch.Tensor, *, write_grad: bool = True
              ) -> torch.Tensor:
    """buf [N, V_pad] logits (columns from ``v`` on are pad; V_pad a
    multiple of :data:`ALIGN`, rows contiguous), labels [N] int64 in
    [0, v), scale [N] f32 -> nll [N] f32 (logsumexp − gold, in f32).  With
    ``write_grad`` the buffer then holds (softmax − one-hot) · scale in
    its dtype, pad columns 0."""
    _check(buf, v, labels, scale)
    dev = buf.device
    if dev.type == "cpu":
        return loss_rows_ref(buf, v, labels, scale, write_grad)
    if dev.type != "cuda":
        raise ValueError(f"loss_rows runs on cpu or cuda, not {dev}")
    n, v_pad = buf.shape
    nll = torch.empty((n,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib().head_loss_launch(
        buf.data_ptr(), labels.data_ptr(), scale.data_ptr(), nll.data_ptr(),
        n, v, v_pad, buf.stride(0), _DTYPES[buf.dtype], int(write_grad),
        stream)
    if rc != 0:
        raise RuntimeError(f"head_loss launch failed: CUDA error {rc}")
    loss_rows.launches += 1
    return nll


loss_rows.launches = 0
