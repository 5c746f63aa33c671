"""The WKV6 recurrence on Hopper: a hand-written CUDA C++ kernel bound with
ctypes.

* **Replaces** the Pallas TPU kernel
  ``repro/kernels/rwkv_scan/kernel.py::wkv6``: per (batch, head),
  o_t = r_t (S_{t-1} + diag(u) k_tᵀ v_t) and
  S_t = diag(w_t) S_{t-1} + k_tᵀ v_t with an [N, N] f32 state; f32 or bf16
  in, f32 out.
* **Bound:** bytes.  r, k, v, w in and o out once each (5·B·H·T·N·4 B in
  f32: 671 MB, 0.200 ms at 3.35 TB/s for RWKV6-1.6B's B=4, T=4096, H=32,
  N=64) against about 4·N² flops per token and head (8.6e9 flops, 0.128 ms
  at the H100 SXM's 67 TFLOP/s f32 rate).
* **Design** (``src/repro_torch/csrc/wkv6.cu``): one block per (batch,
  head) in two roles.  Compute warps split the state into register tiles
  (8 rows × 4 columns at N = 64: 128 threads, a warp on each of an SM's
  four schedulers at RWKV6-1.6B's shape) and store each step's partial
  output, sum over their rows of r_t S_{t-1}; output warps, a chunk
  behind, fold u's term into one scalar a step (o_t = r_t S_{t-1} +
  v_t c_t with c_t = Σ r_t u k_t), sum the row groups' partials in a
  fixed order and store each chunk's rows of o as 16-byte stores.  Time
  runs in chunks of :data:`CHUNK` steps that one thread stages with TMA
  into a ring of shared-memory stages on mbarriers, so the step loop
  reads only shared memory and registers and takes no barrier.  Tensors
  are addressed through strides, so the model layout [B,T,H,N] runs
  without a copy; TMA needs every stride of a dim longer than 1, and every
  base, 16-byte aligned (the output's too, for its 16-byte stores).

For a CPU tensor the wrapper runs the plain version
(:func:`repro_torch.kernels.rwkv_scan.ref.wkv6_ref`); for a CUDA tensor it
launches the kernel or raises.  ``wkv6.launches`` counts kernel launches.

:func:`wkv6_bwd` is the gradient, dr, dk, dv, dw and du, in f32
(``csrc/wkv6_bwd.cu``; the TPU kernel has no backward, and the reference
differentiates its ``lax.scan``), one CUDA kernel a call with one CTA a
(b, h): a forward sweep stores the state every :data:`BWD_CHUNK` steps in
f32 checkpoints, and a backward sweep recomputes each chunk's states from
its checkpoint into registers and runs the chunk's steps backwards, its
chunks staged with TMA as the forward's.  dv's row sums are summed in
shared memory, du's batch entries here, each in a fixed order; there is
no scratch but the checkpoints.  It takes f32 only (what
``models/rwkv6.py`` passes) and raises on anything else.
``wkv6_bwd.launches`` counts its calls (one CUDA kernel each).  For a CPU
tensor it runs the plain version
(:func:`repro_torch.kernels.rwkv_scan.ref.wkv6_bwd_ref`).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, check_tma
from repro_torch.kernels.rwkv_scan.ref import wkv6_bwd_ref, wkv6_ref

#: State widths the kernel is compiled for.
HEAD_SIZES = (16, 32, 64)
#: Time steps a shared-memory stage holds (``kChunk`` in ``csrc/wkv6.cu``).
CHUNK = 32
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
             + [ctypes.c_int64] * 6 + [ctypes.c_int, ctypes.c_void_p])
#: Time steps between the backward's state checkpoints (``kChunk`` in
#: ``csrc/wkv6_bwd.cu``).
BWD_CHUNK = 16
_BWD_ARGTYPES = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 4
                 + [ctypes.c_void_p] * 2)


def _lib() -> ctypes.CDLL:
    lib = build.load("wkv6")
    fn = lib.wkv6_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = build.load("wkv6_bwd")
    fn = lib.wkv6_bwd_launch
    if fn.argtypes is None:
        fn.argtypes = _BWD_ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _check(r, k, v, w, u, out) -> None:
    if r.ndim != 4:
        raise ValueError(f"r must be [B, H, T, N], got {tuple(r.shape)}")
    b, h, t, n = r.shape
    if r.dtype not in _DTYPES:
        raise TypeError(f"inputs must be float32 or bfloat16, not {r.dtype}")
    for name, x in (("k", k), ("v", v), ("w", w)):
        if x.shape != r.shape or x.dtype != r.dtype:
            raise ValueError(f"{name} must be {r.dtype} {tuple(r.shape)}, "
                             f"got {x.dtype} {tuple(x.shape)}")
        # a dim of length 1 is never stepped along (see _strides)
        if any(a != c for a, c, d in zip(x.stride(), r.stride(), r.shape)
               if d > 1):
            raise ValueError(f"{name} must share r's strides")
    if tuple(u.shape) != (h, n) or u.dtype != r.dtype:
        raise ValueError(f"u must be {r.dtype} {(h, n)}, got {u.dtype} "
                         f"{tuple(u.shape)}")
    if n not in HEAD_SIZES:
        raise ValueError(f"head size {n} not in {HEAD_SIZES}")
    tensors = [("r", r), ("k", k), ("v", v), ("w", w), ("u", u)]
    if out is not None:
        if out.shape != r.shape or out.dtype != torch.float32:
            raise ValueError(f"out must be float32 {tuple(r.shape)}")
        tensors.append(("out", out))
    for name, x in tensors:
        if x.device != r.device:
            raise ValueError(f"{name} is on {x.device}, r on {r.device}")
        if x.stride(-1) != 1:
            raise ValueError(f"{name}'s last dim must be contiguous")
    if not u.is_contiguous():
        raise ValueError("u must be contiguous")


def _strides(x: torch.Tensor) -> list[int]:
    """(batch, head, time) element strides; a dim of length 1 is never
    stepped along, so its stride is replaced by one TMA takes."""
    return [x.stride(d) if x.shape[d] > 1 else x.shape[3] for d in range(3)]


def wkv6(r, k, v, w, u, *, out: torch.Tensor | None = None) -> torch.Tensor:
    """r/k/v/w: [B, H, T, N] (shared strides, N contiguous); u: [H, N]
    -> o [B, H, T, N] float32, written into ``out`` when given."""
    _check(r, k, v, w, u, out)
    dev = r.device
    if dev.type == "cpu":
        o = wkv6_ref(r, k, v, w, u)
        return o if out is None else out.copy_(o)
    if dev.type != "cuda":
        raise ValueError(f"wkv6 runs on cpu or cuda, not {dev}")
    if out is None:
        out = torch.empty(r.shape, dtype=torch.float32, device=dev)
    b, h, t, n = r.shape
    if out.numel() == 0:
        return out
    check_tma((("r", r), ("k", k), ("v", v), ("w", w), ("out", out)))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib().wkv6_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        out.data_ptr(), b, h, t, n, *_strides(r), *_strides(out),
        _DTYPES[r.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"wkv6 launch failed: CUDA error {rc}")
    wkv6.launches += 1
    return out


wkv6.launches = 0


def wkv6_bwd(r, k, v, w, u, do, *, grads: tuple | None = None) -> tuple:
    """The gradient of :func:`wkv6`: r/k/v/w [B, H, T, N] (shared strides,
    N contiguous), u [H, N], do [B, H, T, N] the output's gradient ->
    (dr, dk, dv, dw, du) in f32, dr..dw written into ``grads`` (four
    [B, H, T, N] f32 tensors, N contiguous) when given.  On the card one
    kernel computes dr..dw and du's per-batch partials; its only scratch
    is the call's checkpoints, B·H·(⌈T/BWD_CHUNK⌉ − 1)·N²·4 bytes; r, k,
    v, w, do and the four gradients must be TMA-able (16-byte aligned
    bases and strides), or it raises."""
    _check(r, k, v, w, u, do)
    dev = r.device
    if dev.type == "cpu":
        got = wkv6_bwd_ref(r, k, v, w, u, do)
        if grads is None:
            return got
        return (*(g.copy_(x) for g, x in zip(grads, got)), got[4])
    if dev.type != "cuda":
        raise ValueError(f"wkv6_bwd runs on cpu or cuda, not {dev}")
    if r.dtype != torch.float32:
        raise TypeError(f"wkv6_bwd takes float32 inputs, not {r.dtype}")
    b, h, t, n = r.shape
    if grads is None:
        grads = tuple(torch.empty(r.shape, dtype=torch.float32, device=dev)
                      for _ in range(4))
    for name, g in zip(("dr", "dk", "dv", "dw"), grads):
        if g.shape != r.shape or g.dtype != torch.float32 or g.device != dev:
            raise ValueError(f"{name} must be float32 {tuple(r.shape)} on "
                             f"{dev}")
        if g.stride(-1) != 1:
            raise ValueError(f"{name}'s last dim must be contiguous")
    du_part = torch.empty((b, h, n), dtype=torch.float32, device=dev)
    if r.numel() == 0:
        for g in grads:
            g.zero_()
        return (*grads, du_part.sum(0) if b else u.new_zeros(u.shape))
    check_tma((("r", r), ("k", k), ("v", v), ("w", w), ("do", do),
               *zip(("dr", "dk", "dv", "dw"), grads)))
    n_ck = -(-t // BWD_CHUNK)
    # the state at the start of every chunk but the last (the kernel's
    # forward sweep ends there, and goes on from its registers)
    ckpt = torch.empty((b, h, max(n_ck - 1, 0), n, n), dtype=torch.float32,
                       device=dev)
    strides = (ctypes.c_int64 * 18)(*[
        st for x in (r, do, *grads) for st in _strides(x)])
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _bwd_lib().wkv6_bwd_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        do.data_ptr(), *(g.data_ptr() for g in grads), du_part.data_ptr(),
        ckpt.data_ptr(), b, h, t, n, strides, stream)
    if rc != 0:
        raise RuntimeError(f"wkv6_bwd launch failed: CUDA error {rc}")
    wkv6_bwd.launches += 1
    # du: the batch's partials summed in order
    du = du_part[0].clone()
    for i in range(1, b):
        du += du_part[i]
    return (*grads, du)


wkv6_bwd.launches = 0


def wkv6_bwd_occupancy(n: int) -> dict:
    """The backward kernel at head size ``n`` on the current card: its
    dynamic shared memory a CTA and the CTAs an SM holds (CUDA's occupancy
    calculator)."""
    vals = [ctypes.c_int() for _ in range(2)]
    fn = _bwd_lib().wkv6_bwd_occupancy
    fn.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 2
    rc = fn(n, *(ctypes.byref(x) for x in vals))
    if rc != 0:
        raise RuntimeError(f"wkv6_bwd occupancy query failed: CUDA error {rc}")
    return dict(zip(("smem_bytes", "ctas_an_sm"), (x.value for x in vals)))


def wkv6_bwd_scratch_bytes(b: int, h: int, t: int, n: int) -> int:
    """Device bytes :func:`wkv6_bwd` allocates for a call on the card
    besides its outputs: the state checkpoints and du's per-batch
    partials."""
    return 4 * (b * h * (-(-t // BWD_CHUNK) - 1) * n * n + b * h * n)
