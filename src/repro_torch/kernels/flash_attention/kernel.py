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
  3.35 TB/s); at recurrentgemma's local attention (B=4, H=10, KV=1,
  S=4096, hd=256, window 2048) 2.58e11 flops (0.261 ms) against 185 MB.
* **Two routes, one entry point** (``csrc/flash_attention.cu``), picked
  by :func:`_route` from the dtype and the head dim:

  - ``"wgmma"`` — bf16 at hd 64, 128 and 256, with or without a window
    (``csrc/flash_attention_wgmma.cuh``),
    FlashAttention-3's shape: a persistent block per SM walks 128-row
    query tiles (the longest causal ones first); two consumer warpgroups
    of 64 rows and a producer warpgroup whose one thread loads Q and K/V
    tiles with TMA into a ring of shared-memory stages (mbarrier
    full/empty pairs, 128-byte swizzle, zero fill past Sq/Sk): 128 keys
    a tile at hd 64 (4 stages) and 128 (2), 64 keys at hd 256 (2 stages,
    192 KB with Q; S = Q·Kᵀ as 16 ``m64n64k16``, O += P·V as 4
    ``m64n256k16``); S = Q·Kᵀ and O += P·V on ``wgmma``, the online
    softmax on S's accumulator fragments while the previous tile's P·V
    runs, the two warpgroups taking turns on the tensor cores.  P is
    rounded to bf16 as the P·V product's A operand; m, l and the
    accumulator stay f32.  The window is a template flag: a windowed
    item's key loop starts at the tile of its first row's first key, the
    element mask also runs on the window's lower edge tiles, and an item
    holding a row that sees no key visits every key, so that row
    averages them as the reference's softmax over NEG_INF does.
  - ``"fma"`` — f32 at every head dim and bf16 at hd 16 and 32, windowed
    or not: one 256-thread block per query tile and head, four threads
    per row (64-row tiles, K/V tiles of 32 rows) or eight at hd 256
    (32-row tiles, K/V tiles of 16 rows), K/V as f32 in shared memory, P
    kept in f32, on the f32 FMA units (f32 must stay within 2e-5 of the
    plain version, which TF32 tensor cores cannot give); the key loop
    visits only the tiles that the window and the causal mask leave
    visible to some row of the query tile.  The window is a template
    flag of this kernel too.

  Tensors are addressed through strides, so the model layout [B,S,H,hd]
  runs without a copy; the ``wgmma`` route's TMA needs every stride of a
  dim longer than 1, and every base address, 16-byte aligned.

For a CPU tensor the wrapper runs the plain version
(:func:`repro_torch.kernels.flash_attention.ref.attention_ref`); for a CUDA
tensor it launches the route's kernel or raises: no route is taken on
failure.  ``flash_attention.launches`` counts kernel launches,
``launches_wgmma`` and ``launches_fma`` each route's.

With ``lse=`` (f32 [B, H, Sq]) the ``wgmma`` route also writes each
row's log-sum-exp of its scaled logits (a template flag of the kernel,
so a call without it runs the flagless code): the input of the
backward's ``wgmma`` route (for a CPU tensor
:func:`~repro_torch.kernels.flash_attention.ref.attention_lse_ref`).

:func:`flash_attention_bwd` is the gradient, dQ, dK and dV
(``csrc/flash_attention_bwd.cu``; the TPU kernel has no backward, and the
reference differentiates its jnp attention).  Two routes, picked by
:func:`_bwd_route` from the dtype and the head dim, no window changing it:

  ===========================  =========  =====================================
  dtype, head dim              route      kernels
  ===========================  =========  =====================================
  bf16 at hd 64, 128 and 256   ``wgmma``  ``csrc/flash_attention_bwd_wgmma.cuh``
  f32 at every hd; bf16 at     ``fma``    ``csrc/flash_attention_bwd.cu``
  hd 16 and 32
  ===========================  =========  =====================================

- ``"wgmma"`` takes the forward's ``lse`` (required): a row pass writes
  D = dO·o and lse·log2(e) into f32 scratch padded to 128 rows, then one
  kernel a key tile (a TMA producer ringing 64-row Q and dO tiles of each
  query head of the group) runs Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, then
  dV += Pᵀ·dO and dK += dSᵀ·Q on ``wgmma``: at hd 64 and 128 a 128-key
  tile, each of two consumer warpgroups running all four products on its
  64 keys; at hd 256, where dK and dV would take 256 registers a thread,
  a 64-key tile whose warpgroups split them (one Sᵀ, Pᵀ and dV, the other
  dPᵀ, dSᵀ and dK, Pᵀ handed over in f32 through shared memory).  Then
  one kernel a 128-row query tile runs S, dP and dQ += dS·K, the
  forward's shape with one more product (key tiles of 128, 64 and 32 at
  hd 64, 128 and 256).  Seven products of hd a pair and no atomics: each
  output row is written by one block.
- ``"fma"`` recomputes each row's softmax max and sum and D in a row pass,
  then sums dK and dV a key tile at a time over the group's query heads
  and dQ a query tile at a time, on the f32 FMA units (f32 within 2e-5).

``flash_attention_bwd.launches`` counts its calls (three CUDA kernels
each), ``launches_wgmma`` and ``launches_fma`` each route's.  For a CPU
tensor it runs the route's plain version
(:func:`~repro_torch.kernels.flash_attention.ref.attention_bwd_lse_ref`
on ``wgmma``, :func:`~repro_torch.kernels.flash_attention.ref.
attention_bwd_ref` on ``fma``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, check_tma
from repro_torch.kernels.flash_attention.ref import (attention_bwd_lse_ref,
                                                      attention_bwd_ref,
                                                      attention_lse_ref,
                                                      attention_ref)

#: Head dims the wrapper takes (f32 runs each on the ``fma`` route).
HEAD_DIMS = (16, 32, 64, 128, 256)
#: Head dims of the ``wgmma`` route (bf16 only, with or without a window).
WGMMA_HEAD_DIMS = (64, 128, 256)
#: Head dims of the backward's ``wgmma`` route (bf16 only), where the
#: forward writes its log-sum-exp: every head dim of the forward's.
BWD_WGMMA_HEAD_DIMS = (64, 128, 256)
#: Rows of the backward ``wgmma`` route's scratch are Sq rounded up to this
#: (``kPad`` of ``csrc/flash_attention_bwd_wgmma.cuh``, whose kernels read
#: whole 64- and 128-row tiles of it).
BWD_ROW_PAD = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTES = {"fma": 0, "wgmma": 1}

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
             + [ctypes.c_int64] * 12
             + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                 + [ctypes.c_void_p, ctypes.c_float] + [ctypes.c_int] * 4
                 + [ctypes.c_void_p])


def _route(dtype: torch.dtype, hd: int, window: int = 0) -> str:
    """The kernel a CUDA call takes: ``"wgmma"`` for bf16 at hd 64, 128
    and 256, with or without a window; ``"fma"`` otherwise.  ``window``
    does not change the route (both kernels take one)."""
    del window
    if dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "fma"


def _bwd_route(dtype: torch.dtype, hd: int, window: int = 0) -> str:
    """The kernels a CUDA call of :func:`flash_attention_bwd` takes:
    ``"wgmma"`` for bf16 at hd 64, 128 and 256, with or without a window;
    ``"fma"`` otherwise (f32 stays on the FMA units, within 2e-5; bf16 at
    hd 16 and 32 is below the tensor cores' 64-wide tiles).  ``window``
    does not change the route."""
    del window
    if dtype == torch.bfloat16 and hd in BWD_WGMMA_HEAD_DIMS:
        return "wgmma"
    return "fma"


def _check_lse(lse: torch.Tensor, q: torch.Tensor) -> None:
    """Raise unless ``lse`` is f32 [B, H, Sq], contiguous, on q's device."""
    b, h, sq, _ = q.shape
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, sq):
        raise ValueError(f"lse must be float32 {(b, h, sq)}, got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    if lse.device != q.device:
        raise ValueError(f"lse is on {lse.device}, q on {q.device}")
    if not lse.is_contiguous():
        raise ValueError("lse must be contiguous")


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = build.load("flash_attention_bwd")
    fn = lib.flash_attention_bwd_launch
    if fn.argtypes is None:
        fn.argtypes = _BWD_ARGTYPES
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
                    out: torch.Tensor | None = None,
                    lse: torch.Tensor | None = None) -> torch.Tensor:
    """q: [B, H, Sq, hd]; k, v: [B, KV, Sk, hd] -> [B, H, Sq, hd] in q's
    dtype, written into ``out`` when given.  Any strides with the head
    dim contiguous.  ``window`` 0 is none.  ``lse``, f32 [B, H, Sq]
    contiguous, receives each row's log-sum-exp where the backward's
    ``wgmma`` route reads it (bf16 at hd 64, 128 and 256)."""
    _check(q, k, v, out, window)
    if lse is not None:
        if _bwd_route(q.dtype, q.shape[3], window) != "wgmma":
            raise ValueError("lse is written only for the backward's wgmma "
                             "route: bf16 at head dims "
                             f"{BWD_WGMMA_HEAD_DIMS}")
        _check_lse(lse, q)
    dev = q.device
    if dev.type == "cpu":
        o = attention_ref(q, k, v, causal=causal, window=window)
        if lse is not None:
            lse.copy_(attention_lse_ref(q, k, causal=causal, window=window))
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
        None if lse is None else lse.data_ptr(),
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


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        grads: tuple | None = None,
                        lse: torch.Tensor | None = None) -> tuple:
    """The gradient of :func:`flash_attention`: q, o, do [B, H, Sq, hd];
    k, v [B, KV, Sk, hd]; o the forward's output and do its gradient ->
    (dq, dk, dv) in q's dtype, written into ``grads`` (three tensors of
    q's, k's and v's shapes) when given.  Any strides with the head dim
    contiguous.  ``lse`` is the forward's log-sum-exp (f32 [B, H, Sq]):
    required on the ``wgmma`` route, refused on the ``fma`` route."""
    _check(q, k, v, o, window)
    _check(q, k, v, do, window)
    route = _bwd_route(q.dtype, q.shape[3], window)
    if route == "wgmma":
        if lse is None:
            raise ValueError("the backward's wgmma route (bf16 at head dims "
                             f"{BWD_WGMMA_HEAD_DIMS}) needs the forward's lse")
        _check_lse(lse, q)
    elif lse is not None:
        raise ValueError("the backward's fma route takes no lse")
    dev = q.device
    if dev.type == "cpu":
        if route == "wgmma":
            got = attention_bwd_lse_ref(q, k, v, o, do, lse, causal=causal,
                                        window=window)
        else:
            got = attention_bwd_ref(q, k, v, do, causal=causal,
                                    window=window)
        if grads is None:
            return got
        return tuple(g.copy_(x) for g, x in zip(grads, got))
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cpu or cuda, not {dev}")
    if grads is None:
        grads = tuple(torch.empty(t.shape, dtype=q.dtype, device=dev)
                      for t in (q, k, v))
    for name, g, t in zip(("dq", "dk", "dv"), grads, (q, k, v)):
        if g.shape != t.shape or g.dtype != q.dtype or g.device != dev:
            raise ValueError(f"{name} must be {q.dtype} {tuple(t.shape)} on "
                             f"{dev}")
        if g.stride(3) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous")
    b, h, sq, hd = q.shape
    _, kvh, sk, _ = k.shape
    if q.numel() == 0 or k.numel() == 0:
        for g in grads:
            g.zero_()
        return grads
    tensors = (q, k, v, o, do, *grads)
    if route == "wgmma":
        check_tma(zip(("q", "k", "v", "o", "do", "dq", "dk", "dv"), tensors))
        sq_pad = -(-sq // BWD_ROW_PAD) * BWD_ROW_PAD
        stats = torch.empty((2, b, h, sq_pad), dtype=torch.float32,
                            device=dev)
    else:
        stats = torch.empty((3, b, h, sq), dtype=torch.float32, device=dev)
    strides = (ctypes.c_int64 * 24)(*[
        st for t in tensors for st in _strides(t)])
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _bwd_lib().flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), *(g.data_ptr() for g in grads), stats.data_ptr(),
        None if lse is None else lse.data_ptr(),
        b, h, kvh, sq, sk, hd, strides, hd ** -0.5, int(causal), window,
        _DTYPES[q.dtype], _ROUTES[route], stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed on the "
                           f"{route} route: CUDA error {rc}")
    flash_attention_bwd.launches += 1
    if route == "wgmma":
        flash_attention_bwd.launches_wgmma += 1
    else:
        flash_attention_bwd.launches_fma += 1
    return grads


flash_attention_bwd.launches = 0
flash_attention_bwd.launches_wgmma = 0
flash_attention_bwd.launches_fma = 0
