#!/usr/bin/env python3
"""Time the head and its f32 loss on the card at the two benchmark cells'
training shapes (4 × 4,095 loss rows): internvl2-1b's tied 151,655-row
head of width 896 and rwkv6-1.6b's untied 65,536-row head of width 2048.

For each shape it prints one JSON line: the loss kernel's device time a
call (CUDA events over repeated launches; the buffer is read and written
in place, so the work is the same on every launch) beside its bound (the
buffer read once and written once at 3.35 TB/s), the plain version's
time, the fused op's forward + backward (``kernels/head_loss/ops.py``)
against the composition it replaced (the head over every position, the
slice, ``cross_entropy`` and autograd) with each one's peak memory above
its inputs, and the products' kernel names from ``torch.profiler``.

    python3 scripts/head_loss_timing.py

From the root of a checkout, on a machine with a CUDA card.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels.head_loss.kernel import loss_rows  # noqa: E402
from repro_torch.kernels.head_loss.ops import (head_loss, pad_vocab,  # noqa: E402
                                               padded)
from repro_torch.kernels.head_loss.ref import loss_rows_ref  # noqa: E402
from repro_torch.models.common import cross_entropy  # noqa: E402

HBM = 3.35e12
# name: (batch, positions a row, of them a prefix, vocab, width, tied)
SHAPES = {"internvl2-1b": (4, 4352, 256, 151_655, 896, True),
          "rwkv6-1.6b": (4, 4096, 0, 65_536, 2048, False)}


def device_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def peak_above(fn) -> int:
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def product_kernels(fn) -> dict:
    """{kernel name: device ms} of the products one call launches."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        name = e.key
        if any(k in name.lower() for k in ("gemm", "nvjet", "cutlass",
                                            "xmma", "cublas")):
            ms = getattr(e, "device_time_total",
                         getattr(e, "cuda_time_total", 0)) / 1e3
            out[name[:120]] = round(ms, 4)
    return out


def one(name, b, s, p, v, d, tied) -> dict:
    g = torch.Generator(device="cuda").manual_seed(0)
    n = b * (s - p - 1)
    bf = torch.bfloat16
    x = torch.randn(b, s, d, generator=g, device="cuda").to(bf)
    w = (torch.randn(v, d, generator=g, device="cuda") / d ** 0.5).to(bf)
    if not tied:
        w = w.T.contiguous().T      # a [D, V] head seen as [V, D]
    tokens = torch.randint(0, v, (b, s - p), generator=g, device="cuda")
    out = dict(shape=name, loss_rows=n, vocab=v, v_pad=padded(v), width=d,
               card=torch.cuda.get_device_name(0))

    # the loss kernel alone, and its plain version
    buf = x[:, p:-1].reshape(n, d) @ pad_vocab(w).T
    labels = tokens[:, 1:].reshape(-1).contiguous()
    scale = torch.full((n,), 1.0 / n, device="cuda")
    out["kernel_ms"] = device_ms(lambda: loss_rows(buf, v, labels, scale),
                                 20)
    out["kernel_bound_ms"] = 2 * buf.numel() * buf.element_size() / HBM * 1e3
    out["kernel_read_only_ms"] = device_ms(
        lambda: loss_rows(buf, v, labels, scale, write_grad=False), 20)
    out["plain_ms"] = device_ms(
        lambda: loss_rows_ref(buf, v, labels, scale), 2)
    del buf

    # the fused op against the composition, forward and backward
    xr = x.clone().requires_grad_()
    wr = w.detach().clone().requires_grad_() if tied else \
        w.detach().T.contiguous().requires_grad_()

    def fused():
        xr.grad = wr.grad = None
        h = xr[:, p:-1]
        head_loss(h, wr if tied else wr.T, tokens[:, 1:]).backward()

    def composed():
        xr.grad = wr.grad = None
        head = wr.T if tied else wr
        logits = torch.einsum("bsd,dv->bsv", xr, head)
        cross_entropy(logits[:, p:][:, :-1], tokens[:, 1:]).backward()

    for tag, fn in (("fused", fused), ("composed", composed)):
        out[f"{tag}_fwd_bwd_ms"] = device_ms(fn, 3)
        out[f"{tag}_peak_gb"] = peak_above(fn) / 1e9
        out[f"{tag}_products"] = product_kernels(fn)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    for name, shape in SHAPES.items():
        print(json.dumps(one(name, *shape)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
