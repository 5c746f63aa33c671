#!/usr/bin/env python3
"""Time one build of the WKV6 library on the card, to compare design
variants of its kernel.

    python scripts/wkv6_variant_timing.py LABEL [CSRC_DIR] [--check]

Builds ``CSRC_DIR/wkv6.cu`` (default: the repo's ``src/repro_torch/csrc``;
a variant is a copy of that directory with an edit) into
``build/repro_torch/``, prints ptxas's registers and spills for each
kernel instantiation, with ``--check`` holds it against the plain version
(1e-4 + 1e-4·|want| in f32, 0.15 in bf16) at every head size, at the chunk
boundaries and in the model layout, then times rwkv6-1.6b's shape (B=4,
H=32, T=4096, N=64, f32) in the kernel layout [B,H,T,N] and in the model
layout [B,T,H,N] through ``wkv6_seq``: the median over 7 samples of 20
back-to-back calls, CUDA events.

Each library links its own CUDA runtime, so run one variant per process,
and compare variants inside one machine's run in turns (A B B A).
Imports nothing of JAX.
"""
from __future__ import annotations

import re
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.rwkv_scan.kernel import wkv6  # noqa: E402
from repro_torch.kernels.rwkv_scan.ops import wkv6_seq  # noqa: E402
from repro_torch.kernels.rwkv_scan.ref import wkv6_ref  # noqa: E402

# (B, H, T, N, dtype): every head size, the chunk boundaries of 32 steps,
# a ragged length, and rwkv6-1.6b's width
CASES = [(2, 3, 256, 32, "float32"), (2, 1, 512, 16, "float32"),
         (1, 2, 128, 64, "bfloat16"), (2, 3, 77, 32, "bfloat16"),
         (1, 6, 1, 64, "float32"), (1, 6, 31, 64, "bfloat16"),
         (1, 6, 32, 64, "float32"), (1, 6, 33, 16, "bfloat16"),
         (2, 6, 67, 64, "float32"), (1, 32, 300, 64, "float32"),
         (1, 32, 300, 64, "bfloat16")]
TOL = {"float32": 1e-4, "bfloat16": 0.15}
TIMED = (4, 32, 4096, 64)


def event_ms(fn, reps: int = 20, samples: int = 7) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def inputs(gen, b, h, t, n, dtype):
    """[B,T,H,N] tensors (the model layout), r/k/v normal, w in
    [0.45, 0.95), and u [H,N]."""
    r, k, v = (torch.randn((b, t, h, n), generator=gen, device="cuda")
               .to(dtype) for _ in range(3))
    w = (torch.rand((b, t, h, n), generator=gen, device="cuda") * 0.5
         + 0.45).to(dtype)
    u = torch.randn((h, n), generator=gen, device="cuda").to(dtype)
    return r, k, v, w, u


def main() -> int:
    args = [a for a in sys.argv[1:] if a != "--check"]
    label = args[0]
    if len(args) > 1:
        build.CSRC = Path(args[1]).resolve()
    build.build_all(["wkv6"])
    for ln in build.BUILD_LOGS.get("wkv6", "").splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", ln)
        if entry:
            print(f"[{label}] {entry.group(1)}")
        elif "registers" in ln or "spill" in ln or "Potential" in ln:
            print(f"[{label}]   {ln.strip()}")
    gen = torch.Generator(device="cuda").manual_seed(0)

    if "--check" in sys.argv:
        for b, h, t, n, dt in CASES:
            r, k, v, w, u = inputs(gen, b, h, t, n, getattr(torch, dt))
            kl = [x.transpose(1, 2) for x in (r, k, v, w)]   # [B,H,T,N]
            got = wkv6_seq(r, k, v, w, u).transpose(1, 2)
            want = wkv6_ref(*kl, u)
            err = (got - want).abs()
            ok = bool((err <= TOL[dt] + TOL[dt] * want.abs()).all())
            same = torch.equal(wkv6(*(x.contiguous() for x in kl), u), got)
            print(f"[{label}] case {(b, h, t, n, dt)}: max abs error "
                  f"{float(err.max())} ok {ok}; kernel layout == model "
                  f"layout {same}", flush=True)
            if not (ok and same):
                return 1
    r, k, v, w, u = inputs(gen, *TIMED, torch.float32)
    kl = [x.transpose(1, 2).contiguous() for x in (r, k, v, w)]
    out = torch.empty(kl[0].shape, dtype=torch.float32, device="cuda")
    ms = event_ms(lambda: wkv6(*kl, u, out=out))
    ms_model = event_ms(lambda: wkv6_seq(r, k, v, w, u))
    print(f"[{label}] B={TIMED[0]} H={TIMED[1]} T={TIMED[2]} N={TIMED[3]} "
          f"f32: kernel layout ms {ms:.6f} model layout ms {ms_model:.6f}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
