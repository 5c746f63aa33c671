#!/usr/bin/env python3
"""Time one build of the flash-attention library on the card, to compare
design variants of its kernels.

    python scripts/flash_variant_timing.py LABEL [CSRC_DIR] [--check]
    python scripts/flash_variant_timing.py LABEL [CSRC_DIR] --bwd [--check]
    python scripts/flash_variant_timing.py LABEL --bwd --variant NAME

Builds ``CSRC_DIR/flash_attention.cu`` (default: the repo's
``src/repro_torch/csrc``; a variant is a copy of that directory with an
edit) into ``build/repro_torch/``, prints the wgmma kernels' ptxas lines
(registers, spills, performance notes; per head dim and window flag) and
the library's HGMMA count, with ``--check`` holds it against the plain
version on ragged, GQA, prefill and windowed cases (hd 64, 128 and 256) at
4e-3 + 1e-2, then times the bf16 causal prefill shapes of smollm-135m and
granite-3-8b (B=4, S=4096) beside PyTorch's SDPA, and recurrentgemma-2b's
local attention (B=4, H=10, KV=1, S=4096, hd=256, window 2048) beside SDPA
with the same boolean mask: the median over 7 samples of 20 back-to-back
calls, CUDA events.

With ``--bwd`` it builds ``CSRC_DIR/flash_attention_bwd.cu`` (and the
forward, for its log-sum-exp) instead, prints the backward's wgmma
kernels' ptxas lines, with ``--check`` holds the backward's wgmma route
against the plain version's autograd on ragged, GQA, windowed and
no-key-row cases at hd 64, 128 and 256 (4e-2 + 2e-2, as chip_smoke.py),
then times the backward at smollm-135m's training shape (B=4, H=9, KV=3,
S=4096, hd=64, causal), granite-3-8b's (B=4, H=32, KV=8, hd=128) and
recurrentgemma-2b's local attention (B=4, H=10, KV=1, hd=256, window
2048; and at B=1, its training cell's) beside SDPA's backward (SDPA's
forward + backward minus its
forward; with the window as a boolean mask), the median over 7 samples
of 20 calls, and splits one call's device time by kernel
(``torch.profiler``, 5 calls).

``--f32`` also times the ``fma`` route's backward in f32 at smollm's
shape beside SDPA's, the plain version and chip_smoke.py's bound.
``--variant NAME`` builds a copy of the repo's ``csrc/`` with the text
edits of ``BWD_VARIANTS[NAME]`` (each must match once) under
``build/flash_variants/``, for ``--bwd``.  A variant marked timing only
computes wrong values on purpose (it removes a wait to price it), so
``--check`` refuses it.

Each library links its own CUDA runtime, so run one variant per process,
and compare variants inside one machine's run in turns (A B B A).
Imports nothing of JAX.
"""
from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402

# (B, H, KV, S, hd, causal): ragged, GQA, full and causal, then the two
# prefill shapes, which are also timed
CASES = [(1, 2, 2, 128, 64, False), (1, 4, 1, 300, 128, False),
         (2, 8, 2, 256, 128, True), (2, 9, 3, 77, 64, True),
         (1, 2, 2, 4097, 128, True), (1, 3, 1, 4097, 64, False),
         (4, 32, 8, 4096, 128, True), (4, 9, 3, 4096, 64, True)]
# (B, H, KV, Sq, Sk, hd, causal, window): hd 256 without a window (GQA 1
# and 3, ragged, Sq != Sk), windows whose edge falls mid-tile, rows that
# see no key (Sq > Sk), then recurrentgemma-2b's local attention, which is
# also timed
WINDOW_CASES = [(1, 4, 4, 300, 300, 256, True, 0),
                (2, 6, 2, 200, 77, 256, False, 0),
                (1, 3, 1, 130, 300, 256, True, 0),
                (1, 4, 2, 200, 200, 256, True, 65),
                (1, 4, 2, 200, 200, 128, True, 129),
                (1, 4, 2, 300, 300, 64, True, 64),
                (1, 4, 2, 356, 100, 256, True, 96),
                (1, 4, 2, 100, 356, 256, False, 96),
                (2, 2, 1, 77, 77, 256, True, 1),
                (4, 10, 1, 4096, 4096, 256, True, 2048)]


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


# the backward's wgmma cases (B, H, KV, Sq, Sk, hd, causal, window), held
# at chip_smoke.py's bf16 tolerance; then the two timed shapes
BWD_CASES = [(1, 3, 3, 77, 77, 64, False, 0), (2, 9, 3, 300, 300, 64, True, 0),
             (1, 8, 2, 190, 333, 128, True, 0),
             (1, 4, 1, 333, 190, 128, False, 0),
             (1, 6, 2, 260, 260, 64, True, 100),
             (1, 4, 1, 300, 100, 64, True, 40),
             (1, 4, 2, 190, 333, 256, True, 0),
             (1, 3, 1, 333, 190, 256, False, 0),
             (2, 10, 1, 300, 300, 256, True, 100),
             (1, 6, 2, 130, 130, 256, False, 33),
             (1, 4, 4, 300, 100, 256, True, 40)]
# (B, H, KV, S, hd, window), causal; recurrentgemma's also at batch 1, its
# training cell's
BWD_TIMED = [(4, 9, 3, 4096, 64, 0), (4, 32, 8, 4096, 128, 0),
             (4, 10, 1, 4096, 256, 2048), (1, 10, 1, 4096, 256, 2048)]
# with --f32: smollm's shape in f32 on the fma route, beside SDPA's f32
# backward, the plain version and chip_smoke.py's bound
BWD_TIMED_F32 = (4, 9, 3, 4096, 64)


# --variant NAME: (text edits of csrc/flash_attention_bwd_wgmma.cuh, timing
# only).  "no P hand-off wait": hd 256's dK/dV warpgroups skip the named
# barriers around the P^T buffer (warpgroup 1 reads whatever is there), so
# the time it saves is what the hand-off's waits cost.
BWD_VARIANTS = {
    "no P hand-off wait": ([
        ("      if (n > 0) named_sync(kPEmpty);\n", ""),
        ("      named_arrive(kPFull);\n", ""),
        ("      named_sync(kPFull);\n", ""),
        ("      if (n + 1 < n_steps) named_arrive(kPEmpty);\n", "")], True),
}


def variant_csrc(name: str) -> Path:
    """A copy of csrc/ with BWD_VARIANTS[name]'s edits applied."""
    edits, _ = BWD_VARIANTS[name]
    dst = ROOT / "build" / "flash_variants" / name.replace(" ", "_")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(build.CSRC, dst)
    f = dst / "flash_attention_bwd_wgmma.cuh"
    text = f.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"variant {name!r}: {old!r} matches "
                             f"{text.count(old)} times")
        text = text.replace(old, new)
    f.write_text(text)
    return dst


def bwd_main(label: str) -> int:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd)
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    build.build_all(["flash_attention", "flash_attention_bwd"])
    # the backward's wgmma kernels, and the forward's (its lse flag)
    lines = (build.BUILD_LOGS.get("flash_attention", "")
             + build.BUILD_LOGS.get("flash_attention_bwd", "")).splitlines()
    for i, ln in enumerate(lines):
        if "Potential" in ln or "setmaxnreg" in ln:
            print(f"[{label}] {ln.strip()}")
        if "Compiling entry" in ln and ("fa_bwd_wgmma" in ln
                                        or "flash_wgmma_kernel" in ln):
            name = ln.split("'")[1]
            for nxt in lines[i + 1:i + 4]:
                if "registers" in nxt or "spill" in nxt:
                    print(f"[{label}] {name[:60]}: {nxt.strip()}")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def inputs(b, h, kv, sq, sk, hd, causal, window=0,
               dtype=torch.bfloat16):
        q, do = (torch.randn((b, h, sq, hd), generator=gen, device="cuda")
                 .to(dtype) for _ in range(2))
        k, v = (torch.randn((b, kv, sk, hd), generator=gen, device="cuda")
                .to(dtype) for _ in range(2))
        lse = None
        if dtype == torch.bfloat16:
            lse = torch.empty((b, h, sq), dtype=torch.float32,
                              device="cuda")
        o = flash_attention(q, k, v, causal=causal, window=window, lse=lse)
        return q, k, v, o, do, lse

    if "--f32" in sys.argv:
        sys.path.insert(0, str(ROOT))
        import chip_smoke
        torch.backends.cuda.matmul.allow_tf32 = False   # f32 in full
        b, h, kv, s, hd = BWD_TIMED_F32
        q, k, v, o, do, _ = inputs(b, h, kv, s, s, hd, True,
                                   dtype=torch.float32)
        grads = tuple(torch.empty_like(t) for t in (q, k, v))
        ms = event_ms(lambda: flash_attention_bwd(q, k, v, o, do,
                                                  grads=grads, causal=True),
                      reps=3, samples=3)
        plain = event_ms(lambda: attention_bwd_ref(q, k, v, do, causal=True),
                         reps=1, samples=3)
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        sdpa = lambda: F.scaled_dot_product_attention(
            *leaves, is_causal=True, enable_gqa=True)
        fwd = event_ms(sdpa, reps=3, samples=3)
        both = event_ms(lambda: torch.autograd.grad(sdpa(), leaves, do),
                        reps=3, samples=3)
        bound, by, *_ = chip_smoke.attention_bwd_bound(
            torch, b, h, kv, s, s, hd, True, 0, 4)
        print(f"[{label}] bwd B={b} H={h} KV={kv} S={s} hd={hd} float32 "
              f"causal (fma route) ms {ms:.6f}; plain version {plain:.6f}; "
              f"sdpa backward {both - fwd:.6f} (forward + backward "
              f"{both:.6f} minus forward {fwd:.6f}); bound {bound:.6f} "
              f"({by})", flush=True)
        del q, k, v, o, do, grads, leaves
        torch.cuda.empty_cache()

    if "--check" in sys.argv:
        for case in BWD_CASES:
            *shape, causal, window = case
            q, k, v, o, do, lse = inputs(*shape, causal, window)
            kw = dict(causal=causal, window=window)
            got = flash_attention_bwd(q, k, v, o, do, lse=lse, **kw)
            want = attention_bwd_ref(q, k, v, do, **kw)
            errs = [(g.float() - w.float()).abs() for g, w in zip(got, want)]
            ok = all(bool((e <= 4e-2 + 2e-2 * w.float().abs()).all())
                     for e, w in zip(errs, want))
            print(f"[{label}] bwd case {case}: max abs error "
                  f"{max(float(e.max()) for e in errs)} ok {ok}", flush=True)
            if not ok:
                return 1
    for b, h, kv, s, hd, window in BWD_TIMED:
        q, k, v, o, do, lse = inputs(b, h, kv, s, s, hd, True, window)
        grads = tuple(torch.empty_like(t) for t in (q, k, v))
        kernel = lambda: flash_attention_bwd(q, k, v, o, do, lse=lse,
                                             grads=grads, causal=True,
                                             window=window)
        ms = event_ms(kernel)
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        mask = None
        if window:
            idx = torch.arange(s, device="cuda")
            mask = ((idx[:, None] >= idx[None, :])
                    & (idx[:, None] - idx[None, :] < window))
        sdpa = lambda: F.scaled_dot_product_attention(
            *leaves, attn_mask=mask, is_causal=mask is None,
            enable_gqa=True)
        fwd = event_ms(sdpa)
        both = event_ms(lambda: torch.autograd.grad(sdpa(), leaves, do))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                kernel()
            torch.cuda.synchronize()
        split = {e.key: e.self_device_time_total / 5e3
                 for e in prof.key_averages()
                 if e.device_type != DeviceType.CPU}
        print(f"[{label}] bwd B={b} H={h} KV={kv} S={s} hd={hd} window="
              f"{window} causal ms "
              f"{ms:.6f} sdpa backward {both - fwd:.6f} (forward + backward "
              f"{both:.6f} minus forward {fwd:.6f}); by kernel "
              + "; ".join(f"{key[:40]} {t:.6f}" for key, t in
                          sorted(split.items(), key=lambda x: -x[1])),
              flush=True)
        del q, k, v, o, do, lse, grads, leaves, mask
        torch.cuda.empty_cache()
    return 0


def main() -> int:
    argv = sys.argv[1:]
    variant = None
    if "--variant" in argv:
        i = argv.index("--variant")
        variant = argv[i + 1]
        del argv[i:i + 2]
        if "--check" in argv and BWD_VARIANTS[variant][1]:
            raise SystemExit(f"variant {variant!r} is timing only")
    args = [a for a in argv
            if a not in ("--check", "--bwd", "--f32")]
    label = args[0]
    if len(args) > 1:
        build.CSRC = Path(args[1]).resolve()
    if variant is not None:
        build.CSRC = variant_csrc(variant)
    if "--bwd" in sys.argv:
        return bwd_main(label)
    lib = build.build_all(["flash_attention"])[0]
    lines = build.BUILD_LOGS.get("flash_attention", "").splitlines()
    for i, ln in enumerate(lines):
        if "Potential" in ln or "setmaxnreg" in ln:
            print(f"[{label}] {ln.strip()}")
        if "Compiling entry" in ln and "flash_wgmma_kernel" in ln:
            args = ln.split("kernelILi")[1]
            hd = args.split("E")[0]
            window = " window" if "ELb1E" in args else ""
            for nxt in lines[i + 1:i + 4]:
                if "registers" in nxt or "spill" in nxt:
                    print(f"[{label}] hd {hd}{window}: {nxt.strip()}")
    sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    print(f"[{label}] HGMMA {sum('HGMMA' in ln for ln in sass.splitlines())}",
          flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)

    def inputs(b, h, kv, s, hd):
        return [torch.randn((b, n, s, hd), generator=gen, device="cuda")
                .to(torch.bfloat16) for n in (h, kv, kv)]

    def windowed(b, h, kv, sq, sk, hd):
        return [torch.randn((b, n, s, hd), generator=gen, device="cuda")
                .to(torch.bfloat16) for n, s in ((h, sq), (kv, sk), (kv, sk))]

    if "--check" in sys.argv:
        checks = [(inputs(*c[:5]), dict(causal=c[5]), c) for c in CASES]
        checks += [(windowed(*c[:6]), dict(causal=c[6], window=c[7]), c)
                   for c in WINDOW_CASES]
        for (q, k, v), kw, case in checks:
            got = flash_attention(q, k, v, **kw).float()
            want = attention_ref(q, k, v, **kw).float()
            err = (got - want).abs()
            ok = bool((err <= 4e-3 + 1e-2 * want.abs()).all())
            print(f"[{label}] case {case}: max abs error {float(err.max())} "
                  f"ok {ok}", flush=True)
            if not ok:
                return 1
            del q, k, v, got, want
    for case in CASES[-2:]:
        q, k, v = inputs(*case[:5])
        ms = event_ms(lambda: flash_attention(q, k, v, causal=True))
        sdpa = event_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True))
        print(f"[{label}] hd {case[4]} ms {ms:.6f} sdpa {sdpa:.6f}",
              flush=True)
    b, h, kv, s, _, hd, _, window = WINDOW_CASES[-1]
    q, k, v = windowed(b, h, kv, s, s, hd)
    idx = torch.arange(s, device="cuda")
    mask = ((idx[:, None] >= idx[None, :])
            & (idx[:, None] - idx[None, :] < window))
    ms = event_ms(lambda: flash_attention(q, k, v, causal=True,
                                          window=window))
    sdpa = event_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True))
    print(f"[{label}] hd {hd} window {window} ms {ms:.6f} sdpa with the "
          f"mask {sdpa:.6f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
