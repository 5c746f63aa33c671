#!/usr/bin/env python3
"""Time one build of the WKV6 library on the card, to compare design
variants of its kernel.

    python scripts/wkv6_variant_timing.py LABEL [CSRC_DIR] [--check]
    python scripts/wkv6_variant_timing.py LABEL [CSRC_DIR] --bwd [--check]
        [--tree DIR] [--variant NAME]

Builds ``CSRC_DIR/wkv6.cu`` (default: the repo's ``src/repro_torch/csrc``;
a variant is a copy of that directory with an edit) into
``build/repro_torch/``, prints ptxas's registers and spills for each
kernel instantiation, with ``--check`` holds it against the plain version
(1e-4 + 1e-4·|want| in f32, 0.15 in bf16) at every head size, at the chunk
boundaries and in the model layout, then times rwkv6-1.6b's shape (B=4,
H=32, T=4096, N=64, f32) in the kernel layout [B,H,T,N] and in the model
layout [B,T,H,N] through ``wkv6_seq``: the median over 7 samples of 20
back-to-back calls, CUDA events.

Each build also prints a digest of each kernel's SASS, so two checkouts'
kernels can be seen to be the same code.

With ``--bwd`` it does the same for the backward kernel
(``CSRC_DIR/wkv6_bwd.cu``): ptxas's registers, spills and shared memory
for each instantiation; with ``--check`` every case of chip_smoke.py's
``WKV_BWD_CASES`` against ``wkv6_bwd_ref`` within its tolerance, and a
rerun bit for bit; then rwkv6-1.6b's training shape (B=4, H=32, T=2048,
N=64, f32) timed as the median of 7 samples of 10 back-to-back calls
(CUDA events), with the call's transient device bytes besides its
outputs (``max_memory_allocated`` over a call).  ``--tree DIR`` imports
``repro_torch`` from ``DIR/src`` (a checkout unpacked with ``git
archive`` under an ignored directory such as ``build/``), so an earlier
kernel runs through its own wrapper; CSRC_DIR defaults to that tree's
``csrc``.  ``--variant NAME`` builds a copy of CSRC_DIR with the text
edits of ``BWD_VARIANTS[NAME]`` (each must match once) under
``build/wkv6_bwd_variants/``: timing-only cuts of the kernel's first
version (16 rows a block, then a second kernel summing dv) that split its
time between its forward sweep, its backward sweep and its dv kernel,
and settings and cuts of the redesigned kernel.

Each library links its own CUDA runtime, so run one variant per process,
and compare variants inside one machine's run in turns (A B B A).
Imports nothing of JAX.
"""
from __future__ import annotations

import hashlib
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def _option(name: str) -> str | None:
    """The value after ``name`` on the command line, taken off it."""
    if name not in sys.argv:
        return None
    i = sys.argv.index(name)
    value = sys.argv[i + 1]
    del sys.argv[i:i + 2]
    return value


TREE = Path(_option("--tree") or ROOT).resolve()
VARIANT = _option("--variant")
sys.path.insert(0, str(TREE / "src"))
sys.path.insert(1, str(ROOT))

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.rwkv_scan.kernel import wkv6  # noqa: E402
from repro_torch.kernels.rwkv_scan.ops import wkv6_seq  # noqa: E402
from repro_torch.kernels.rwkv_scan.ref import wkv6_ref  # noqa: E402
from chip_smoke import (WKV_BWD_CASES, WKV_BWD_TOL,  # noqa: E402
                        wkv_bwd_inputs)

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
BWD_TIMED = (4, 32, 2048, 64)
_FIRST_DV = "  wkv6_bwd_dv<N><<<1024, 256, 0, stream>>>(dv_part, dv, B, H, T, dvs);"
#: Timing-only cuts of the first version of ``wkv6_bwd.cu`` (run it with
#: ``--tree`` on a checkout that has it): (old, new) text edits, each
#: matching once.
BWD_VARIANTS = {
    "sweep 1": [("  for (int c = n_ck - 1; c >= 0; --c) {",
                 "  for (int c = n_ck - 1; c >= n_ck; --c) {"),
                (_FIRST_DV, "")],
    "sweep 2": [("  for (int c = 0; c < n_ck; ++c) {",
                 "  for (int c = 0; c < 0; ++c) {"),
                (_FIRST_DV, "")],
    "dv kernel": [("  wkv6_bwd_kernel<N><<<grid,",
                   "  if (B < 0) wkv6_bwd_kernel<N><<<grid,")],
}
_BACKWARD = [("    backward(st, s, j, kSub);\n", ""),
             ("    backward(st, s, j, 0);\n", "")]
#: Timing-only settings and cuts of the redesigned kernel.
BWD_VARIANTS.update({
    "2 stages": [("constexpr int kStages = 4;", "constexpr int kStages = 2;")],
    "no backward steps": _BACKWARD,
    "no shuffles": [
        ("    scatter_down<3 * RT / 2, C::kL / 2, C::kG>(x, lane);\n"
         "    allreduce_down<3, C::kG / 2>(x);\n"
         "    dv_up<4, C::kL>(y, lane);\n", "")],
})


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


def build_report(label: str, name: str) -> None:
    """Build ``name``; print ptxas's lines for each instantiation and a
    digest of each kernel's SASS (``cuobjdump -sass``, addresses and
    encodings stripped, the anonymous namespace's per-path hash taken out
    of the names), so two checkouts' kernels can be seen to be the same
    code."""
    lib = build.build_all([name])[0]
    for ln in build.BUILD_LOGS.get(name, "").splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", ln)
        if entry:
            print(f"[{label}] {entry.group(1)}")
        elif ("registers" in ln or "spill" in ln or "Potential" in ln
              or "smem" in ln):
            print(f"[{label}]   {ln.strip()}")
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    for fn in sass.split("Function : ")[1:]:
        fname, body = fn.split("\n", 1)
        fname = re.sub(r"_GLOBAL__N__\w+?_\d+", "_GLOBAL__N_", fname.strip())
        code = [re.sub(r"/\*.*?\*/", "", ln).strip() for ln in
                body.splitlines()]
        code = [c for c in code if c and not c.startswith(".")]
        print(f"[{label}] sass {fname}: {len(code)} instructions, sha1 "
              f"{hashlib.sha1(chr(10).join(code).encode()).hexdigest()}")


def variant_csrc(name: str) -> Path:
    """A copy of ``build.CSRC`` with ``BWD_VARIANTS[name]``'s edits."""
    dst = TREE / "build" / "wkv6_bwd_variants" / re.sub(r"\W+", "_", name)
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(build.CSRC, dst)
    src = (dst / "wkv6_bwd.cu").read_text()
    for old, new in BWD_VARIANTS[name]:
        if src.count(old) != 1:
            raise ValueError(f"variant {name!r}: {old!r} matches "
                             f"{src.count(old)} times")
        src = src.replace(old, new)
    (dst / "wkv6_bwd.cu").write_text(src)
    return dst


def main_bwd(label: str, check: bool) -> int:
    from repro_torch.kernels.rwkv_scan.kernel import wkv6_bwd
    from repro_torch.kernels.rwkv_scan.ref import wkv6_bwd_ref
    build_report(label, "wkv6_bwd")
    try:
        from repro_torch.kernels.rwkv_scan.kernel import wkv6_bwd_occupancy
        print(f"[{label}] occupancy at N 64: {wkv6_bwd_occupancy(64)}")
    except ImportError:
        pass                        # a tree from before the query
    gen = torch.Generator(device="cuda").manual_seed(15)
    if check:
        for case in WKV_BWD_CASES:
            args = wkv_bwd_inputs(torch, gen, *case)
            got = wkv6_bwd(*args)
            again = wkv6_bwd(*args)
            want = wkv6_bwd_ref(*args)
            errs = [float((g - x).abs().max()) for g, x in zip(got, want)]
            ok = all(e <= WKV_BWD_TOL * max(1.0, float(x.abs().max()))
                     for e, x in zip(errs, want))
            same = all(torch.equal(x, y) for x, y in zip(got, again))
            print(f"[{label}] case {case}: max abs error dr/dk/dv/dw/du "
                  + " ".join(f"{e:.3g}" for e in errs)
                  + f" ok {ok}; rerun same bits {same}", flush=True)
            if not (ok and same):
                return 1
            del got, again, want
    args = wkv_bwd_inputs(torch, gen, *BWD_TIMED, False)
    grads = tuple(torch.empty_like(args[0]) for _ in range(4))
    call = lambda: wkv6_bwd(*args, grads=grads)
    call()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    call()
    torch.cuda.synchronize()
    scratch = torch.cuda.max_memory_allocated() - base
    ms = event_ms(call, reps=10)
    print(f"[{label}] wkv6_bwd B={BWD_TIMED[0]} H={BWD_TIMED[1]} "
          f"T={BWD_TIMED[2]} N={BWD_TIMED[3]} f32: ms {ms:.6f} (median of "
          f"7 x 10 calls); transient bytes {scratch}", flush=True)
    return 0


def main() -> int:
    check = "--check" in sys.argv
    args = [a for a in sys.argv[1:] if a not in ("--check", "--bwd")]
    label = args[0]
    build.CSRC = (Path(args[1]).resolve() if len(args) > 1
                  else TREE / "src" / "repro_torch" / "csrc")
    if VARIANT is not None:
        build.CSRC = variant_csrc(VARIANT)
    if "--bwd" in sys.argv:
        return main_bwd(label, check)
    build_report(label, "wkv6")
    gen = torch.Generator(device="cuda").manual_seed(0)

    if check:
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
