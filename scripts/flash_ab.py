#!/usr/bin/env python3
"""Compare two checkouts of the repo on the flash-attention phase of
``chip_smoke.py``, in turns, on one card.

    mkdir -p build/parent && git archive <parent-commit> | tar -x -C build/parent
    python scripts/flash_ab.py build/parent . [--order ABBA]

Each letter of ``--order`` runs ``phase_flash`` of checkout A or B (its
own ``chip_smoke.py`` and ``src/``, its own flash-attention build) in a
fresh process started from that checkout's root: every shape held against
the plain version, then the timed prefill shapes (granite-3-8b's in bf16
on the ``wgmma`` route and in f32 on the ``fma`` route, smollm-135m's in
bf16), each on the device as a replayed CUDA graph; where the checkout's
forward takes ``lse=``, smollm-135m's shape is timed again without and
with it (the ``kLse`` instantiation, as a training step's forward runs
it), in turns (without, with, with, without), and so is
recurrentgemma-2b's local attention (B=4, H=10, KV=1, S=4096, hd=256,
window 2048) where the checkout writes the lse at hd 256.  The first run of a
checkout builds its libraries (the forward's and the backward's) and
prints ptxas's lines for the ``fma`` kernels, and every run prints a
digest of each ``wgmma`` kernel's SASS (``cuobjdump -sass``, addresses
and encodings stripped): the forward by head dim, window flag and lse
flag (a checkout without the lse flag has only its flagless
instantiations), the backward's row pass, dK/dV and dQ kernels by head
dim and window flag, so two checkouts' instantiations can be seen to be
the same code.  Its lines are printed under ``=== <checkout>``; the last
line sums up each timed shape's device ms, run by run, per checkout, and
each checkout's SASS digests.  Runs alternate so that a drift of the
card's speed falls on both.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

# run in the checkout's root: its chip_smoke.py and src/ come first
_CHILD = r"""
import hashlib, inspect, os, re, subprocess, sys
import torch
sys.path[:0] = [os.getcwd(), os.path.join(os.getcwd(), "src")]
import chip_smoke
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention.kernel import _route, flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
torch.backends.cuda.matmul.allow_tf32 = False
names = ["flash_attention", "flash_attention_bwd"]
libs = build.build_all(names)
lines = build.BUILD_LOGS.get("flash_attention", "").splitlines()
for i, ln in enumerate(lines):
    if "Compiling entry" in ln and "flash_fwd_kernel" in ln:
        regs = [n.strip() for n in lines[i + 1:i + 4]
                if "registers" in n or "spill" in n]
        print("ptxas", ln.split("'")[1], *regs, flush=True)
# the wgmma kernels by name, head dim and bool flags (the forward's:
# window, then lse where the checkout has it; the backward's: window)
kernel_re = re.compile(r"(flash_wgmma_kernel|fa_bwd_dkdv_wgmma|"
                       r"fa_bwd_dq_wgmma|fa_bwd_dot)ILi(\d+)E((?:Lb[01]E)*)")
short = {"flash_wgmma_kernel": "wgmma", "fa_bwd_dkdv_wgmma": "bwd dkdv",
         "fa_bwd_dq_wgmma": "bwd dq", "fa_bwd_dot": "bwd dot"}
for lib in libs:
    sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    for fn in sass.split("Function : ")[1:]:
        name, body = fn.split("\n", 1)
        m = kernel_re.search(name)
        if m is None:
            continue
        flags = [f == "1" for f in re.findall(r"Lb([01])E", m.group(3))]
        tag = (f"{short[m.group(1)]} hd {m.group(2)}"
               + (" window" if flags[:1] == [True] else "")
               + (" lse" if flags[1:2] == [True] else ""))
        code = [re.sub(r"/\*.*?\*/", "", ln).strip() for ln in
                body.split("Function : ")[0].splitlines()]
        code = [c for c in code if c and not c.startswith(".")]
        print(f"sass {tag}: {len(code)} instructions, sha1 "
              f"{hashlib.sha1(chr(10).join(code).encode()).hexdigest()}",
              flush=True)
chip_smoke.phase_flash(torch, flash_attention, attention_ref, _route)
if "lse" in inspect.signature(flash_attention).parameters:
    # smollm-135m's prefill shape (and recurrentgemma-2b's local attention
    # where the lse is written at hd 256) without and with the lse, in turns
    gen = torch.Generator(device="cuda").manual_seed(12)
    shapes = [(4, 9, 3, 4096, 64, 0)]
    if 256 in getattr(K, "BWD_WGMMA_HEAD_DIMS", ()):
        shapes.append((4, 10, 1, 4096, 256, 2048))
    for b, h, kv, s, hd, window in shapes:
        q, k, v = (torch.randn((b, n, s, hd), generator=gen, device="cuda")
                   .to(torch.bfloat16) for n in (h, kv, kv))
        out = torch.empty_like(q)
        lse = torch.empty((b, h, s), dtype=torch.float32, device="cuda")
        runs = {False: [], True: []}
        for with_lse in (False, True, True, False):
            fn = lambda: flash_attention(q, k, v, causal=True, out=out,
                                         window=window,
                                         lse=lse if with_lse else None)
            runs[with_lse].append(chip_smoke.device_ms(torch, fn, reps=20,
                                                       samples=5))
        w = f" window={window}" if window else ""
        for with_lse, ms in runs.items():
            print(f"lse timing B={b} H={h} KV={kv} S={s} hd={hd}{w} bfloat16 "
                  f"causal (wgmma route, lse {'on' if with_lse else 'off'}): "
                  "device " + " ".join(f"{x:.6f}" for x in ms) + " ms (CUDA "
                  "graph of 20 calls, median of 5, each reading)", flush=True)
        del q, k, v, out, lse
"""
_TIMED = re.compile(r"(B=\d+ H=\d+ KV=\d+ S=\d+ hd=\d+(?: window=\d+)? "
                    r"\w+) causal "
                    r"\((\w+ route(?:, lse o(?:n|ff))?)\): device "
                    r"([0-9.]+(?: [0-9.]+)*) ms")
_SASS = re.compile(r"sass ((?:wgmma|bwd \w+) hd \d+(?: window)?(?: lse)?): "
                   r"(\d+) instructions, sha1 (\w+)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("a", type=Path, help="checkout A (e.g. the parent)")
    ap.add_argument("b", type=Path, help="checkout B (e.g. this tree)")
    ap.add_argument("--order", default="ABBA")
    args = ap.parse_args()
    roots = {"A": args.a.resolve(), "B": args.b.resolve()}
    for r in roots.values():
        if not (r / "chip_smoke.py").exists():
            raise SystemExit(f"{r} holds no chip_smoke.py")
    ms: dict[str, dict[str, list[float]]] = {str(args.a): {},
                                             str(args.b): {}}
    sass: dict[str, dict[str, str]] = {str(args.a): {}, str(args.b): {}}
    for letter in args.order:
        name = str(args.a if letter == "A" else args.b)
        print(f"=== {name}", flush=True)
        proc = subprocess.run([sys.executable, "-c", _CHILD],
                              cwd=roots[letter], capture_output=True,
                              text=True)
        sys.stdout.write(proc.stdout)
        if proc.returncode:
            sys.stderr.write(proc.stderr)
            raise SystemExit(f"flash phase of {name} exited "
                             f"{proc.returncode}")
        for shape, route, t in _TIMED.findall(proc.stdout):
            ms[name].setdefault(f"{shape} {route}", []).extend(
                float(x) for x in t.split())
        for tag, n, digest in _SASS.findall(proc.stdout):
            sass[name][tag] = f"{n} instructions, sha1 {digest}"
    print(json.dumps({"device_ms": ms, "wgmma_sass": sass}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
