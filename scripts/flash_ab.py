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
bf16), each on the device as a replayed CUDA graph.  The first run of a
checkout builds its library and prints ptxas's lines for the ``fma``
kernels.  Its lines are printed under ``=== <checkout>``; the last line
sums up each timed shape's device ms, run by run, per checkout.  Runs
alternate so that a drift of the card's speed falls on both.  Imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

# run in the checkout's root: its chip_smoke.py and src/ come first
_CHILD = """
import os, sys
import torch
sys.path[:0] = [os.getcwd(), os.path.join(os.getcwd(), "src")]
import chip_smoke
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.kernel import _route, flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
torch.backends.cuda.matmul.allow_tf32 = False
build.build_all(["flash_attention"])
lines = build.BUILD_LOGS.get("flash_attention", "").splitlines()
for i, ln in enumerate(lines):
    if "Compiling entry" in ln and "flash_fwd_kernel" in ln:
        regs = [n.strip() for n in lines[i + 1:i + 4]
                if "registers" in n or "spill" in n]
        print("ptxas", ln.split("'")[1], *regs, flush=True)
chip_smoke.phase_flash(torch, flash_attention, attention_ref, _route)
"""
_TIMED = re.compile(r"(B=\d+ H=\d+ KV=\d+ S=\d+ hd=\d+ \w+) causal "
                    r"\((\w+) route\): device ([0-9.]+) ms")


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
            ms[name].setdefault(f"{shape} {route}", []).append(float(t))
    print(json.dumps({"device_ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
