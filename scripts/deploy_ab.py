#!/usr/bin/env python3
"""Compare two checkouts of the repo on the deploy-1B phase of
``chip_smoke.py``, in turns, on one card.

    mkdir -p build/parent && git archive <parent-commit> | tar -x -C build/parent
    python scripts/deploy_ab.py build/parent . [--order ABBAAB] [--records N]

Each letter of ``--order`` runs ``phase_deploy`` of checkout A or B (its
own ``chip_smoke.py`` and ``src/``, its own leaf-search build) in a fresh
process started from that checkout's root: bulkload of ``--records``
records (default the paper's 1B), the write-intensive run, netsim metrics,
kernel launches and the read-back of every acknowledged write.  Its lines
are printed under ``=== <checkout>``; the last line sums up the wall-clock
ops/s of each checkout, run by run.  Runs alternate so that a drift of the
host's speed falls on both.  Needs one CUDA card and ~40 GB of its memory
at 1B records.  Imports nothing of JAX.
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
from repro_torch.kernels.leaf_search.kernel import leaf_search
records = int(sys.argv[1])
chip_smoke.phase_deploy(torch, leaf_search, records,
                        25_165_824 * records // 1_000_000_000)
"""
_OPS = re.compile(r"([0-9.]+) ops/s wall-clock")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("a", type=Path, help="checkout A (e.g. the parent)")
    ap.add_argument("b", type=Path, help="checkout B (e.g. this tree)")
    ap.add_argument("--order", default="ABBAAB")
    ap.add_argument("--records", type=int, default=1_000_000_000)
    args = ap.parse_args()
    roots = {"A": args.a.resolve(), "B": args.b.resolve()}
    for r in roots.values():
        if not (r / "chip_smoke.py").exists():
            raise SystemExit(f"{r} holds no chip_smoke.py")
    ops: dict[str, list[float]] = {str(args.a): [], str(args.b): []}
    for letter in args.order:
        name = str(args.a if letter == "A" else args.b)
        print(f"=== {name}", flush=True)
        proc = subprocess.run(
            [sys.executable, "-c", _CHILD, str(args.records)],
            cwd=roots[letter], capture_output=True, text=True)
        sys.stdout.write(proc.stdout)
        if proc.returncode:
            sys.stderr.write(proc.stderr)
            raise SystemExit(f"deploy phase of {name} exited "
                             f"{proc.returncode}")
        ops[name] += [float(m) for m in _OPS.findall(proc.stdout)]
    print(json.dumps({"ops_per_s_wall_clock": ops}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
