#!/usr/bin/env python3
"""One traced run of a cell, as ``run.py --trace 1`` makes it, with the
program's spans read from the same profile (``spantrace.py``): the
per-span table a step, the head's and the f32 loss's device ms, the remat
replay's, the launches a step, and the checks that tie them to the
benchmark's own readings.

    python3 portbench/span_table.py --workload NAME --seed N --seconds S

From the root of a checkout, on a machine with a CUDA card.  It prints
what ``run.py`` prints, then one more JSON line: ``{"workload", "seed",
"spans": spantrace.report(...)}``.  A program without spans reads
``steps`` 0 and None.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == ROOT / "portbench":
    sys.path[0] = str(ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    from portbench import devtrace, run, spantrace
    run.T_START = T_START
    read = devtrace.read
    got = []

    def both(prof):
        base = read(prof)
        got.append(spantrace.report(spantrace.read(prof), base))
        return base
    devtrace.read = both
    try:
        rc = run.main(["--workload", args.workload, "--seed",
                       str(args.seed), "--seconds", str(args.seconds),
                       "--trace", "1"])
    finally:
        devtrace.read = read
    if rc != 0 or not got:
        return rc or 1
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "spans": got[0]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
