#!/usr/bin/env python3
"""Read the numbers ``correct`` compares, for setting their limits: the
program's on many seeds (the lower readings), and on a few seeds the
control's (the reference with its products in float8 put in the program's
place) and each planted fault's (the upper readings), all in one process
and without a measured window.

    python3 portbench/calibrate.py --workload NAME --seeds 11,12,... \\
        --control-seeds 11,12,13 [--no-faults] [--out FILE]

For each seed it runs the program's checked steps, then the reference;
for a control seed also the control and, unless ``--no-faults``, the
program with each fault of ``harness.FAULTS`` planted.  Every reading is printed as a JSON line (and
appended to ``--out``), and a summary last: the largest program reading
and the smallest control and fault readings of each number.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == ROOT / "portbench":
    del sys.path[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--no-faults", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    from portbench import harness
    from portbench.traffic import make_ring
    cell = harness.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None
    rows = []

    def emit(kind: str, seed: int, numbers: dict, t0: float) -> None:
        row = dict(workload=cell.name, kind=kind, seed=seed,
                   seconds=time.perf_counter() - t0, **numbers)
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def program(seed: int, ring: list, fault=None) -> dict:
        prog = harness.Program(cell, seed, "cuda", fault=fault)
        readings = prog.checked_steps(ring)
        del prog
        gc.collect()
        torch.cuda.empty_cache()
        return readings

    for seed in sorted(set(seeds) | control):
        ring = make_ring(cell.traffic, cell.model, seed, "cuda")
        checked = ring[:cell.traffic["checked_steps"]]
        t0 = time.perf_counter()
        prog = program(seed, ring)
        ref = harness.reference_readings(cell, seed, checked, "cuda")
        emit("program", seed, harness.gaps(prog, ref), t0)
        emit("readings", seed, dict(program=prog, reference=ref), t0)
        if seed not in control:
            continue
        t0 = time.perf_counter()
        ctl = harness.reference_readings(cell, seed, checked, "cuda", "fp8")
        emit("control_fp8", seed, harness.gaps(ctl, ref), t0)
        emit("readings_control_fp8", seed, dict(control=ctl), t0)
        for fault in () if args.no_faults else harness.FAULTS:
            t0 = time.perf_counter()
            got = program(seed, ring, fault)
            emit(f"fault_{fault}", seed, harness.gaps(got, ref), t0)
            emit(f"readings_fault_{fault}", seed, dict(fault=got), t0)
    summary = {}
    for number in harness.NUMBERS:
        lower = [r[number] for r in rows if r["kind"] == "program"]
        summary[number] = dict(
            lower=max(lower) if lower else None,
            **{kind: min(r[number] for r in rows if r["kind"] == kind)
               for kind in {r["kind"] for r in rows}
               if not kind.startswith(("program", "readings"))})
    print(json.dumps(dict(workload=cell.name, summary=summary)), flush=True)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
