"""Generate the roofline tables from dry-run JSONs (either package's
``launch/dryrun.py`` writes them).  The port's copy of
:mod:`repro.roofline.report`.

    PYTHONPATH=src python -m repro_torch.roofline.report /tmp/dryrun
"""
from __future__ import annotations

import glob
import json
import os
import sys

ADVICE = {
    ("memory_s", "train"): "stream attention/logits (chunked), fuse "
                           "residual+norm, bf16 master-cast",
    ("memory_s", "prefill"): "chunked attention + KV-write fusion",
    ("memory_s", "decode"): "KV-cache layout/quantization; batch more "
                            "sequences per chip",
    ("collective_s", "train"): "EP all-to-all instead of dense EP "
                               "collectives; overlap grad all-reduce",
    ("collective_s", "prefill"): "shard activations on sequence (SP) to "
                                 "shrink TP all-gathers",
    ("collective_s", "decode"): "keep TP partials resident; fuse "
                                "all-reduces across layers",
    ("compute_s", "train"): "near roofline — MXU-align tile shapes",
    ("compute_s", "prefill"): "near roofline — MXU-align tile shapes",
    ("compute_s", "decode"): "near roofline",
}


def load(out_dir: str, mesh: str = "single") -> list[dict]:
    rows = []
    for f in sorted(glob.glob(os.path.join(out_dir, f"*__{mesh}.json"))):
        d = json.load(open(f))
        d["_file"] = os.path.basename(f)
        rows.append(d)
    return rows


def kind_of(shape: str) -> str:
    return {"train_4k": "train", "prefill_32k": "prefill"}.get(
        shape, "decode")


def roofline_table(rows: list[dict]) -> str:
    out = ["| arch | shape | compute (ms) | memory (ms) | collective (ms) "
           "| dominant | roofline frac | 6ND/HLO | next lever |",
           "|---|---|---|---|---|---|---|---|---|"]
    for d in sorted(rows, key=lambda r: (r.get("arch", ""),
                                         r.get("shape", ""))):
        if d["status"] == "skipped":
            continue
        if d["status"] != "ok":
            out.append(f"| {d.get('arch','?')} | {d.get('shape','?')} | "
                       f"ERROR | | | | | | {d.get('error','')[:60]} |")
            continue
        rl = d["roofline"]
        dom = rl["dominant"]
        advice = ADVICE.get((dom, kind_of(d["shape"])), "")
        out.append(
            f"| {d['arch']} | {d['shape']} | {rl['compute_s']*1e3:.2f} | "
            f"{rl['memory_s']*1e3:.2f} | {rl['collective_s']*1e3:.2f} | "
            f"{dom.replace('_s','')} | {rl['roofline_fraction']*100:.1f}% |"
            f" {d['useful_ratio']:.2f} | {advice} |")
    return "\n".join(out)


def skip_table(rows: list[dict]) -> str:
    out = ["| arch | shape | reason |", "|---|---|---|"]
    for d in rows:
        if d["status"] == "skipped":
            a, s, _ = d["_file"].replace(".json", "").split("__")
            out.append(f"| {a} | {s} | {d['reason']} |")
    return "\n".join(out)


def dryrun_table(rows: list[dict]) -> str:
    out = ["| arch | shape | mesh | compile (s) | args (GB/dev) | "
           "temp (GB/dev) | collectives (#) |",
           "|---|---|---|---|---|---|---|"]
    for d in sorted(rows, key=lambda r: (r.get("arch", ""),
                                         r.get("shape", ""))):
        if d["status"] != "ok":
            continue
        sc = d["scan_compile"]
        mem = sc["memory"]
        args = (mem.get("argument_size_in_bytes") or 0) / 2**30
        temp = (mem.get("temp_size_in_bytes") or 0) / 2**30
        ncoll = sum(sc.get("collective_counts", {}).values())
        out.append(
            f"| {d['arch']} | {d['shape']} | {d['mesh']} | "
            f"{sc['compile_s']:.0f} | {args:.2f} | {temp:.2f} | {ncoll} |")
    return "\n".join(out)


def main(out_dir="experiments/dryrun"):
    for mesh in ("single", "multi"):
        rows = load(out_dir, mesh)
        if not rows:
            continue
        print(f"\n### Roofline ({mesh}-pod)\n")
        print(roofline_table(rows))
        if mesh == "single":
            print("\n### Skipped cells\n")
            print(skip_table(rows))
            print("\n### Dry-run compile stats\n")
            print(dryrun_table(rows))


if __name__ == "__main__":
    main(*sys.argv[1:])
