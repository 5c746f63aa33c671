"""``python -m repro_torch.workloads`` — ad-hoc YCSB sweeps on the card.

    python -m repro_torch.workloads --preset write-intensive --quick
    python -m repro_torch.workloads --preset ycsb-a --device cpu --json out.json
    python -m repro_torch.workloads --list

Runs on CUDA unless ``--device`` names another device.  The cluster,
open-loop and trace-recording flags of :mod:`repro.workloads.cli` are
accepted and refused: those planes are not ported yet.
"""
from __future__ import annotations

import argparse
from typing import Optional

QUICK = dict(load_records=8_000, ops=1_024, batch=512)


def main(argv: Optional[list] = None) -> str:
    from repro_torch.workloads import engine
    from repro_torch.workloads.spec import PRESETS, get_preset

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.workloads",
        description="Run a named YCSB/Table-3 workload against one or more "
                    "index configurations and write a BENCH_*.json.")
    ap.add_argument("--preset", default=None,
                    help=f"workload name ({', '.join(sorted(PRESETS))})")
    ap.add_argument("--list", action="store_true",
                    help="list presets and systems, then exit")
    ap.add_argument("--systems", default="sherman,fg+",
                    help="comma list of feature configs (default "
                         "sherman,fg+); see --list")
    ap.add_argument("--skew", type=float, default=None,
                    help="override the preset's zipfian theta")
    ap.add_argument("--ops", type=int, default=None,
                    help="override run-phase op count")
    ap.add_argument("--batch", type=int, default=None,
                    help="override ops per batched wave")
    ap.add_argument("--records", type=int, default=None,
                    help="override load-phase record count")
    ap.add_argument("--scan-len", type=int, default=None,
                    help="override entries per scan op")
    ap.add_argument("--cache-bytes", type=int, default=64 << 20,
                    help="CS-side index cache budget in bytes per CS "
                         "(0 disables the cache; default 64 MiB)")
    ap.add_argument("--cache-levels", type=int, default=None,
                    help="cache only the top N internal levels "
                         "(default: every internal level that fits)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the index (default cuda)")
    for flag in ("--n-clients", "--arrival", "--rate", "--record-trace"):
        ap.add_argument(flag, default=None, help="not ported yet")
    ap.add_argument("--partitioned", action="store_true",
                    help="not ported yet")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--quick", action="store_true",
                    help=f"CI-sized run ({QUICK})")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="output path (default BENCH_<preset>.json)")
    args = ap.parse_args(argv)

    if args.list:
        print("presets:")
        for name, s in sorted(PRESETS.items()):
            mix = ", ".join(f"{k}={v:g}" for k, v in s.fractions().items()
                            if v)
            print(f"  {name:16s} {mix}  [{s.distribution}"
                  f"{f' theta={s.theta:g}' if s.distribution != 'uniform' else ''}]")
        print("systems:", ", ".join(sorted(engine.SYSTEMS)))
        return ""
    for flag in ("n_clients", "arrival", "rate", "record_trace",
                 "partitioned"):
        if getattr(args, flag):
            ap.error(f"--{flag.replace('_', '-')}: the cluster, open-loop "
                     f"and observability planes are not ported yet")
    if not args.preset:
        ap.error("--preset is required (or use --list)")

    overrides = dict(QUICK) if args.quick else {}
    for field, val in (("theta", args.skew), ("ops", args.ops),
                       ("batch", args.batch), ("load_records", args.records),
                       ("scan_len", args.scan_len)):
        if val is not None:
            if field != "theta" and val <= 0:
                ap.error(f"--{field.replace('load_records', 'records')} "
                         f"must be positive, got {val}")
            overrides[field] = val
    if args.preset not in PRESETS:
        ap.error(f"unknown preset {args.preset!r}; "
                 f"known: {', '.join(sorted(PRESETS))}")
    spec = get_preset(args.preset, **overrides)
    systems = [s.strip() for s in args.systems.split(",") if s.strip()]
    if not systems:
        ap.error("--systems is empty")
    for s in systems:                      # validate before spending time
        if s.lower() not in engine.SYSTEMS:
            ap.error(f"unknown system {s!r}; "
                     f"known: {', '.join(sorted(engine.SYSTEMS))}")
    if args.cache_bytes < 0:
        ap.error(f"--cache-bytes must be >= 0, got {args.cache_bytes}")
    if args.cache_levels is not None and args.cache_levels <= 0:
        ap.error(f"--cache-levels must be positive, got {args.cache_levels}")

    results = engine.run_systems(spec, systems, seed=args.seed,
                                 cache_bytes=args.cache_bytes,
                                 cache_levels=args.cache_levels,
                                 device=args.device)
    print(f"{'system':18s} {'Mops':>8s} {'p50us':>8s} {'p99us':>10s} "
          f"{'dbl50':>6s} {'wr.B':>7s} {'hit%':>6s} {'rd/l':>5s} "
          f"{'dbells':>8s} {'saved':>7s}")
    for r in results:
        print(f"{r.system:18s} {r.mops:8.2f} {r.p50_us:8.1f} "
              f"{r.p99_us:10.1f} {r.doorbells_p50:6.0f} "
              f"{r.write_bytes_median:7.0f} {100 * r.cache_hit_rate:6.1f} "
              f"{r.reads_per_lookup:5.2f} {r.doorbells:8d} "
              f"{r.doorbells_saved:7d}")

    path = args.json or f"BENCH_{spec.name.replace('-', '_')}.json"
    engine.write_json(path, spec, results)
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main()
