"""``python -m repro_torch.workloads`` — ad-hoc YCSB sweeps on the card.

    python -m repro_torch.workloads --preset write-intensive --quick
    python -m repro_torch.workloads --preset ycsb-a --device cpu --json out.json
    python -m repro_torch.workloads --list

    python -m repro_torch.workloads --preset ycsb-a --quick --n-clients 16 \
        --arrival poisson --rate 0.5 --record-trace trace.json --device cpu

Runs on CUDA unless ``--device`` names another device.  The flags are
those of :mod:`repro.workloads.cli`, plus ``--device``.
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
    ap.add_argument("--n-clients", type=int, default=None,
                    help="run through the multi-CS cluster plane with N "
                         "concurrent client threads spread over the "
                         "config's compute servers (private caches + "
                         "merged cross-CS contention; DESIGN.md §11)")
    ap.add_argument("--partitioned", action="store_true",
                    help="DEX-style static key partitioning across the "
                         "CSs (cluster plane only): each CS draws from "
                         "its own record shard instead of the shared "
                         "hot set")
    ap.add_argument("--arrival", default=None,
                    choices=("poisson", "bursty", "diurnal"),
                    help="open-loop serving plane (DESIGN.md §12): ops "
                         "arrive per this process at --rate instead of "
                         "draining in lockstep rounds; requires "
                         "--n-clients and --rate")
    ap.add_argument("--rate", type=float, default=None, metavar="MOPS",
                    help="offered load in Mops/s for --arrival")
    ap.add_argument("--slo-us", type=float, default=100.0,
                    help="sojourn SLO (us) used for slo_attainment in "
                         "open-loop runs (default 100)")
    ap.add_argument("--record-trace", default=None, metavar="PATH",
                    help="record the run through the observability plane "
                         "(repro_torch.obs, DESIGN.md §14) and export a "
                         "Chrome/Perfetto trace-viewer JSON per system "
                         "(multi-system runs suffix PATH with the system "
                         "name); the BENCH json gains the obs breakdown")
    ap.add_argument("--tail-k", type=int, default=16,
                    help="top-K slowest ops kept in the tail-forensics "
                         "table (default 16; needs --record-trace)")
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

    if args.n_clients is not None and args.n_clients <= 0:
        ap.error(f"--n-clients must be positive, got {args.n_clients}")
    if args.partitioned and args.n_clients is None:
        ap.error("--partitioned requires --n-clients (cluster plane)")
    if args.arrival is not None:
        if args.n_clients is None:
            ap.error("--arrival requires --n-clients (the serving plane "
                     "feeds the cluster scheduler)")
        if args.rate is None or args.rate <= 0:
            ap.error("--arrival requires a positive --rate (Mops/s)")
        spec = spec.replace(arrival=args.arrival, offered_mops=args.rate)
    elif args.rate is not None:
        ap.error("--rate only makes sense with --arrival")
    if args.slo_us <= 0:
        ap.error(f"--slo-us must be positive, got {args.slo_us}")
    if args.tail_k <= 0:
        ap.error(f"--tail-k must be positive, got {args.tail_k}")

    recorders = {} if args.record_trace else None
    rec_kw = dict(recorders=recorders, tail_k=args.tail_k)
    if args.arrival is not None:
        results = engine.run_open_loop_systems(
            spec, systems, n_clients=args.n_clients, seed=args.seed,
            cache_bytes=args.cache_bytes, cache_levels=args.cache_levels,
            partitioned=args.partitioned, slo_us=args.slo_us,
            device=args.device, **rec_kw)
    elif args.n_clients is not None:
        results = engine.run_cluster_systems(
            spec, systems, n_clients=args.n_clients, seed=args.seed,
            cache_bytes=args.cache_bytes, cache_levels=args.cache_levels,
            partitioned=args.partitioned, device=args.device, **rec_kw)
    else:
        results = engine.run_systems(spec, systems, seed=args.seed,
                                     cache_bytes=args.cache_bytes,
                                     cache_levels=args.cache_levels,
                                     device=args.device, **rec_kw)
    print(f"{'system':18s} {'Mops':>8s} {'p50us':>8s} {'p99us':>10s} "
          f"{'dbl50':>6s} {'wr.B':>7s} {'hit%':>6s} {'rd/l':>5s} "
          f"{'dbells':>8s} {'saved':>7s}")
    for r in results:
        print(f"{r.system:18s} {r.mops:8.2f} {r.p50_us:8.1f} "
              f"{r.p99_us:10.1f} {r.doorbells_p50:6.0f} "
              f"{r.write_bytes_median:7.0f} {100 * r.cache_hit_rate:6.1f} "
              f"{r.reads_per_lookup:5.2f} {r.doorbells:8d} "
              f"{r.doorbells_saved:7d}")
        if r.per_cs:
            stale = sum(p["cache_stale"] for p in r.per_cs)
            print(f"  cluster: {len(r.per_cs)} CS x "
                  f"{r.n_clients // len(r.per_cs)} threads, "
                  f"{r.rounds} rounds, stale={stale}, "
                  f"conservation={'OK' if r.conservation_ok else 'VIOLATED'}")
        if r.arrival != "closed":
            print(f"  open loop: {r.arrival} @ {r.offered_mops:.2f} Mops "
                  f"offered, queue mean/p99 = {r.queue_mean_us:.2f}/"
                  f"{r.queue_p99_us:.2f} us, service mean = "
                  f"{r.service_mean_us:.2f} us, SLO({r.slo_us:.0f}us) "
                  f"attainment = {100 * r.slo_attainment:.1f}%, "
                  f"sustained = {100 * r.sustained_frac:.1f}%")

    if recorders:
        from repro_torch.obs import write_chrome_trace
        for r in results:
            rec = recorders.get(r.system)
            if rec is None:
                continue
            tp = args.record_trace
            if len(results) > 1:            # one trace file per system
                stem, dot, ext = tp.rpartition(".")
                tp = (f"{stem}.{r.system}.{ext}" if dot
                      else f"{tp}.{r.system}")
            write_chrome_trace(rec, tp)
            a = r.obs.get("tail_attribution", {})
            print(f"  trace: {tp} ({rec.n_verbs} verbs, "
                  f"tail p99 attribution: "
                  f"nic={100 * a.get('nic_queue_frac', 0):.0f}% "
                  f"atomic={100 * a.get('atomic_ser_frac', 0):.0f}% "
                  f"lock={100 * a.get('lock_wait_frac', 0):.0f}% "
                  f"svc={100 * a.get('service_frac', 0):.0f}%)")

    path = args.json or f"BENCH_{spec.name.replace('-', '_')}.json"
    engine.write_json(path, spec, results)
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main()
