"""Chaos benchmark: degraded throughput, SLO violations and
time-to-recover under a standard fault schedule.

The PyTorch counterpart of :mod:`repro.chaos.bench`.  ``BENCH_chaos.json``
at the repository root is the reference's committed baseline, so the
port's sweep has no default output path: its caller names one.

Per system (sherman, fg+):

1. **Calibrate** — a fault-free run of the same workload on a fresh
   cluster gives the horizon ``H`` (total simulated seconds) and the
   fault-free p99, which sets the SLO (``slo_factor``×p99).
2. **Inject** — a second fresh cluster runs the identical op stream
   under :func:`repro_torch.chaos.faults.schedule_for_horizon`: an MS crash
   with full memory loss early, CS leave/join churn mid-run, and a
   hot-key storm (skew shift to a 16-key hotspot) that lifts before the
   end.  Fault times are fractions of the *calibrated* horizon, so both
   systems face faults at comparable run phases.
3. **Audit** — the faulted run must still satisfy the differential
   harness: final tree contents equal the oracle replay of the executed
   write log, conservation across crash boundaries, clean GLT.

The JSON artifact carries one row per (system, fault) with
``ttr_s`` / ``degraded_mops`` / ``slo_violation_frac`` plus the
per-system audit flags.  The clusters live on ``device`` (default
CUDA); the audit copies the final tree to the host.
"""
from __future__ import annotations

import dataclasses
import json
import tempfile

import numpy as np

from repro_torch.chaos import faults as F
from repro_torch.chaos.runner import ChaosRunner
from repro_torch.cluster.sched import VAL_MASK, build_cluster
from repro_torch.core.tree import TreeConfig
from repro_torch.workloads.keygen import scramble
from repro_torch.workloads.spec import get_preset


#: Chaos runs use a small pool so the quick (CI) configuration still
#: crosses enough rounds to place five faults between round boundaries.
CHAOS_CFG = TreeConfig(n_ms=2, nodes_per_ms=4096, fanout=16,
                       n_locks_per_ms=4096, max_height=6, n_cs=4)


def _build(system: str, records: int, n_clients: int, device=None):
    from repro_torch.workloads.engine import SYSTEMS
    return build_cluster(SYSTEMS[system.lower()], CHAOS_CFG,
                         n_clients=n_clients, records=records,
                         cache_bytes=8 << 20, sync_rounds=2, device=device)


def chaos_sweep(records: int = 6_000, ops: int = 4_096,
                n_clients: int = 16, preset: str = "write-intensive",
                systems=("sherman", "fg+"), slo_factor: float = 3.0,
                seed: int = 1, *, out: str, device=None) -> dict:
    """Run the calibrate→inject→audit loop and write ``out`` (no
    default: the repository's ``BENCH_chaos.json`` is the reference's)."""
    base = get_preset(preset, load_records=records, ops=ops)
    results, schedules = [], {}
    for system in systems:
        # 1. calibrate on a fault-free twin
        cal = ChaosRunner(_build(system, records, n_clients, device), base,
                          seed=seed).run()
        cal_rep = cal.report()
        horizon = cal_rep["sim_time_s"]
        p99 = [x["p99_us"] for x in cal.samples if x["p99_us"] > 0]
        slo_us = slo_factor * float(np.median(p99)) if p99 else None
        # 2. inject
        sched = F.schedule_for_horizon(horizon, cs=1)
        spec = base.replace(faults=sched)
        schedules[system] = [dataclasses.asdict(ev) for ev in sched]
        with tempfile.TemporaryDirectory() as ckpt:
            runner = ChaosRunner(
                _build(system, records, n_clients, device), spec, seed=seed,
                ckpt_dir=ckpt, slo_us=slo_us,
                ckpt_every=max(1, cal.total_rounds // 8))
            runner.run()
            rep = runner.report()
        # 3. audit: differential oracle over the executed write log
        oracle = F.oracle_replay(
            *_load_keys_vals(records), runner.write_log)
        got = F.tree_contents(runner.cluster.state)
        oracle_ok = got == dict(oracle.items())
        results.append(dict(
            system=system, slo_us=slo_us,
            horizon_s=float(horizon),
            calibrated_mops=cal_rep["overall_mops"],
            baseline_mops=rep["baseline_mops"],
            overall_mops=rep["overall_mops"],
            oracle_ok=bool(oracle_ok),
            conservation_ok=rep["conservation_ok"],
            glt_clean=rep["glt_clean"],
            unfired_faults=rep["unfired_faults"],
            faults=rep["faults"]))
    payload = dict(kind="chaos", preset=preset, records=records,
                   ops=ops, n_clients=n_clients, seed=seed,
                   spec=base.to_dict(), schedules=schedules,
                   results=results)
    with open(out, "w") as f:
        json.dump(payload, f, indent=2)
        f.write("\n")
    return payload


def _load_keys_vals(records: int, keyspace: int = 1 << 20,
                    seed: int = 0):
    """The exact bulk-load records ``build_cluster`` used (same seed)."""
    rng = np.random.default_rng(seed)
    keys = scramble(np.arange(records, dtype=np.int64), keyspace)
    vals = rng.integers(0, VAL_MASK, size=records)
    return keys, vals
