"""The workload driver: run any :class:`WorkloadSpec` against the index.

The PyTorch counterpart of :mod:`repro.workloads.engine` for single-frontend
runs: :func:`run_workload` executes the spec's op mix in batched waves and
derives a structured :class:`RunResult` (throughput, latency percentiles,
doorbell depth, write bytes, per-op-type counters) from the index's netsim
counters.  The index lives on CUDA unless the caller passes
``device="cpu"``.  The cluster, open-loop and recorder entry points of the
reference are not ported yet.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import ShermanIndex, TreeConfig
from repro_torch.core.netsim import ABLATION_LADDER, FG_PLUS, SHERMAN, \
    Features
from repro_torch.core.tree import EMPTY_KEY
from repro_torch.device import resolve_device
from repro_torch.workloads.keygen import draw_keys, scramble
from repro_torch.workloads.spec import OP_KINDS, WorkloadSpec

KEYSPACE = 1 << 20            # power of two => rank scramble is a bijection
DEFAULT_CFG = TreeConfig(n_ms=4, nodes_per_ms=4096, fanout=16,
                         n_locks_per_ms=4096, max_height=7, n_cs=8)
VAL_MASK = (1 << 30) - 1
#: Records generated per step of the load phase (bounds host memory).
LOAD_CHUNK = 1 << 24

#: Named feature configurations runnable from the CLI: ``sherman``,
#: ``fg+``, the Fig. 10/11 ablation rungs, plus single-feature negations of
#: full Sherman (``sherman-nocombine``, ``sherman-flat``).
SYSTEMS: dict[str, Features] = {
    "sherman": SHERMAN,
    "fg+": FG_PLUS,
    "sherman-nocombine": Features(combine=False, onchip=True,
                                  hierarchical=True, twolevel=True),
    "sherman-flat": Features(combine=True, onchip=True,
                             hierarchical=False, twolevel=True),
    **{name.lower(): feat for name, feat in ABLATION_LADDER},
}


@dataclasses.dataclass
class RunResult:
    """Structured result of one workload run (one system, one spec).

    The fields are the reference's; the cluster, open-loop and
    observability fields keep their closed-loop defaults here."""

    mops: float
    p50_us: float
    p90_us: float
    p99_us: float
    counters: dict
    system: str = ""
    workload: str = ""
    n_ops: int = 0
    read_p50_us: float = 0.0
    read_p99_us: float = 0.0
    write_p50_us: float = 0.0
    write_p99_us: float = 0.0
    doorbells_p50: float = 0.0   # doorbell-ring depth per write op
    doorbells_p99: float = 0.0
    write_bytes_median: float = 0.0
    op_counts: dict = dataclasses.field(default_factory=dict)
    cache_hits: int = 0          # lookups served by a clean cache hit
    cache_misses: int = 0        # descents that left the cached set
    cache_stale: int = 0         # hits recovered via the stale path
    cache_hit_rate: float = 0.0  # hits / (hits + misses + stale)
    reads_per_lookup: float = 0.0  # mean remote node reads per point lookup
    verbs: int = 0               # one-sided verbs posted (READ/WRITE/CAS)
    doorbells: int = 0           # doorbell rings (combined verbs share one)
    doorbells_saved: int = 0     # rings saved by command combination
    retried_ops: int = 0         # lanes resubmitted by later write phases
    n_clients: int = 0
    rounds: int = 0
    per_cs: list = dataclasses.field(default_factory=list)
    conservation_ok: bool = True
    arrival: str = "closed"
    offered_mops: float = 0.0
    queue_mean_us: float = 0.0
    queue_p50_us: float = 0.0
    queue_p99_us: float = 0.0
    service_mean_us: float = 0.0
    slo_us: float = 0.0
    slo_attainment: float = 0.0
    sustained_frac: float = 0.0
    obs: dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return _pyify(dataclasses.asdict(self))


def _pyify(x):
    """Recursively convert numpy scalars so the result is json-safe."""
    if isinstance(x, dict):
        return {k: _pyify(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_pyify(v) for v in x]
    if isinstance(x, np.integer):
        return int(x)
    if isinstance(x, np.floating):
        return float(x)
    return x


def load_arrays(records: int, keyspace: int = KEYSPACE, seed: int = 0,
                device=None, chunk: int = LOAD_CHUNK):
    """The load phase's records as int32 tensors on ``device``: insertion
    ranks ``0..records`` scrambled across the keyspace, and values from
    ``np.random.default_rng(seed).integers(0, VAL_MASK)`` — the reference
    recipe, generated ``chunk`` records at a time so host memory stays
    bounded (one generator drawn in steps gives the single draw's values).
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    keys = torch.empty((records,), dtype=torch.int32, device=dev)
    vals = torch.empty((records,), dtype=torch.int32, device=dev)
    for lo in range(0, records, chunk):
        hi = min(records, lo + chunk)
        k = scramble(np.arange(lo, hi, dtype=np.int64), keyspace)
        v = rng.integers(0, VAL_MASK, size=hi - lo)
        keys[lo:hi] = torch.from_numpy(k.astype(np.int32))
        vals[lo:hi] = torch.from_numpy(v.astype(np.int32))
    return keys, vals


def build_index(features: Features, cfg: TreeConfig = DEFAULT_CFG, *,
                records: int = 60_000, keyspace: int = KEYSPACE,
                cache_bytes: int = 64 << 20,
                cache_levels: Optional[int] = None, seed: int = 0,
                fill: float = 0.8, device=None) -> ShermanIndex:
    """Load phase: bulk-load ``records`` records on ``device`` (default
    CUDA)."""
    keys, vals = load_arrays(records, keyspace, seed, device)
    return ShermanIndex.build(cfg, keys, vals, fill=fill, features=features,
                              cache_bytes=cache_bytes,
                              cache_levels=cache_levels)


def live_records(idx: ShermanIndex) -> int:
    """Count live leaf entries — the record-space size for distribution
    draws when the index wasn't built by :func:`build_index`."""
    st = idx.state
    leaf = (st.level == 0) & ~st.free_bit
    return int((st.keys[leaf] != EMPTY_KEY).sum())


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported to repro_torch yet")


def run_workload(idx: ShermanIndex, spec: WorkloadSpec, *, seed: int = 1,
                 keyspace: int = KEYSPACE, system: str = "",
                 recorder=None, tail_k: int = 16) -> RunResult:
    """Run ``spec``'s op mix against ``idx`` and price it via netsim.

    The result reports only this run's deltas, so several runs may share one
    index.  ``recorder`` (the observability plane) is not ported yet.
    """
    if recorder is not None:
        _not_ported("the observability plane (recorder)")
    rng = np.random.default_rng(seed)
    c0 = dict(idx.counters)
    lw0, lr0 = len(idx.latencies_write), len(idx.latencies_read)
    db0, wb0 = len(idx.doorbells_write), len(idx.write_bytes)

    n_records = spec.load_records      # live records (grows with inserts)
    cursor = spec.load_records         # next sequential insertion rank
    op_counts = {k: 0 for k in OP_KINDS}

    def draw(n):
        return draw_keys(rng, n, distribution=spec.distribution,
                         theta=spec.theta, nspace=n_records,
                         keyspace=keyspace).astype(np.int32)

    done = 0
    while done < spec.ops:
        b = min(spec.batch, spec.ops - done)
        counts = spec.batch_counts(b)
        if counts["scan"]:
            idx.range(draw(counts["scan"]), count=spec.scan_len,
                      max_leaves=max(4, spec.scan_len))
        if counts["read"]:
            idx.lookup(draw(counts["read"]))
        if counts["rmw"]:
            keys = draw(counts["rmw"])
            got, _ = idx.lookup(keys)
            idx.insert(keys, (got.astype(np.int64) + 1) & VAL_MASK)
        if counts["update"]:
            keys = draw(counts["update"])
            idx.insert(keys, rng.integers(0, VAL_MASK, keys.size))
        if counts["delete"]:
            idx.delete(draw(counts["delete"]))
        if counts["insert"]:
            ranks = np.arange(cursor, cursor + counts["insert"])
            cursor += counts["insert"]
            n_records = max(n_records, cursor)
            idx.insert(scramble(ranks, keyspace).astype(np.int32),
                       rng.integers(0, VAL_MASK, ranks.size))
        for k in OP_KINDS:
            op_counts[k] += counts[k]
        done += b

    sim_s = idx.counters["sim_time_s"] - c0.get("sim_time_s", 0.0)
    lat_w = _cat(idx.latencies_write[lw0:])
    lat_r = _cat(idx.latencies_read[lr0:])
    dbells = _cat(idx.doorbells_write[db0:])
    wb = _cat(idx.write_bytes[wb0:])
    delta = {k: idx.counters[k] - c0.get(k, 0) for k in idx.counters}
    return _summarize(spec, delta, done, sim_s, lat_w, lat_r, dbells, wb,
                      system=system,
                      op_counts={k: v for k, v in op_counts.items() if v})


def _cat(arrs) -> np.ndarray:
    """Concatenate a (possibly empty) list of per-phase sample arrays."""
    return np.concatenate(arrs) if arrs else np.zeros(0)


def _summarize(spec: WorkloadSpec, delta: dict, done: int, sim_s: float,
               lat_w, lat_r, dbells, wb, *, system: str = "",
               op_counts: Optional[dict] = None) -> RunResult:
    """Fold one run's counter deltas + latency samples into a RunResult;
    percentiles over empty sample sets are 0.0, as is throughput when
    nothing was priced."""
    lat = np.concatenate([lat_w, lat_r])

    def pct(a, p, scale=1e6):
        return float(np.percentile(a, p)) * scale if a.size else 0.0

    cache_total = (delta["cache_hits"] + delta["cache_misses"]
                   + delta["cache_stale"])
    return RunResult(
        mops=done / sim_s / 1e6 if sim_s else 0.0,
        p50_us=pct(lat, 50), p90_us=pct(lat, 90), p99_us=pct(lat, 99),
        counters=delta, system=system, workload=spec.name, n_ops=done,
        read_p50_us=pct(lat_r, 50), read_p99_us=pct(lat_r, 99),
        write_p50_us=pct(lat_w, 50), write_p99_us=pct(lat_w, 99),
        doorbells_p50=pct(dbells, 50, 1.0),
        doorbells_p99=pct(dbells, 99, 1.0),
        write_bytes_median=float(np.median(wb)) if wb.size else 0.0,
        op_counts=op_counts or {},
        cache_hits=delta["cache_hits"], cache_misses=delta["cache_misses"],
        cache_stale=delta["cache_stale"],
        cache_hit_rate=(delta["cache_hits"] / cache_total
                        if cache_total else 0.0),
        reads_per_lookup=(delta["lookup_reads"] / delta["lookup_ops"]
                          if delta["lookup_ops"] else 0.0),
        verbs=delta["verbs"], doorbells=delta["doorbells"],
        doorbells_saved=delta["verbs"] - delta["doorbells"],
        retried_ops=delta["retried_ops"])


def run_systems(spec: WorkloadSpec, systems: Sequence[str] = ("sherman",
                                                              "fg+"),
                cfg: TreeConfig = DEFAULT_CFG, *, keyspace: int = KEYSPACE,
                cache_bytes: int = 64 << 20,
                cache_levels: Optional[int] = None,
                seed: int = 1, recorders: Optional[dict] = None,
                tail_k: int = 16, device=None) -> list[RunResult]:
    """Run one spec against several named systems (fresh index each) on
    ``device`` (default CUDA)."""
    if recorders is not None:
        _not_ported("the observability plane (recorders)")
    out = []
    for name in systems:
        try:
            feat = SYSTEMS[name.lower()]
        except KeyError:
            raise KeyError(f"unknown system {name!r}; "
                           f"known: {', '.join(sorted(SYSTEMS))}") from None
        idx = build_index(feat, cfg, records=spec.load_records,
                          keyspace=keyspace, cache_bytes=cache_bytes,
                          cache_levels=cache_levels, device=device)
        out.append(run_workload(idx, spec, seed=seed, keyspace=keyspace,
                                system=name, tail_k=tail_k))
    return out


def write_json(path: str, spec: WorkloadSpec,
               results: Sequence[RunResult],
               extra: Optional[dict] = None) -> str:
    """Serialize a sweep to a ``BENCH_*.json`` file; returns the path."""
    payload = {"spec": spec.to_dict(),
               "results": [r.to_dict() for r in results]}
    if extra:
        payload.update(_pyify(extra))
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
        f.write("\n")
    return path
