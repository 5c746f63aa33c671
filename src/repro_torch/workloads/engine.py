"""The workload driver: run any :class:`WorkloadSpec` against the index.

The PyTorch counterpart of :mod:`repro.workloads.engine`:
:func:`run_workload` executes the spec's op mix in batched waves and
derives a structured :class:`RunResult` (throughput, latency percentiles,
doorbell depth, write bytes, per-op-type counters) from the index's netsim
counters; :func:`run_cluster_workload` and :func:`run_open_loop_workload`
drive the same spec through the multi-CS cluster plane, closed and open
loop; a :class:`repro_torch.obs.Recorder` opts any of them into the
observability plane.  The index or the fleet's pool lives on CUDA unless
the caller passes ``device="cpu"``.
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

    The fields are the reference's; single-frontend closed-loop runs keep
    the cluster, open-loop and observability fields at their defaults."""

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


def _obs_summary(recorder, tail_k: int) -> dict:
    """``RunResult.obs`` payload for an optionally-recorded run."""
    if recorder is None:
        return {}
    from repro_torch.obs import summarize
    return summarize(recorder, tail_k=tail_k)


def run_workload(idx: ShermanIndex, spec: WorkloadSpec, *, seed: int = 1,
                 keyspace: int = KEYSPACE, system: str = "",
                 recorder=None, tail_k: int = 16) -> RunResult:
    """Run ``spec``'s op mix against ``idx`` and price it via netsim.

    The result reports only this run's deltas, so several runs may share one
    index.  ``recorder`` (a :class:`repro_torch.obs.Recorder`) opts into
    the observability plane: every priced phase captures its per-verb
    timeline and the result's ``obs`` field carries the aggregate
    breakdown (top-``tail_k`` forensics included).
    """
    rng = np.random.default_rng(seed)
    if recorder is not None:
        idx.recorder = recorder
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
                      op_counts={k: v for k, v in op_counts.items() if v},
                      obs=_obs_summary(recorder, tail_k))


def _cat(arrs) -> np.ndarray:
    """Concatenate a (possibly empty) list of per-phase sample arrays."""
    return np.concatenate(arrs) if arrs else np.zeros(0)


def _summarize(spec: WorkloadSpec, delta: dict, done: int, sim_s: float,
               lat_w, lat_r, dbells, wb, *, system: str = "",
               op_counts: Optional[dict] = None, **extra) -> RunResult:
    """Fold one run's counter deltas + latency samples into a RunResult.
    Shared by the single-frontend and cluster drivers; percentiles over
    empty sample sets are 0.0, as is throughput when nothing was priced."""
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
        retried_ops=delta["retried_ops"], **extra)


def _new_recorder(recorders: Optional[dict], name: str):
    """A fresh per-system Recorder when the caller opted into recording
    by passing a ``recorders`` dict (filled in as an out-parameter so
    the CLI can export the captured timelines)."""
    if recorders is None:
        return None
    from repro_torch.obs import Recorder
    recorders[name] = Recorder()
    return recorders[name]


def _system(name: str) -> Features:
    try:
        return SYSTEMS[name.lower()]
    except KeyError:
        raise KeyError(f"unknown system {name!r}; "
                       f"known: {', '.join(sorted(SYSTEMS))}") from None


def run_systems(spec: WorkloadSpec, systems: Sequence[str] = ("sherman",
                                                              "fg+"),
                cfg: TreeConfig = DEFAULT_CFG, *, keyspace: int = KEYSPACE,
                cache_bytes: int = 64 << 20,
                cache_levels: Optional[int] = None,
                seed: int = 1, recorders: Optional[dict] = None,
                tail_k: int = 16, device=None) -> list[RunResult]:
    """Run one spec against several named systems (fresh index each) on
    ``device`` (default CUDA)."""
    out = []
    for name in systems:
        idx = build_index(_system(name), cfg, records=spec.load_records,
                          keyspace=keyspace, cache_bytes=cache_bytes,
                          cache_levels=cache_levels, device=device)
        out.append(run_workload(idx, spec, seed=seed, keyspace=keyspace,
                                system=name,
                                recorder=_new_recorder(recorders, name),
                                tail_k=tail_k))
    return out


def run_cluster_workload(spec: WorkloadSpec, features: Features, *,
                         n_clients: int, cfg: TreeConfig = DEFAULT_CFG,
                         keyspace: int = KEYSPACE,
                         cache_bytes: int = 64 << 20,
                         cache_levels: Optional[int] = None,
                         partitioned: bool = False, sync_rounds: int = 4,
                         seed: int = 1, system: str = "",
                         recorder=None, tail_k: int = 16,
                         device=None) -> RunResult:
    """Run one spec through the multi-CS cluster plane (DESIGN.md §11) on
    ``device`` (default CUDA).

    ``n_clients`` concurrent client threads are spread over
    ``min(cfg.n_cs, n_clients)`` compute servers, each with a private
    index cache / LLT view; every wave is priced by merging the
    fleet's verb traces into one shared-resource timeline.  The result
    carries the per-CS breakdown (``per_cs``) and the merged-vs-functional
    ``conservation_ok`` invariant.
    """
    from repro_torch.cluster import build_cluster, run_cluster
    cluster = build_cluster(features, cfg, n_clients=n_clients,
                            records=spec.load_records, keyspace=keyspace,
                            cache_bytes=cache_bytes,
                            cache_levels=cache_levels,
                            sync_rounds=sync_rounds, seed=0, device=device)
    cluster.recorder = recorder
    done, op_counts = run_cluster(cluster, spec, partitioned=partitioned,
                                  seed=seed, keyspace=keyspace)
    return cluster_result(cluster, spec, done, op_counts, system=system,
                          obs=_obs_summary(recorder, tail_k))


def cluster_result(cluster, spec: WorkloadSpec, done: int, op_counts: dict,
                   *, system: str = "", obs=None) -> RunResult:
    """Fold one closed-loop run of ``cluster`` into a RunResult: merged
    totals plus the per-CS breakdown and the conservation verdict."""
    delta = cluster.combined_counters()
    return _summarize(
        spec, delta, done, delta["sim_time_s"],
        _cat(cluster.latencies_write), _cat(cluster.latencies_read),
        _cat(cluster.doorbells_write), _cat(cluster.write_bytes),
        system=system, op_counts=op_counts, n_clients=cluster.n_clients,
        rounds=delta["rounds"], per_cs=_per_cs_rows(cluster),
        conservation_ok=cluster.conservation_ok(), obs=obs or {})


def _per_cs_rows(cluster) -> list:
    """Per-CS breakdown rows shared by the cluster + open-loop drivers."""
    rows = []
    for node in cluster.nodes:
        c = node.counters
        t = c["cache_hits"] + c["cache_misses"] + c["cache_stale"]
        rows.append(dict(
            cs=node.cs_id, ops=c["ops"], write_ops=c["write_ops"],
            read_ops=c["read_ops"], retried_ops=c["retried_ops"],
            verbs=c["verbs"], doorbells=c["doorbells"],
            leaf_splits=c["leaf_splits"], handovers=c["handovers"],
            cache_hits=c["cache_hits"], cache_misses=c["cache_misses"],
            cache_stale=c["cache_stale"],
            cache_hit_rate=c["cache_hits"] / t if t else 0.0))
    return rows


def run_open_loop_workload(spec: WorkloadSpec, features: Features, *,
                           n_clients: int, cfg: TreeConfig = DEFAULT_CFG,
                           keyspace: int = KEYSPACE,
                           cache_bytes: int = 64 << 20,
                           cache_levels: Optional[int] = None,
                           partitioned: bool = False, sync_rounds: int = 4,
                           seed: int = 1, system: str = "",
                           slo_us: float = 100.0,
                           recorder=None, tail_k: int = 16,
                           device=None) -> RunResult:
    """Run one spec open-loop through the serving plane (DESIGN.md §12) on
    ``device`` (default CUDA).

    Ops arrive per ``spec.arrival`` / ``spec.offered_mops`` instead of
    being drained in lockstep rounds: the admission loop feeds the same
    bucketed cluster waves as arrivals drain, waves replay on one
    absolute :class:`~repro_torch.core.netsim.ServerClock` timeline, and
    every op's latency is its *sojourn* (arrival → completion) with the
    NIC/atomic queueing share reported separately
    (``queue_*`` vs ``service_mean_us``).
    """
    from repro_torch.cluster import build_cluster
    from repro_torch.serve.loop import run_open_loop
    cluster = build_cluster(features, cfg, n_clients=n_clients,
                            records=spec.load_records, keyspace=keyspace,
                            cache_bytes=cache_bytes,
                            cache_levels=cache_levels,
                            sync_rounds=sync_rounds, seed=0, device=device)
    cluster.recorder = recorder   # enable_open_loop hands it to the clock
    done, op_counts, info = run_open_loop(cluster, spec, seed=seed,
                                          keyspace=keyspace,
                                          partitioned=partitioned)
    return open_loop_result(cluster, spec, done, op_counts, info,
                            system=system, slo_us=slo_us,
                            obs=_obs_summary(recorder, tail_k))


def open_loop_result(cluster, spec: WorkloadSpec, done: int,
                     op_counts: dict, info: dict, *, system: str = "",
                     slo_us: float = 100.0, obs=None) -> RunResult:
    """Fold one open-loop run of ``cluster`` into a RunResult: sojourn
    percentiles, queueing delay apart from service, SLO attainment and
    the sustained share of the offered load."""
    delta = cluster.combined_counters()
    lat_w = _cat(cluster.latencies_write)
    lat_r = _cat(cluster.latencies_read)
    lat = np.concatenate([lat_w, lat_r])
    q = np.concatenate([_cat(cluster.queue_write),
                        _cat(cluster.queue_read)])
    horizon = delta["sim_time_s"]
    achieved = done / horizon / 1e6 if horizon else 0.0
    offered = info["offered_ops_s"] / 1e6
    return _summarize(
        spec, delta, done, horizon, lat_w, lat_r,
        _cat(cluster.doorbells_write), _cat(cluster.write_bytes),
        system=system, op_counts=op_counts, n_clients=cluster.n_clients,
        rounds=info["waves"], per_cs=_per_cs_rows(cluster),
        conservation_ok=cluster.conservation_ok(),
        arrival=spec.arrival, offered_mops=offered,
        queue_mean_us=float(q.mean()) * 1e6 if q.size else 0.0,
        queue_p50_us=float(np.percentile(q, 50)) * 1e6 if q.size else 0.0,
        queue_p99_us=float(np.percentile(q, 99)) * 1e6 if q.size else 0.0,
        service_mean_us=(float(lat.mean() - q.mean()) * 1e6
                         if lat.size and q.size else 0.0),
        slo_us=slo_us,
        slo_attainment=(float((lat <= slo_us * 1e-6).mean())
                        if lat.size else 0.0),
        sustained_frac=(min(1.0, achieved / offered) if offered else 1.0),
        obs=obs or {})


def run_open_loop_systems(spec: WorkloadSpec,
                          systems: Sequence[str] = ("sherman", "fg+"),
                          cfg: TreeConfig = DEFAULT_CFG, *,
                          n_clients: int, keyspace: int = KEYSPACE,
                          cache_bytes: int = 64 << 20,
                          cache_levels: Optional[int] = None,
                          partitioned: bool = False, sync_rounds: int = 4,
                          seed: int = 1,
                          slo_us: float = 100.0,
                          recorders: Optional[dict] = None,
                          tail_k: int = 16, device=None) -> list[RunResult]:
    """Open-loop analogue of :func:`run_cluster_systems`."""
    return [run_open_loop_workload(
        spec, _system(name), n_clients=n_clients, cfg=cfg,
        keyspace=keyspace, cache_bytes=cache_bytes,
        cache_levels=cache_levels, partitioned=partitioned,
        sync_rounds=sync_rounds, seed=seed, system=name, slo_us=slo_us,
        recorder=_new_recorder(recorders, name), tail_k=tail_k,
        device=device) for name in systems]


def run_cluster_systems(spec: WorkloadSpec,
                        systems: Sequence[str] = ("sherman", "fg+"),
                        cfg: TreeConfig = DEFAULT_CFG, *,
                        n_clients: int, keyspace: int = KEYSPACE,
                        cache_bytes: int = 64 << 20,
                        cache_levels: Optional[int] = None,
                        partitioned: bool = False, sync_rounds: int = 4,
                        seed: int = 1, recorders: Optional[dict] = None,
                        tail_k: int = 16, device=None) -> list[RunResult]:
    """Cluster-plane analogue of :func:`run_systems` (fresh fleet each,
    on ``device``, default CUDA)."""
    return [run_cluster_workload(
        spec, _system(name), n_clients=n_clients, cfg=cfg,
        keyspace=keyspace, cache_bytes=cache_bytes,
        cache_levels=cache_levels, partitioned=partitioned,
        sync_rounds=sync_rounds, seed=seed, system=name,
        recorder=_new_recorder(recorders, name), tail_k=tail_k,
        device=device) for name in systems]


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
