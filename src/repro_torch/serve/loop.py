"""The open-loop admission/dispatch loop (DESIGN.md §12), the port of
:mod:`repro.serve.loop` over :class:`repro_torch.cluster.Cluster`.

Two layers live here:

* :func:`simulate_station` / :func:`station_trace` — the **single-station
  harness**: one independent verb per op against netsim's per-MS FIFO,
  with arrivals as absolute ``at`` release gates.  This is an M/G/1
  queue by construction (service = ``max(1/iops, bytes/bw)``), which is
  what lets tests/test_serve_queueing.py pin the replay engines against
  the Pollaczek–Khinchine closed forms (M/D/1, M/M/1).

* :func:`run_open_loop` — the **cluster serving loop**: materialize the
  spec's ops in the closed-loop scheduler's exact RNG order
  (:func:`materialize_ops`), thin one global arrival stream round-robin
  into per-CS admission queues, and dispatch waves through the existing
  bucketed write/read phases as arrivals drain.  Arrival timestamps travel
  into the merged traces as release gates and the waves replay on one
  carried :class:`~repro_torch.core.netsim.ServerClock` timeline, so per-op
  sojourn = queueing delay + service, measured — not batch artifacts.

Wave formation is a pure *execution-granularity* knob: because release
gates carry the true arrival times and the clock carries true busy
frontiers, dispatching ops in one wave or many yields identical
completion ticks (the chunking-invariance property the tests pin).  The
host loop therefore batches admissions up to a window of
``batch_fill * n_clients / rate`` seconds purely to keep the wave
count ~O(ops / n_clients).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import netsim, verbs as V
from repro_torch.core.netsim import PS_PER_S, NetConfig, ServerClock
from repro_torch.serve.arrivals import make_arrivals
from repro_torch.workloads.spec import OP_KINDS, WorkloadSpec

VAL_MASK = (1 << 30) - 1

#: Wave kind execution order — must equal ``run_cluster``'s fixed order
#: (scan, read, rmw, update, delete, insert): the t=0 differential test
#: pins the open loop trace-identical to the closed-loop scheduler.
KIND_ORDER = ("scan", "read", "rmw", "update", "delete", "insert")
KIND_CODE = {k: i for i, k in enumerate(KIND_ORDER)}


# --------------------------------------------------------------------------
# single-station M/G/1 harness
# --------------------------------------------------------------------------

def station_trace(arrival_s: np.ndarray, nbytes: np.ndarray,
                  n_ms: int = 1, start: int = 0) -> V.VerbTrace:
    """One independent READ verb per op (no deps, own doorbell), released
    at its arrival time — netsim's per-MS FIFO then *is* a FIFO queue
    with service ``max(1/iops, bytes/bw)``.  ``start`` is the op's global
    stream position, so MS round-robin assignment is invariant to how
    the stream is chunked into waves."""
    arrival_s = np.asarray(arrival_s, np.float64)
    n = arrival_s.size
    idx = np.arange(n, dtype=np.int64)
    return V.VerbTrace(
        kind=np.full(n, V.READ, np.int8),
        role=np.full(n, V.TRAVERSE, np.int8),
        ms=((idx + int(start)) % max(n_ms, 1)).astype(np.int32),
        nbytes=np.broadcast_to(np.asarray(nbytes, np.int64), (n,)).copy(),
        lane=idx.astype(np.int32), doorbell=idx,
        dep=np.full(n, -1, np.int64), dep2=np.full(n, -1, np.int64),
        at=arrival_s, n_lanes=n)


def simulate_station(arrival_s, nbytes, net: NetConfig | None = None, *,
                     n_ms: int = 1, onchip: bool = True,
                     chunk: int | None = None,
                     engine: str = "wavefront",
                     recorder=None) -> dict:
    """Replay one admission queue against the event simulator.

    ``arrival_s`` must be sorted (an arrival stream); ``nbytes`` is the
    per-op payload (scalar or array) that sets the service time.  With
    ``chunk``, the stream is dispatched in host-side waves of that many
    ops against a carried :class:`ServerClock` — completion ticks are
    identical to the one-shot replay (the chunking-invariance property).

    Returns per-op arrays: ``wait_s`` (queueing delay at the NIC/atomic
    units), ``service_s`` (grid-rounded service time actually charged),
    ``comp_s`` (absolute completion) and ``sojourn_s`` (completion minus
    arrival = wait + service + RTT).
    """
    net = net or NetConfig()
    arrival_s = np.asarray(arrival_s, np.float64)
    n = arrival_s.size
    nbytes = np.broadcast_to(np.asarray(nbytes, np.int64), (n,))
    sim_f = netsim.simulate if engine == "wavefront" else netsim.simulate_ref
    step = n if chunk is None else max(int(chunk), 1)
    # the recorder rides the carried clock, so every chunked wave
    # captures onto one absolute recorded timeline (repro_torch.obs)
    clock = ServerClock.fresh(n_ms)
    clock.recorder = recorder
    waits = np.zeros(n)
    comps = np.zeros(n)
    for lo in range(0, n, step):
        sl = slice(lo, min(lo + step, n))
        tr = station_trace(arrival_s[sl], nbytes[sl], n_ms=n_ms, start=lo)
        sim = sim_f(tr, net, n_ms, onchip, clock=clock)
        waits[sl] = sim["lane_queue_s"]
        comps[sl] = sim["latency_s"]
    svc = np.rint(np.maximum(1.0 / net.nic_iops_small,
                             nbytes / net.nic_bw_Bps) * PS_PER_S) / PS_PER_S
    return dict(wait_s=waits, comp_s=comps, service_s=svc,
                sojourn_s=comps - arrival_s,
                rtt_s=round(net.rtt_s * PS_PER_S) / PS_PER_S)


# --------------------------------------------------------------------------
# cluster op materialization (closed-loop RNG order, replayed up front)
# --------------------------------------------------------------------------

def materialize_ops(spec: WorkloadSpec, streams, n_cs: int, per_cs: int,
                    rounds: int):
    """Pre-draw every op exactly as ``run_cluster`` would.

    The closed-loop scheduler interleaves RNG consumption with
    execution; open-loop admission reorders *execution*, so the draws
    are materialized up front in the scheduler's exact consumption order
    — per round, per kind in :data:`KIND_ORDER`, keys for every CS then
    values for every CS — giving identical per-CS key/value sequences
    and identical shared live-record growth.  ``rmw`` write values are
    *not* drawn (they come from the op's own lookup at execution time,
    as in the closed loop).

    Returns per-CS struct-of-arrays ``(kinds, keys, vals)``: kind codes
    (:data:`KIND_CODE`), int64 keys, int64 values (-1 where derived at
    execution or not applicable).
    """
    kinds = [[] for _ in range(n_cs)]
    keys = [[] for _ in range(n_cs)]
    vals = [[] for _ in range(n_cs)]
    for r in range(rounds):
        counts = [spec.batch_counts(per_cs, salt=r * n_cs + cs)
                  for cs in range(n_cs)]
        for kind in KIND_ORDER:
            if not any(c[kind] for c in counts):
                continue
            draw = streams.draw_insert if kind == "insert" else streams.draw
            ks = [draw(cs, counts[cs][kind]) if counts[cs][kind] else None
                  for cs in range(n_cs)]
            if kind in ("update", "insert"):
                vs = [streams.rngs[cs].integers(0, VAL_MASK, k.size)
                      if k is not None else None
                      for cs, k in enumerate(ks)]
            else:
                vs = [None] * n_cs
            code = KIND_CODE[kind]
            for cs in range(n_cs):
                if ks[cs] is None:
                    continue
                k = np.asarray(ks[cs], np.int64)
                kinds[cs].append(np.full(k.size, code, np.int8))
                keys[cs].append(k)
                vals[cs].append(np.asarray(vs[cs], np.int64)
                                if vs[cs] is not None
                                else np.full(k.size, -1, np.int64))
    cat = lambda ls, dt: (np.concatenate(ls) if ls else np.zeros(0, dt))
    return ([cat(kinds[cs], np.int8) for cs in range(n_cs)],
            [cat(keys[cs], np.int64) for cs in range(n_cs)],
            [cat(vals[cs], np.int64) for cs in range(n_cs)])


# --------------------------------------------------------------------------
# the cluster serving loop
# --------------------------------------------------------------------------

def _execute_wave(cluster, spec, kinds, keys, vals, arr_cs, take) -> None:
    """Dispatch one admitted wave through the cluster's kind waves, in
    the scheduler's fixed kind order, with per-op arrival release
    gates."""
    n_cs = cluster.n_cs
    for kind in KIND_ORDER:
        code = KIND_CODE[kind]
        kby = [None] * n_cs
        vby = [None] * n_cs
        aby = [None] * n_cs
        any_ops = False
        for cs, (lo, hi) in enumerate(take):
            if hi <= lo:
                continue
            m = kinds[cs][lo:hi] == code
            if not m.any():
                continue
            any_ops = True
            kby[cs] = keys[cs][lo:hi][m].astype(np.int32)
            vby[cs] = vals[cs][lo:hi][m].astype(np.int32)
            aby[cs] = arr_cs[cs][lo:hi][m]
        if not any_ops:
            continue
        if kind == "scan":
            cluster.scan_wave(kby, count=spec.scan_len,
                              max_leaves=max(4, spec.scan_len),
                              arrivals_by_cs=aby)
        elif kind == "read":
            cluster.lookup_wave(kby, arrivals_by_cs=aby)
        elif kind == "rmw":
            got = cluster.lookup_wave(kby, arrivals_by_cs=aby)
            wvals = [((g.astype(np.int64) + 1) & VAL_MASK)
                     if k is not None else None
                     for k, (g, _) in zip(kby, got)]
            # the op's write is released by its own lookup's completion
            rel = [cluster.last_read_comp.get(cs) if kby[cs] is not None
                   else None for cs in range(n_cs)] \
                if cluster.clock is not None else aby
            cluster.write_wave(kby, wvals, arrivals_by_cs=rel)
        elif kind == "update":
            cluster.write_wave(kby, vby, arrivals_by_cs=aby)
        elif kind == "delete":
            cluster.write_wave(kby, None, is_delete=True,
                               arrivals_by_cs=aby)
        elif kind == "insert":
            cluster.write_wave(kby, vby, arrivals_by_cs=aby)


def run_open_loop(cluster, spec: WorkloadSpec, *, seed: int = 1,
                  keyspace: int = 1 << 20, partitioned: bool = False,
                  batch_fill: float = 0.5):
    """Drive ``spec`` through the cluster with explicit arrival times.

    Ops are materialized in the closed-loop scheduler's RNG order, given
    timestamps by ``spec.arrival`` at ``spec.offered_mops``, and thinned
    round-robin into per-CS FIFO admission queues.  The loop repeatedly
    admits up to ``per_cs`` ops per CS whose arrival is below the wave's
    formation time, dispatches them through the bucketed kind waves
    (arrivals as release gates, carried :class:`ServerClock` timeline),
    and advances to ``max(now, wave horizon)``.  With every arrival at
    t=0 this degenerates to exactly the closed-loop rounds (the
    differential test).

    Returns ``(done, op_counts, info)`` — ``info`` carries the wave
    count, absolute horizon, and last-arrival time (the offered-load
    denominator).
    """
    from repro_torch.cluster.streams import ClusterStreams
    n_cs, per_cs = cluster.n_cs, cluster.per_cs
    opr = n_cs * per_cs
    rounds = max(1, -(-spec.ops // opr))
    n_ops = rounds * opr
    streams = ClusterStreams(spec, n_cs, keyspace=keyspace,
                             partitioned=partitioned, seed=seed)
    kinds, keys, vals = materialize_ops(spec, streams, n_cs, per_cs, rounds)
    rate = spec.offered_mops * 1e6
    arr_ps = make_arrivals(spec.arrival, max(rate, 1.0), n_ops,
                           seed=seed + 7919,
                           burst_factor=spec.burst_factor,
                           burst_frac=spec.burst_frac,
                           diurnal_period_s=spec.diurnal_period_s,
                           diurnal_peak=spec.diurnal_peak)
    # round-robin thinning: op g -> CS g % n_cs keeps every per-CS queue
    # sorted and a Poisson stream Poisson at rate/n_cs
    arr_cs = [arr_ps[cs::n_cs] / PS_PER_S for cs in range(n_cs)]

    cluster.enable_open_loop()
    qpos = np.zeros(n_cs, np.int64)
    total = rounds * per_cs
    # host batching window: dispatch when a full per-CS batch is queued
    # or the window expires — granularity only, timing-neutral (see
    # module docstring)
    window = 0.0 if spec.arrival == "closed" or rate <= 0 \
        else batch_fill * opr / rate
    now = 0.0
    waves = 0
    while (qpos < total).any():
        heads = [arr_cs[cs][qpos[cs]] if qpos[cs] < total else np.inf
                 for cs in range(n_cs)]
        horizon = max(now, min(heads) + window)
        take = []
        for cs in range(n_cs):
            lo = int(qpos[cs])
            hi = lo + int(np.searchsorted(arr_cs[cs][lo:lo + per_cs],
                                          horizon, side="right"))
            take.append((lo, hi))
        if all(hi == lo for lo, hi in take):   # pragma: no cover (guard)
            now = float(min(heads))
            continue
        _execute_wave(cluster, spec, kinds, keys, vals, arr_cs, take)
        for cs, (lo, hi) in enumerate(take):
            qpos[cs] = hi
        cluster.end_round()
        now = max(now, cluster.counters["sim_time_s"])
        waves += 1

    op_counts = {k: 0 for k in OP_KINDS}
    for cs in range(n_cs):
        for kind in KIND_ORDER:
            op_counts[kind] += int((kinds[cs] == KIND_CODE[kind]).sum())
    info = dict(waves=waves,
                horizon_s=float(cluster.counters["sim_time_s"]),
                last_arrival_s=float(arr_ps[-1]) / PS_PER_S if n_ops else 0.0,
                offered_ops_s=rate)
    return n_ops, {k: v for k, v in op_counts.items() if v}, info
