"""netsim — a discrete-event RDMA simulator over verb traces.

The container has no RDMA fabric, so — exactly like the paper explains its
own numbers in §5.5 — performance is *derived* from the functional plane.
The functional plane emits a structured **verb trace**
(:mod:`repro_torch.core.verbs` — one record per READ/WRITE/CAS a real CS would
post, with target MS, payload, doorbell grouping and dependency links),
and this module replays that trace against per-MS resources.  Per-op
latency, tail percentiles and phase makespan *fall out of the replay*
instead of closed-form formulas.

Two equivalent replay engines share one integer time grid (picoseconds,
so event ordering is exact and deterministic — no float tie-breaking):

* :func:`simulate` — the production engine: a vectorized
  structure-of-arrays replay (topological wavefront over ``dep``/``dep2``
  with a conservative time horizon, per-MS lexsort + cumulative-max
  service times).  Interpreter cost scales with the number of *waves*,
  not the number of verbs, so paper-scale traces replay in milliseconds.
* :func:`simulate_ref` — the original per-verb heapq event loop, kept as
  the executable specification.  ``simulate`` is exactly equivalent
  (same int64 completion times; asserted by tests/test_throughput.py on
  real SHERMAN/FG+/merged-cluster traces).

Resources (paper sources):

  * RTT ≈ 2 µs for small one-sided verbs at 100 Gbps (§2.2);
  * per-MS **NIC message unit**: >50 Mops for IO ≤ 128 B, bandwidth-bound
    above (Fig. 3) — every verb occupies it FIFO;
  * per-MS **atomic unit**: CAS additionally serialize here — NIC on-chip
    ≈ 110 Mops (§4.3) vs. ~2 PCIe transactions ≈ 0.9 µs for host-memory
    atomics (§3.2.2, Fig. 2).  The quadratic spin-CAS load of a hot lock
    clogging the PCIe-cost atomic unit *is* the Fig. 2 collapse.

Sherman's feature toggles carry **no closed-form constants here**; they are

  * ``combine``      → :func:`repro_torch.core.verbs.combine_doorbells`
  * ``hierarchical`` → :func:`repro_torch.core.verbs.hierarchical_locks`
  * ``twolevel``     → :func:`repro_torch.core.verbs.twolevel_writes`
  * ``onchip``       → the atomic-unit service-time *resource parameter*.

Event-loop semantics, the verb taxonomy, and the wavefront algorithm's
exactness argument are documented in docs/DESIGN.md §10.
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from repro_torch.core import verbs as V

#: Integer time grid: one tick = 1 ps.  All service times, RTTs and
#: ``at`` floors are rounded onto the grid once, so both replay engines
#: do exact int64 arithmetic and make identical ordering decisions.
PS_PER_S = 1e12


@dataclasses.dataclass(frozen=True)
class Features:
    """Sherman's technique toggles — the Fig. 10/11 ablation axis."""
    combine: bool = True       # command combination (§4.5)
    onchip: bool = True        # GLT in NIC on-chip memory (§4.3)
    hierarchical: bool = True  # LLT + wait queues + handover (§4.3)
    twolevel: bool = True      # two-level versions, unsorted leaves (§4.4)

    def label(self) -> str:
        steps = [("C", self.combine), ("O", self.onchip),
                 ("H", self.hierarchical), ("V", self.twolevel)]
        return "".join(s for s, on in steps if on) or "FG+"


FG_PLUS = Features(False, False, False, False)
SHERMAN = Features(True, True, True, True)
ABLATION_LADDER = [
    ("FG+", FG_PLUS),
    ("+Combine", Features(True, False, False, False)),
    ("+On-Chip", Features(True, True, False, False)),
    ("+Hierarchical", Features(True, True, True, False)),
    ("+2-Level Ver", SHERMAN),
]


@dataclasses.dataclass(frozen=True)
class NetConfig:
    rtt_s: float = 2e-6              # one-sided verb round trip
    nic_bw_Bps: float = 12.5e9       # 100 Gbps
    nic_iops_small: float = 50e6     # ≤128 B messages (Fig. 3)
    small_io_bytes: int = 128
    cas_onchip_s: float = 1 / 110e6  # service time per on-chip CAS
    cas_pcie_s: float = 0.9e-6       # two PCIe transactions (host CAS)
    handover_max: int = 4


@dataclasses.dataclass
class ServerClock:
    """Carried per-MS busy frontiers (int64 ps) — the open-loop serving
    plane's absolute shared timeline.

    Closed-loop phase pricing starts every MS idle at t=0: each phase is
    its own relative timeline and makespans are summed.  Passing a clock
    to :func:`simulate` / :func:`simulate_ref` instead seeds the NIC
    message unit and atomic unit from the carried busy times and writes
    the advanced frontiers back, so successive waves replay on ONE
    absolute timeline: an op whose ``at`` release gate says it arrived at
    absolute time *t* queues behind everything the servers already
    accepted.  Host-side wave chunking then has no timing effect —
    replaying a trace in one call or split across many calls with the
    carried clock yields identical completion ticks
    (tests/test_serve_queueing.py pins this invariance).
    """

    nic_free_ps: np.ndarray
    atomic_free_ps: np.ndarray
    #: Optional observability-plane recorder (repro.obs) carried with the
    #: clock across open-loop waves; replays on this clock capture into
    #: it unless the caller passes an explicit recorder.
    recorder: object | None = None

    @classmethod
    def fresh(cls, n_ms: int) -> "ServerClock":
        return cls(np.zeros(n_ms, np.int64), np.zeros(n_ms, np.int64))

    @property
    def now_s(self) -> float:
        """Latest server busy frontier, in seconds."""
        hi = max(int(self.nic_free_ps.max(initial=0)),
                 int(self.atomic_free_ps.max(initial=0)))
        return hi / PS_PER_S

    def reset_ms(self, ms: int, restart_s: float) -> None:
        """Crash/restart of memory server ``ms``: its NIC message unit
        and atomic unit come back *empty* at ``restart_s``.

        A crash destroys the on-NIC queue — whatever backlog the dead
        server had accepted is gone, not carried.  Without this reset a
        restarted MS would keep its pre-crash busy frontier and verbs
        released after the restart would queue behind phantom work
        (tests/test_netsim_trace.py pins the single-verb latency).  The
        frontier is set to the restart tick itself: the server cannot
        serve before it is back, and it owes nothing from before.
        """
        t = np.int64(round(float(restart_s) * PS_PER_S))
        self.nic_free_ps[ms] = t
        self.atomic_free_ps[ms] = t


# --------------------------------------------------------------------------
# shared grid + result assembly
# --------------------------------------------------------------------------

def _grid_times(trace: V.VerbTrace, net: NetConfig, onchip: bool):
    """Round one trace's timing constants onto the shared ps grid."""
    svc = np.rint(np.maximum(1.0 / net.nic_iops_small,
                             trace.nbytes / net.nic_bw_Bps) * PS_PER_S)
    cas = (net.cas_onchip_s if onchip else net.cas_pcie_s) * PS_PER_S
    return (svc.astype(np.int64), int(round(cas)),
            int(round(net.rtt_s * PS_PER_S)),
            np.rint(np.asarray(trace.at) * PS_PER_S).astype(np.int64))


def _empty_sim(n_lanes: int) -> dict:
    return dict(latency_s=np.zeros(n_lanes), makespan_s=0.0,
                lane_doorbells=np.zeros(n_lanes, np.int64),
                write_bytes=np.zeros(n_lanes),
                lane_queue_s=np.zeros(n_lanes),
                verb_start_s=np.zeros(0),
                msgs=0, verbs=0, bytes=0.0, cas_msgs=0, doorbells=0)


def _finish_sim(trace: V.VerbTrace, comp_ps: np.ndarray,
                wait_ps: np.ndarray, start_ps: np.ndarray) -> dict:
    """Fold per-verb completion ticks into the phase's reported totals.

    ``lane_doorbells`` is the per-lane doorbell-ring count
    (``VerbTrace.per_lane_doorbells`` in :mod:`repro_torch.core.verbs`) — the
    sequential posting-depth metric; for read phases every READ is its
    own ring, so there it equals the lane's remote reads.

    ``lane_queue_s`` is the lane's total **queueing delay**: per-verb
    wait for the NIC message unit plus (for CAS) the atomic unit, summed
    over the lane's verbs.  Waiting on a dependency (``dep``/``dep2``)
    or an ``at`` release gate is not queueing — the verb is not yet
    posted.  ``verb_start_s`` is each verb's NIC service start, so
    release-gate invariants (no verb starts before its op arrived) are
    checkable per verb.
    """
    comp = comp_ps * (1.0 / PS_PER_S)
    lat = np.zeros(trace.n_lanes)
    lm = trace.lane >= 0
    np.maximum.at(lat, trace.lane[lm], comp[lm])
    queue = np.zeros(trace.n_lanes)
    np.add.at(queue, trace.lane[lm], wait_ps[lm] * (1.0 / PS_PER_S))
    return dict(latency_s=lat, makespan_s=float(comp.max()),
                lane_doorbells=trace.per_lane_doorbells(),
                write_bytes=trace.per_lane_write_bytes(),
                lane_queue_s=queue,
                verb_start_s=start_ps * (1.0 / PS_PER_S),
                msgs=trace.n_verbs, verbs=trace.n_verbs,
                bytes=trace.total_bytes,
                cas_msgs=trace.n_cas, doorbells=trace.n_doorbells)


# --------------------------------------------------------------------------
# the reference event loop (executable specification)
# --------------------------------------------------------------------------

def _resolve_recorder(recorder, clock):
    """The replay's capture target: an explicit recorder wins, else the
    one carried by the ServerClock (open-loop waves), else none."""
    if recorder is not None:
        return recorder
    return clock.recorder if clock is not None else None


def simulate_ref(trace: V.VerbTrace, net: NetConfig, n_ms: int,
                 onchip: bool, clock: ServerClock | None = None,
                 recorder=None) -> dict:
    """Per-verb heapq replay — the specification :func:`simulate` must
    match tick-for-tick.

    Every verb is posted when its gates (``dep``/``dep2`` completions and
    its ``at`` floor) allow, occupies the target MS's NIC message unit
    FIFO (``max(1/iops, bytes/bw)``), CAS additionally serialize on the
    MS's atomic unit, and the client observes completion one RTT after
    service.  Verbs sharing a doorbell inherit the head's gates (set by
    the combine transformation), so they post together and per-MS FIFO
    order keeps in-order delivery.

    With a :class:`ServerClock` the busy frontiers seed from (and write
    back to) the carried per-MS state — the open-loop absolute timeline.
    ``recorder`` (or one carried by the clock) captures the replay's
    per-verb timing after the fact — a pure observation, so recorded
    and unrecorded runs are bit-identical (repro.obs.recorder).
    """
    n = trace.n_verbs
    if n == 0:
        return _empty_sim(trace.n_lanes)
    rec = _resolve_recorder(recorder, clock)
    svc_a, cas_s, rtt, at_a = _grid_times(trace, net, onchip)
    svc = svc_a.tolist()
    kind = trace.kind.tolist()
    ms = trace.ms.tolist()
    at = at_a.tolist()
    dep = trace.dep.tolist()
    dep2 = trace.dep2.tolist()

    npend = ((trace.dep >= 0).astype(np.int8)
             + (trace.dep2 >= 0).astype(np.int8))
    children: list[list[int]] = [[] for _ in range(n)]
    for col in (trace.dep, trace.dep2):
        for i in np.nonzero(col >= 0)[0].tolist():
            children[col[i]].append(i)
    npend = npend.tolist()

    heap = [(at[i], i) for i in np.nonzero(
        (trace.dep < 0) & (trace.dep2 < 0))[0].tolist()]
    heapq.heapify(heap)
    nic_free = ([0] * n_ms if clock is None
                else clock.nic_free_ps.tolist())
    atomic_free = ([0] * n_ms if clock is None
                   else clock.atomic_free_ps.tolist())
    comp = [0] * n
    wait = [0] * n
    start = [0] * n
    push, pop = heapq.heappush, heapq.heappop
    while heap:
        t, i = pop(heap)
        m = ms[i]
        s = t if t > nic_free[m] else nic_free[m]
        start[i] = s
        w = s - t
        d = s + svc[i]
        nic_free[m] = d
        if kind[i] == V.CAS:
            a = d if d > atomic_free[m] else atomic_free[m]
            w += a - d
            d = a + cas_s
            atomic_free[m] = d
        d += rtt
        comp[i] = d
        wait[i] = w
        for c in children[i]:
            npend[c] -= 1
            if not npend[c]:
                r = at[c]
                j = dep[c]
                if j >= 0 and comp[j] > r:
                    r = comp[j]
                j = dep2[c]
                if j >= 0 and comp[j] > r:
                    r = comp[j]
                push(heap, (r, c))
    if clock is not None:
        clock.nic_free_ps[:] = nic_free
        clock.atomic_free_ps[:] = atomic_free
    comp_a = np.asarray(comp, np.int64)
    wait_a = np.asarray(wait, np.int64)
    start_a = np.asarray(start, np.int64)
    if rec is not None:
        rec.capture(trace, net, onchip, comp_a, wait_a, start_a,
                    clocked=clock is not None)
    return _finish_sim(trace, comp_a, wait_a, start_a)


# --------------------------------------------------------------------------
# the vectorized wavefront replay (the production engine)
# --------------------------------------------------------------------------

def simulate(trace: V.VerbTrace, net: NetConfig, n_ms: int,
             onchip: bool, clock: ServerClock | None = None,
             recorder=None) -> dict:
    """Vectorized structure-of-arrays replay, exactly equivalent to
    :func:`simulate_ref`.

    Instead of popping one verb at a time, each **wave** batch-services
    every dependency-released verb whose ready time lies below a
    conservative horizon ``T = min(ready) + min(svc) + rtt``: any verb
    still gated by an unfinished dependency completes no earlier than
    ``ready + svc + rtt`` of some released verb, so nothing outside the
    wave can undercut it in its MS's FIFO (DESIGN.md §10 has the full
    argument).  The wave is serviced per MS with a lexsort +
    cumulative-max prefix recurrence (the closed form of the sequential
    ``d_j = max(ready_j, d_{j-1}) + svc_j`` FIFO recursion, seeded with
    the MS's carried busy time), CAS verbs pass through the same
    recurrence again on the atomic unit, and completions release the
    verbs gated on them.  All arithmetic is int64 ticks on the shared
    grid, so ordering ties resolve identically to the reference loop.

    With a :class:`ServerClock` the carried busy frontiers seed the
    recurrences and are written back afterwards (the open-loop absolute
    timeline).  The horizon argument is unaffected: a carried frontier
    only delays service starts, and per-MS FIFO order is decided by
    ready times, which the frontier does not touch.  ``recorder`` — see
    :func:`simulate_ref`; the capture runs after the replay's last
    ordering decision, so it cannot perturb the result.
    """
    n = trace.n_verbs
    if n == 0:
        return _empty_sim(trace.n_lanes)
    rec = _resolve_recorder(recorder, clock)
    svc, cas_ps, rtt_ps, at = _grid_times(trace, net, onchip)
    ms = trace.ms.astype(np.int64)
    kind = trace.kind
    dep, dep2 = trace.dep, trace.dep2
    has1, has2 = dep >= 0, dep2 >= 0
    # child adjacency in CSR form (one edge per dep/dep2 gate)
    par = np.concatenate([dep[has1], dep2[has2]])
    chd = np.concatenate([np.flatnonzero(has1), np.flatnonzero(has2)])
    o = np.argsort(par, kind="stable")
    par_s, chd_s = par[o], chd[o]
    coff = np.searchsorted(par_s, np.arange(n + 1))
    npend = has1.astype(np.int32) + has2.astype(np.int32)
    d1 = np.where(has1, dep, 0)
    d2 = np.where(has2, dep2, 0)

    comp = np.zeros(n, np.int64)
    wait = np.zeros(n, np.int64)
    start = np.zeros(n, np.int64)
    nic_free = (np.zeros(n_ms, np.int64) if clock is None
                else clock.nic_free_ps.copy())
    atomic_free = (np.zeros(n_ms, np.int64) if clock is None
                   else clock.atomic_free_ps.copy())
    look = int(svc.min()) + rtt_ps       # conservative horizon increment

    # static frontier: verbs with no gates, consumed as a sorted cursor
    root = np.flatnonzero(npend == 0)
    ro = np.lexsort((root, at[root]))
    root = root[ro]
    root_at = at[root]
    rp = 0
    dyn_i = np.zeros(0, np.int64)        # dependency-released pool
    dyn_r = np.zeros(0, np.int64)
    done = 0
    while done < n:
        if rp < root.size:
            tstar = int(root_at[rp])
            if dyn_r.size:
                dmin = int(dyn_r.min())
                if dmin < tstar:
                    tstar = dmin
        elif dyn_r.size:
            tstar = int(dyn_r.min())
        else:                            # pool empty => dependency cycle
            raise ValueError("verb trace contains a dependency cycle")
        T = tstar + look
        np_ = rp + int(np.searchsorted(root_at[rp:], T, side="left"))
        S = root[rp:np_]
        R = root_at[rp:np_]
        rp = np_
        if dyn_i.size:
            m_ = dyn_r < T
            S = np.concatenate([S, dyn_i[m_]])
            R = np.concatenate([R, dyn_r[m_]])
            dyn_i, dyn_r = dyn_i[~m_], dyn_r[~m_]
        # FIFO-service the wave per MS: (ms, ready, idx) order matches the
        # reference heap's pop order exactly (ticks are exact ints)
        o2 = np.lexsort((S, R, ms[S]))
        S, R = S[o2], R[o2]
        msS = ms[S]
        starts = np.flatnonzero(
            np.concatenate([[True], msS[1:] != msS[:-1]]))
        bounds = np.append(starts, S.size)
        svcS = svc[S]
        c = np.cumsum(svcS)
        base = R - (c - svcS)
        d = np.empty(S.size, np.int64)
        for a, b in zip(bounds[:-1], bounds[1:]):
            m0 = msS[a]
            hi = np.maximum.accumulate(
                np.maximum(base[a:b], nic_free[m0] - (c[a] - svcS[a])))
            d[a:b] = c[a:b] + hi
            nic_free[m0] = d[b - 1]
        startS = d - svcS                 # NIC service start per verb
        waitS = startS - R               # NIC message-unit queueing
        cm = kind[S] == V.CAS
        if cm.any():
            cpos = np.flatnonzero(cm)
            d_nic = d[cpos].copy()       # NIC completion before atomic pass
            ca = cas_ps * np.arange(1, cpos.size + 1, dtype=np.int64)
            base2 = d[cpos] - (ca - cas_ps)
            seg_of = np.searchsorted(starts, cpos, side="right")
            cb = np.flatnonzero(
                np.concatenate([[True], seg_of[1:] != seg_of[:-1]]))
            cbounds = np.append(cb, cpos.size)
            for a, b in zip(cbounds[:-1], cbounds[1:]):
                m0 = msS[cpos[a]]
                hi = np.maximum.accumulate(
                    np.maximum(base2[a:b],
                               atomic_free[m0] - (ca[a] - cas_ps)))
                d[cpos[a:b]] = ca[a:b] + hi
                atomic_free[m0] = d[cpos[b - 1]]
            waitS[cpos] += (d[cpos] - cas_ps) - d_nic   # atomic-unit wait
        comp[S] = d + rtt_ps
        wait[S] = waitS
        start[S] = startS
        done += S.size
        # release the verbs gated on this wave's completions
        a_, b_ = coff[S], coff[S + 1]
        cnt = b_ - a_
        tot = int(cnt.sum())
        if tot:
            off_ = np.arange(tot) - np.repeat(np.cumsum(cnt) - cnt, cnt)
            kids = chd_s[np.repeat(a_, cnt) + off_]
            np.subtract.at(npend, kids, 1)
            nk = np.unique(kids[npend[kids] == 0])
            if nk.size:
                r_ = np.maximum(at[nk], np.maximum(
                    np.where(has1[nk], comp[d1[nk]], 0),
                    np.where(has2[nk], comp[d2[nk]], 0)))
                dyn_i = np.concatenate([dyn_i, nk])
                dyn_r = np.concatenate([dyn_r, r_])
    if clock is not None:
        clock.nic_free_ps[:] = nic_free
        clock.atomic_free_ps[:] = atomic_free
    if rec is not None:
        rec.capture(trace, net, onchip, comp, wait, start,
                    clocked=clock is not None)
    return _finish_sim(trace, comp, wait, start)


def transformed_write_trace(stats: dict, feat: Features, net: NetConfig,
                            cfg) -> V.VerbTrace:
    """Canonical write trace + the feature transformations, in order
    (lock-stream rewrite reassembles, so it runs first)."""
    tr = V.write_phase_trace(stats, cfg, net.rtt_s)
    if tr.n_verbs == 0:
        return tr
    if feat.hierarchical:
        tr = V.hierarchical_locks(tr)
    if feat.twolevel:
        tr = V.twolevel_writes(tr)
    if feat.combine:
        tr = V.combine_doorbells(tr)
    return tr


# --------------------------------------------------------------------------
# phase pricing (the api.py entry points)
# --------------------------------------------------------------------------

def price_write_phase(stats: dict, feat: Features, net: NetConfig, cfg,
                      recorder=None):
    """Price one write phase by verb-trace replay.

    ``stats`` holds numpy views of WriteStats (see
    :func:`repro_torch.core.api.write_stats_dict`); ``cfg`` is the TreeConfig
    (MS layout + wire sizes).  Returns the per-op latency array, phase
    makespan, throughput, and trace totals (verbs, doorbells, bytes,
    CAS), matching the paper's §5.5 reporting.
    """
    tr = transformed_write_trace(stats, feat, net, cfg)
    sim = simulate(tr, net, cfg.n_ms, feat.onchip, recorder=recorder)
    n = tr.n_lanes
    sim["mops"] = n / sim["makespan_s"] / 1e6 if sim["makespan_s"] else 0.0
    return sim


def read_trace_from_stats(stats: dict, cfg) -> V.VerbTrace:
    """Build a lookup/scan phase's READ-chain trace from its stats dict.

    When the caller measured the reads directly (the functional index
    cache reports per-lane ``remote_reads``), that count is replayed
    as-is; otherwise it derives from ``cache_hit``/``height``.  Version
    ``retries`` (e.g. extra leaves of a scan) extend the chain and are
    clamped at zero — an empty scan still pays its initial descent.
    Shared by :func:`price_read_phase` and the cluster plane's per-CS
    trace collection (:mod:`repro.cluster.sched`).
    """
    act = np.asarray(stats["active"], bool)
    n = int(act.sum())
    if n == 0:
        return V._empty_trace()
    retries = np.maximum(np.asarray(stats["retries"])[act], 0) \
        if "retries" in stats else np.zeros(n, np.int64)
    if "remote_reads" in stats:
        reads = np.asarray(stats["remote_reads"])[act] + retries
    else:
        cache_hit = np.asarray(stats["cache_hit"], bool)[act]
        reads = np.where(cache_hit, 1, max(int(stats["height"]), 1)) \
            + retries
    if "leaf" in stats:
        leaf_ms = cfg.ms_of(np.asarray(stats["leaf"])[act].astype(np.int64))
    else:
        leaf_ms = np.arange(n, dtype=np.int64) % cfg.n_ms
    return V.read_phase_trace(reads, leaf_ms, cfg.n_ms, cfg.node_bytes,
                              scan=bool(stats.get("scan", False)))


def price_read_phase(stats: dict, feat: Features, net: NetConfig, cfg,
                     recorder=None):
    """Price a lookup/scan phase: sequential READ chains per lane
    (see :func:`read_trace_from_stats` for the trace semantics)."""
    n = int(np.asarray(stats["active"], bool).sum())
    if n == 0:
        return dict(_empty_sim(0), mops=0.0)
    tr = read_trace_from_stats(stats, cfg)
    sim = simulate(tr, net, cfg.n_ms, feat.onchip, recorder=recorder)
    sim["mops"] = n / sim["makespan_s"] / 1e6 if sim["makespan_s"] else 0.0
    return sim


def price_merged_phase(traces: list[V.VerbTrace], feat: Features,
                       net: NetConfig, cfg,
                       clock: ServerClock | None = None,
                       recorder=None):
    """Price one cluster wave: merge per-CS traces into one timeline and
    replay it against the *shared* per-MS resources.

    Returns ``(sim, merged)``: the usual :func:`simulate` totals (per
    merged lane latency, makespan, verb/byte/doorbell counts) plus the
    merged trace itself so the caller can attribute lanes back to their
    source CS via ``merged.meta['lane_cs']``.  Cross-CS GLT serialization
    and NIC/atomic-unit queueing are emergent — see
    :func:`repro_torch.core.verbs.merge_traces`.  ``clock`` (open-loop serving
    plane) replays the wave on the carried absolute timeline instead of
    a fresh one.
    """
    merged = V.merge_traces(traces)
    sim = simulate(merged, net, cfg.n_ms, feat.onchip, clock=clock,
                   recorder=recorder)
    return sim, merged


def price_maintenance(node_reads: int, small_reads: int, feat: Features,
                      net: NetConfig, cfg, rows_ms=None, recorder=None):
    """Price the CS cache's background traffic (image fills + version
    sweeps) by replaying its MAINT/SYNC read verbs."""
    tr = V.maintenance_trace(node_reads, small_reads, cfg.n_ms,
                             cfg.node_bytes, net.small_io_bytes,
                             rows_ms=rows_ms)
    return simulate(tr, net, cfg.n_ms, feat.onchip, recorder=recorder)


# The closed-form counter pricing that used to live here (per-feature RTT
# constants such as ``write_rtts = 1 if feat.combine else 2``) was replaced
# by the verb-trace plane above; the byte-counting ``IndexCacheSim`` stub
# before it lives on as the functional cache in :mod:`repro_torch.core.cache`.
