"""RDMA verb traces: the structured interface between the two planes.

The functional plane (write path, read path, CS cache) reports *per-lane
structural arrays* for each phase — target leaf, conflict-group ranks,
split outputs, remote-read counts.  This module turns them into a
:class:`VerbTrace`: one record per RDMA verb a real CS would post, with

* ``kind``     — READ / WRITE / CAS (the one-sided verb),
* ``role``     — what the verb is for (taxonomy below),
* ``ms``       — target memory server,
* ``nbytes``   — payload bytes on the wire,
* ``lane``     — issuing client lane (-1 for background traffic),
* ``doorbell`` — posting group: verbs sharing an id ride one doorbell ring,
* ``dep``/``dep2`` — verbs whose *completion* gates this verb's posting,
* ``at``       — earliest client-side post time (used to stagger spin CAS),
* ``obj``      — target object of lock-plane verbs (the GLT entry's node
  row), so :func:`merge_traces` can serialize cross-CS lock conflicts.

``netsim.simulate`` replays a trace against per-MS resources; nothing in
the trace is priced here.

Verb taxonomy (docs/DESIGN.md §10):

==========  ====  ==========================================================
role        kind  meaning
==========  ====  ==========================================================
TRAVERSE    READ  node fetch on the descent to the leaf (sequential chain —
                  address-dependent, so never combinable, paper §4.5)
LOCK        CAS   remote lock acquisition on the leaf's MS
WRITEBACK   WRITE the op's data write-back to the leaf
SIBLING     WRITE new-sibling image write of a split
PARENT      WRITE separator insertion into the parent (B-link: may complete
                  after the unlock — the half-split/repair-queue semantics)
UNLOCK      WRITE lock release (small write to the GLT)
SPIN        CAS   failed lock attempt of a spinning waiter (no hierarchy)
MAINT       READ  whole-node read refilling the CS index-cache image
SYNC        READ  small version read of a cache coherence sweep
==========  ====  ==========================================================

Feature toggles are *trace transformations* over the canonical stream
(which is the FG+ discipline: every lane CASes, spins while waiting, and
releases remotely; whole-node write-backs; one doorbell per verb):

* :func:`hierarchical_locks`  — HOCL (§4.3): only handover-cycle heads
  issue the LOCK CAS, only chain ends issue the UNLOCK, spinning
  disappears; waiters are gated on their queue predecessor instead.
* :func:`twolevel_writes`     — two-level versions (§4.4): non-split
  write-backs shrink to ``entry_bytes``.
* :func:`combine_doorbells`   — command combination (§4.5): the UNLOCK
  (and, for a same-MS sibling, the SIBLING write — the three-way split
  combination) joins the WRITEBACK's doorbell: posted together, ordered
  by in-order delivery, no extra round trip.

``onchip`` is not a transformation — it is a resource parameter of the
event loop (atomic-unit service time).
"""
from __future__ import annotations

import dataclasses

import numpy as np

READ, WRITE, CAS = 0, 1, 2
(TRAVERSE, LOCK, WRITEBACK, SIBLING, PARENT, UNLOCK, SPIN, MAINT,
 SYNC) = range(9)

ROLE_NAMES = ("traverse", "lock", "writeback", "sibling", "parent",
              "unlock", "spin", "maint", "sync")

LOCK_BYTES = 16          # lock CAS / release payload (GLT entry + header)


@dataclasses.dataclass
class VerbTrace:
    """One phase's RDMA verb stream (struct-of-arrays, numpy)."""

    kind: np.ndarray       # [V] int8   READ/WRITE/CAS
    role: np.ndarray       # [V] int8   taxonomy above
    ms: np.ndarray         # [V] int32  target memory server
    nbytes: np.ndarray     # [V] int64  wire payload
    lane: np.ndarray       # [V] int32  issuing lane (-1 = background)
    doorbell: np.ndarray   # [V] int64  posting group id (= head verb index)
    dep: np.ndarray        # [V] int64  gating verb index (-1 = none)
    dep2: np.ndarray       # [V] int64  second gate (cross-lane lock chain)
    at: np.ndarray         # [V] float  earliest client post time
    obj: np.ndarray | None = None  # [V] int64 target object (GLT lock row for
    #    lock-plane verbs, -1/None elsewhere) — lets merge_traces serialize
    #    cross-CS lock conflicts on the shared GLT entry
    n_lanes: int = 0
    meta: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def n_verbs(self) -> int:
        return int(self.kind.shape[0])

    @property
    def n_cas(self) -> int:
        return int((self.kind == CAS).sum())

    @property
    def total_bytes(self) -> float:
        return float(self.nbytes.sum())

    @property
    def doorbell_heads(self) -> np.ndarray:
        """Mask of verbs that ring their own doorbell (posting events)."""
        return self.doorbell == np.arange(self.n_verbs)

    @property
    def n_doorbells(self) -> int:
        return int(self.doorbell_heads.sum())

    def per_lane_write_bytes(self) -> np.ndarray:
        """Data-plane bytes written back per lane (WRITEBACK + SIBLING —
        the §5.5.3 'write size' metric; lock-plane writes excluded)."""
        m = ((self.role == WRITEBACK) | (self.role == SIBLING)) & \
            (self.lane >= 0)
        out = np.zeros(self.n_lanes)
        np.add.at(out, self.lane[m], self.nbytes[m].astype(np.float64))
        return out

    def per_lane_doorbells(self, include_spin: bool = False) -> np.ndarray:
        """Doorbell rings per lane — the sequential posting-depth metric
        netsim reports as ``lane_doorbells`` (SPIN load excluded by
        default)."""
        m = self.doorbell_heads & (self.lane >= 0)
        if not include_spin:
            m &= self.role != SPIN
        return np.bincount(self.lane[m], minlength=self.n_lanes)


def _empty_trace(n_lanes: int = 0, meta: dict | None = None) -> VerbTrace:
    z = lambda dt: np.zeros(0, dt)
    return VerbTrace(kind=z(np.int8), role=z(np.int8), ms=z(np.int32),
                     nbytes=z(np.int64), lane=z(np.int32),
                     doorbell=z(np.int64), dep=z(np.int64), dep2=z(np.int64),
                     at=z(np.float64), obj=z(np.int64), n_lanes=n_lanes,
                     meta=meta or {})


def _chain_layout(R: np.ndarray, leaf_ms: np.ndarray, n_ms: int,
                  scan: bool = False):
    """Layout of per-lane sequential READ chains (``R[i]`` reads each).

    Returns ``(lane, ms, dep, last)`` with verb indices local to the
    chain segment (base 0): descents end at the leaf's MS walking
    backward round-robin; scans start there and walk right (siblings are
    round-robin allocated).  Shared by the write trace's TRAVERSE segment
    and the read-phase builder so the two stay in sync.
    """
    n = R.shape[0]
    nR = int(R.sum())
    lanes = np.arange(n, dtype=np.int64)
    roff = np.zeros(n + 1, np.int64)
    np.cumsum(R, out=roff[1:])
    rlane = np.repeat(lanes, R)
    j = np.arange(nR, dtype=np.int64) - roff[rlane]
    if scan:
        ms = (leaf_ms[rlane] + j) % n_ms
    else:
        ms = (leaf_ms[rlane] - (R[rlane] - 1 - j)) % n_ms
    dep = np.where(j > 0, np.arange(nR, dtype=np.int64) - 1, -1)
    return rlane, ms, dep, roff[1:] - 1


# --------------------------------------------------------------------------
# write-phase emission (canonical = FG+ lock discipline)
# --------------------------------------------------------------------------

def write_phase_trace(sd: dict, cfg, rtt_s: float) -> VerbTrace:
    """Canonical verb stream of one write phase.

    ``sd`` holds numpy views of :class:`repro_torch.core.write.WriteStats`
    (see :func:`repro_torch.core.api.write_stats_dict`).  The canonical stream
    is the no-hierarchy discipline — every lane CASes the lock, a lane at
    node rank *r* burns *r* failed SPIN attempts while waiting, every
    lane releases remotely — which :func:`hierarchical_locks` rewrites.
    """
    act = np.asarray(sd["active"], bool)
    n = int(act.sum())
    if n == 0:
        return _empty_trace()
    f = lambda k: np.asarray(sd[k])[act]
    leaf = f("leaf").astype(np.int64)
    height = max(int(sd["height"]), 1)
    cache_hit = f("cache_hit").astype(bool)
    node_rank = f("node_rank").astype(np.int64)
    split = f("split_lane").astype(bool)
    same_ms = f("split_same_ms").astype(bool) & split
    sib_row = f("split_new_row").astype(np.int64)
    leaf_ms = cfg.ms_of(leaf)
    sib_ms = np.where(split, cfg.ms_of(sib_row), leaf_ms)

    # node-chain predecessor: the lane one FIFO rank earlier on the leaf
    order = np.lexsort((node_rank, leaf))
    pred = np.full(n, -1, np.int64)
    same_leaf = leaf[order][1:] == leaf[order][:-1]
    pred[order[1:][same_leaf]] = order[:-1][same_leaf]

    meta = dict(
        n=n,
        read_cnt=np.where(cache_hit, 1, height).astype(np.int64),
        leaf_ms=leaf_ms.astype(np.int64), sib_ms=sib_ms.astype(np.int64),
        leaf_row=leaf,
        split=split, same_ms=same_ms, pred=pred,
        node_rank=node_rank,
        cycle_head=f("cycle_head").astype(bool),
        chain_end=f("chain_end").astype(bool),
        n_ms=int(cfg.n_ms), entry_bytes=int(cfg.entry_bytes),
        node_bytes=int(cfg.node_bytes), rtt_s=float(rtt_s),
    )
    return _assemble(meta,
                     cas_mask=np.ones(n, bool),
                     unlock_mask=np.ones(n, bool),
                     spin_cnt=node_rank)


def _assemble(meta: dict, cas_mask: np.ndarray, unlock_mask: np.ndarray,
              spin_cnt: np.ndarray) -> VerbTrace:
    """Lay out one write phase's verbs under a given lock discipline.

    Segment order (stable, relied on for same-ready-time FIFO ties in the
    event loop): TRAVERSE | LOCK | WRITEBACK | SIBLING | PARENT | UNLOCK
    | SPIN.
    """
    n = meta["n"]
    R = meta["read_cnt"]
    leaf_ms, sib_ms = meta["leaf_ms"], meta["sib_ms"]
    split, pred = meta["split"], meta["pred"]
    n_ms = meta["n_ms"]
    node_b, entry_b = meta["node_bytes"], meta["entry_bytes"]
    spin_cnt = np.where(cas_mask, spin_cnt, 0).astype(np.int64)

    nR, nC = int(R.sum()), int(cas_mask.sum())
    nS, nU, nSp = int(split.sum()), int(unlock_mask.sum()), int(
        spin_cnt.sum())
    total = nR + nC + n + 2 * nS + nU + nSp

    kind = np.empty(total, np.int8)
    role = np.empty(total, np.int8)
    ms = np.empty(total, np.int32)
    nbytes = np.empty(total, np.int64)
    lane = np.empty(total, np.int32)
    dep = np.full(total, -1, np.int64)
    dep2 = np.full(total, -1, np.int64)
    at = np.zeros(total, np.float64)
    obj = np.full(total, -1, np.int64)
    leaf_row = meta["leaf_row"].astype(np.int64)

    lanes = np.arange(n, dtype=np.int64)

    # -- TRAVERSE: per-lane sequential descent chains -----------------------
    rlane, rms, rdep, last_read = _chain_layout(R, leaf_ms, n_ms)
    sl = slice(0, nR)
    kind[sl], role[sl] = READ, TRAVERSE
    ms[sl] = rms                  # leaf read last, upper levels before it
    nbytes[sl], lane[sl] = node_b, rlane
    dep[sl] = rdep

    # -- index maps for the remaining segments ------------------------------
    cas_idx = np.full(n, -1, np.int64)
    cas_idx[cas_mask] = nR + np.arange(nC)
    wb_idx = nR + nC + lanes
    sib_idx = np.full(n, -1, np.int64)
    sib_idx[split] = nR + nC + n + np.arange(nS)
    par_idx = np.full(n, -1, np.int64)
    par_idx[split] = nR + nC + n + nS + np.arange(nS)
    ul_idx = np.full(n, -1, np.int64)
    ul_idx[unlock_mask] = nR + nC + n + 2 * nS + np.arange(nU)
    # the verb a queue successor waits on: the remote release if this lane
    # issues one, else its write-back (local handover)
    chain_end_verb = np.where(unlock_mask, ul_idx, wb_idx)
    pred_end = np.where(pred >= 0, chain_end_verb[np.maximum(pred, 0)], -1)

    # -- LOCK ---------------------------------------------------------------
    c = cas_idx[cas_mask]
    kind[c], role[c] = CAS, LOCK
    ms[c], nbytes[c], lane[c] = leaf_ms[cas_mask], LOCK_BYTES, \
        lanes[cas_mask]
    dep[c] = last_read[cas_mask]
    dep2[c] = pred_end[cas_mask]
    obj[c] = leaf_row[cas_mask]

    # -- WRITEBACK ----------------------------------------------------------
    w = wb_idx
    kind[w], role[w] = WRITE, WRITEBACK
    ms[w], nbytes[w], lane[w] = leaf_ms, node_b, lanes
    dep[w] = np.where(cas_mask, cas_idx, last_read)
    dep2[w] = np.where(cas_mask, -1, pred_end)     # handover hand-off gate

    # -- SIBLING / PARENT (split continuation) ------------------------------
    s = sib_idx[split]
    kind[s], role[s] = WRITE, SIBLING
    ms[s], nbytes[s], lane[s] = sib_ms[split], node_b, lanes[split]
    dep[s] = wb_idx[split]
    p = par_idx[split]
    kind[p], role[p] = WRITE, PARENT
    ms[p], nbytes[p], lane[p] = leaf_ms[split], entry_b, lanes[split]
    dep[p] = sib_idx[split]

    # -- UNLOCK -------------------------------------------------------------
    u = ul_idx[unlock_mask]
    kind[u], role[u] = WRITE, UNLOCK
    ms[u], nbytes[u], lane[u] = leaf_ms[unlock_mask], LOCK_BYTES, \
        lanes[unlock_mask]
    dep[u] = wb_idx[unlock_mask]
    obj[u] = leaf_row[unlock_mask]

    # -- SPIN: failed attempts of waiting lanes, one per RTT-spaced poll ----
    if nSp:
        sp = slice(total - nSp, total)
        splane = np.repeat(lanes, spin_cnt)
        soff = np.zeros(n + 1, np.int64)
        np.cumsum(spin_cnt, out=soff[1:])
        sj = np.arange(nSp, dtype=np.int64) - soff[splane]
        kind[sp], role[sp] = CAS, SPIN
        ms[sp], nbytes[sp], lane[sp] = leaf_ms[splane], LOCK_BYTES, splane
        obj[sp] = leaf_row[splane]
        at[sp] = (sj + 1) * meta["rtt_s"]

    meta = dict(meta, cas_mask=cas_mask, unlock_mask=unlock_mask,
                wb_idx=wb_idx, sib_idx=sib_idx, par_idx=par_idx,
                ul_idx=ul_idx, cas_idx=cas_idx)
    return VerbTrace(kind=kind, role=role, ms=ms, nbytes=nbytes, lane=lane,
                     doorbell=np.arange(total, dtype=np.int64), dep=dep,
                     dep2=dep2, at=at, obj=obj, n_lanes=n, meta=meta)


# --------------------------------------------------------------------------
# feature transformations
# --------------------------------------------------------------------------

def hierarchical_locks(tr: VerbTrace) -> VerbTrace:
    """HOCL rewrite (§4.3): reassemble the lock sub-stream so only
    handover-cycle heads CAS, only chain ends release, and nobody spins;
    waiters gate on their queue predecessor (the FIFO wait queue)."""
    m = tr.meta
    return _assemble(m, cas_mask=m["cycle_head"],
                     unlock_mask=m["chain_end"],
                     spin_cnt=np.zeros(m["n"], np.int64))


def twolevel_writes(tr: VerbTrace) -> VerbTrace:
    """Two-level versions (§4.4): a non-split write-back touches one
    entry (17 B), not the whole node."""
    m = tr.meta
    nbytes = tr.nbytes.copy()
    shrink = m["wb_idx"][~m["split"]]
    nbytes[shrink] = m["entry_bytes"]
    return dataclasses.replace(tr, nbytes=nbytes)


def combine_doorbells(tr: VerbTrace) -> VerbTrace:
    """Command combination (§4.5): merge dependent same-MS verbs into the
    write-back's doorbell — the UNLOCK always (the lock lives on the
    leaf's MS), and the SIBLING write when the sibling landed on the same
    MS (the three-way split combination).  Merged verbs inherit the
    head's gates, so they post together; per-MS in-order delivery keeps
    them correct."""
    m = tr.meta
    doorbell = tr.doorbell.copy()
    dep, dep2 = tr.dep.copy(), tr.dep2.copy()
    wb = m["wb_idx"]

    def merge(idx_of_lane, mask):
        tgt = idx_of_lane[mask]
        src = wb[mask]
        doorbell[tgt] = doorbell[src]
        dep[tgt], dep2[tgt] = dep[src], dep2[src]

    merge(m["ul_idx"], m["unlock_mask"])
    merge(m["sib_idx"], m["same_ms"] & (m["sib_idx"] >= 0))
    return dataclasses.replace(tr, doorbell=doorbell, dep=dep, dep2=dep2)


def shift_release(tr: VerbTrace, release_s, background_s: float = 0.0
                  ) -> VerbTrace:
    """Open-loop release gates: rebase a phase trace onto absolute time.

    ``release_s[lane]`` is the lane's op arrival (admission) timestamp on
    the serving plane's absolute timeline; every verb of the lane keeps
    its *relative* ``at`` floor (the spin-CAS RTT staggering) on top of
    it, so no verb of an op can start before the op arrived.  Background
    verbs (``lane == -1`` maintenance traffic) shift by ``background_s``
    — the wave's admission time.  This is a pure relabeling of *when*:
    verb structure, payloads, deps and doorbells are untouched, which is
    what keeps the t=0 open-loop run trace-identical to the closed-loop
    scheduler (tests/test_serve_queueing.py).
    """
    if tr.n_verbs == 0:
        return tr
    at = np.asarray(tr.at, np.float64).copy()
    lm = tr.lane >= 0
    if lm.any():
        at[lm] += np.asarray(release_s, np.float64)[tr.lane[lm]]
    if background_s and not lm.all():
        at[~lm] += float(background_s)
    return dataclasses.replace(tr, at=at)


# --------------------------------------------------------------------------
# read-phase / maintenance emission
# --------------------------------------------------------------------------

def read_phase_trace(reads: np.ndarray, leaf_ms: np.ndarray, n_ms: int,
                     node_bytes: int, scan: bool = False) -> VerbTrace:
    """Per-lane sequential READ chains for a lookup or scan phase.

    ``reads[i]`` is the lane's remote node reads (measured by the cache /
    traversal); lookups *end* at the leaf (descent), scans *start* at it
    (sibling chain, round-robin allocated rightward).  Reads are
    address-dependent, hence chained and never doorbell-combined."""
    n = reads.shape[0]
    if n == 0:
        return _empty_trace()
    R = np.maximum(reads.astype(np.int64), 1)
    nR = int(R.sum())
    rlane, ms, dep, _ = _chain_layout(R, leaf_ms, n_ms, scan=scan)
    return VerbTrace(
        kind=np.full(nR, READ, np.int8),
        role=np.full(nR, TRAVERSE, np.int8),
        ms=ms.astype(np.int32), nbytes=np.full(nR, node_bytes, np.int64),
        lane=rlane.astype(np.int32),
        doorbell=np.arange(nR, dtype=np.int64), dep=dep,
        dep2=np.full(nR, -1, np.int64), at=np.zeros(nR), n_lanes=n,
        meta=dict(read_cnt=R))


def maintenance_trace(node_reads: int, small_reads: int, n_ms: int,
                      node_bytes: int, small_bytes: int,
                      rows_ms: np.ndarray | None = None) -> VerbTrace:
    """Background cache traffic: MAINT whole-node image fills and SYNC
    version sweeps, independent parallel reads spread over the cached
    rows' owners (round-robin when the row set is unknown)."""
    total = node_reads + small_reads
    if total == 0:
        return _empty_trace()
    if rows_ms is None or rows_ms.size == 0:
        rows_ms = np.arange(max(n_ms, 1), dtype=np.int64)
    spread = lambda k: rows_ms[np.arange(k) % rows_ms.size]
    ms = np.concatenate([spread(node_reads), spread(small_reads)])
    return VerbTrace(
        kind=np.full(total, READ, np.int8),
        role=np.concatenate([np.full(node_reads, MAINT, np.int8),
                             np.full(small_reads, SYNC, np.int8)]),
        ms=ms.astype(np.int32),
        nbytes=np.concatenate(
            [np.full(node_reads, node_bytes, np.int64),
             np.full(small_reads, small_bytes, np.int64)]),
        lane=np.full(total, -1, np.int32),
        doorbell=np.arange(total, dtype=np.int64),
        dep=np.full(total, -1, np.int64), dep2=np.full(total, -1, np.int64),
        at=np.zeros(total), n_lanes=0, meta={})


# --------------------------------------------------------------------------
# multi-trace merge (the cluster plane's contention interface)
# --------------------------------------------------------------------------

def merge_traces(traces: list[VerbTrace],
                 glt_chain: bool = True) -> VerbTrace:
    """Merge per-CS verb traces into one concurrent timeline.

    Each input trace is one compute server's verb stream for the same
    scheduler round; the merged trace replays them against *shared* per-MS
    NIC and atomic-unit FIFOs (``netsim.simulate``), so cross-CS queueing
    delay falls out of the event loop instead of a closed-form formula.

    The merge is conservative by construction: verbs, bytes, CAS and
    doorbell rings are concatenated (indices/lanes offset per trace, -1
    sentinels preserved), never created or dropped — the conservation
    property the cluster tests pin.

    With ``glt_chain`` (default) the merge additionally serializes
    cross-CS lock conflicts on the shared GLT entry: the *entry* LOCK of
    trace *t* on object ``o`` (the one CAS per trace whose intra-CS
    ``dep2`` gate is free — its rank-0 lane) gains a gate on trace
    *t-1*'s last UNLOCK of ``o``.  Trace order is arrival order (the
    scheduler passes CSs in functional apply order), matching the
    functional plane's serialization.  Intra-CS chains (HOCL wait queues
    / spin storms) are already inside each trace.

    ``meta`` of the result carries ``lane_cs`` (source *position* of
    every merged lane in the caller's ``traces`` list — empty traces
    keep their position, so attribution survives CSs that sat a wave
    out) and ``src_verbs``/``src_lanes`` for attribution.
    """
    keep = [(i, t) for i, t in enumerate(traces) if t.n_verbs]
    if not keep:
        return _empty_trace()
    src, traces = [i for i, _ in keep], [t for _, t in keep]
    nv = np.array([t.n_verbs for t in traces], np.int64)
    nl = np.array([t.n_lanes for t in traces], np.int64)
    voff = np.concatenate([[0], np.cumsum(nv)[:-1]])
    loff = np.concatenate([[0], np.cumsum(nl)[:-1]])

    cat = np.concatenate
    shift = lambda cols, offs: cat(
        [np.where(c >= 0, c + o, -1) for c, o in zip(cols, offs)])
    objs = [t.obj if t.obj is not None
            else np.full(t.n_verbs, -1, np.int64) for t in traces]
    merged = VerbTrace(
        kind=cat([t.kind for t in traces]),
        role=cat([t.role for t in traces]),
        ms=cat([t.ms for t in traces]),
        nbytes=cat([t.nbytes for t in traces]),
        lane=shift([t.lane for t in traces], loff).astype(np.int32),
        doorbell=cat([t.doorbell + o for t, o in zip(traces, voff)]),
        dep=shift([t.dep for t in traces], voff),
        dep2=shift([t.dep2 for t in traces], voff),
        at=cat([t.at for t in traces]),
        obj=cat(objs),
        n_lanes=int(nl.sum()),
        meta=dict(lane_cs=np.repeat(np.asarray(src, np.int64), nl),
                  src_verbs=nv.tolist(), src_lanes=nl.tolist()))

    if glt_chain:
        dep2 = merged.dep2
        role, obj = merged.role, merged.obj
        last_unlock: dict[int, int] = {}
        for t, o in zip(traces, voff):
            sl = slice(int(o), int(o + t.n_verbs))
            entry = np.nonzero((role[sl] == LOCK) & (obj[sl] >= 0)
                               & (dep2[sl] < 0))[0] + int(o)
            for i in entry.tolist():
                prev = last_unlock.get(int(obj[i]), -1)
                if prev >= 0:
                    dep2[i] = prev
            rel = np.nonzero((role[sl] == UNLOCK) & (obj[sl] >= 0))[0] \
                + int(o)
            for i in rel.tolist():
                last_unlock[int(obj[i])] = i
        merged = dataclasses.replace(merged, dep2=dep2)
    return merged
