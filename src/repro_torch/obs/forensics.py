"""Tail forensics: why is p99 what it is?

:func:`attribute_ops` decomposes every recorded op's end-to-end latency
into exactly four components by walking its dependency/doorbell/GLT-chain
edges backwards from the final verb:

* **nic_queue**  — waiting for a target MS's NIC message unit;
* **atomic_ser** — CAS serialization on an MS's atomic unit;
* **lock_wait**  — lock-*protocol* time the op sat behind: the full
  occupancy (queue + service + RTT) of crossed lock-plane verbs —
  other lanes' CAS / SPIN / UNLOCK hops ahead in the chain — plus any
  spin-retry ``at``-floor staggering of the op's own verbs;
* **service**    — NIC service + CAS execution + RTTs of the op's own
  verbs and of crossed *data* verbs (a predecessor's write-back the
  handover gated on) along the critical chain.

The walk is exact on the int64 ps grid and follows the op's true
critical path *across lane boundaries*.  Each verb's interval
``[ready, comp]`` splits as ``nic_wait + atomic_wait + svc [+ cas] +
rtt``; the verb's binding gate (the dependency whose completion equals
its ready tick) is walked into next — whether it is an earlier verb of
the same lane or another lane's verb (an HOCL handover or cross-CS
GLT-chain edge), because the handover edge itself is instantaneous
(``comp[gate] == ready``): what the waiter physically waits on is the
*predecessor's* verbs moving through the network.  Crossed verbs sort
by what they are: lock-plane verbs (``obj >= 0`` — the per-handover
CAS+UNLOCK round trips the flat rungs pay and HOCL elides) charge to
lock_wait whole; data verbs (the predecessor's write-back, which still
gates a handover after HOCL) decompose into the ordinary NIC-queue /
atomic / service buckets.  Components are clipped to the window after
the op's own arrival, so the identity below survives the crossing; a
walk that terminates on a verb's own ``at`` floor (spin staggering)
charges the remainder to lock_wait.  By construction

    ``nic_queue + atomic_ser + lock_wait + service == comp - arrival``

with integer equality — tests/test_obs.py asserts it verb-for-verb and
ci.sh gates it through ``BENCH_obs.json``.

:func:`span_accounting` is the conservation side: per-MS recorded busy
spans must be non-overlapping per FIFO (the devices are FIFOs — two
verbs cannot be in service at once) and sum to the simulator's busy
time, and every verb's span decomposition must reconcile with its
completion tick.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import verbs as V
from repro_torch.obs.recorder import PS_PER_S, Recorder, Segment


def _attribute_lane(seg: Segment, fin: int, arrival: int):
    """Walk one op's critical path backwards (crossing lane boundaries
    along binding gate edges); returns the four components in ps
    (exact: they sum to ``comp[fin] - arrival``).

    Every component interval is clipped to ``[arrival, comp[fin]]`` —
    crossed predecessor verbs may predate the op's arrival, and only
    the post-arrival part of their occupancy explains *this* op's
    latency.  The walk stops when the path reaches the arrival tick or
    terminates on an ``at`` floor (the pre-arrival remainder of which
    is charged to lock_wait)."""
    dep, dep2, comp = seg.dep, seg.dep2, seg.comp_ps
    nic = atomic = lock = service = 0
    i = int(fin)
    op_lane = int(seg.lane[fin])

    def clip(lo: int, hi: int) -> int:
        return max(0, hi - max(lo, arrival))

    while True:
        r = int(seg.ready_ps[i])
        s = int(seg.start_ps[i])
        svc_end = s + int(seg.svc_ps[i])
        c = int(comp[i])
        if seg.lane[i] != op_lane and seg.obj[i] >= 0:
            # a crossed lock-plane verb (CAS / SPIN / UNLOCK of another
            # lane): its whole occupancy is lock-protocol overhead this
            # op sat behind — the per-handover CAS+UNLOCK RTTs the flat
            # rungs pay and HOCL elides
            lock += clip(r, c)
        else:
            nic += clip(r, s)
            atomic += clip(svc_end, svc_end + int(seg.atomic_wait_ps[i]))
            # NIC service + (CAS exec, when present) + RTT tail
            service += clip(s, svc_end) + clip(
                svc_end + int(seg.atomic_wait_ps[i]), c)
        if r <= arrival:
            break
        nxt = -1
        for d in (int(dep[i]), int(dep2[i])):
            if d >= 0 and comp[d] == r:
                nxt = d
                break
        if nxt < 0:
            # ready is the verb's own ``at`` floor: spin staggering
            lock += r - arrival
            break
        i = nxt
    return nic, atomic, lock, service


def attribute_ops(rec: Recorder, top_k: int = 0) -> list[dict]:
    """Per-op latency attribution rows, sorted slowest-first.

    One row per recorded (segment, lane) op: identity (segment index,
    phase label, lane, CS), absolute placement (arrival/completion in
    seconds), end-to-end latency, and the four components.  ``top_k``
    truncates to the K slowest ops after sorting (0 = all).
    """
    rows = []
    for si, seg in enumerate(rec.segments):
        arr, comp, fin = seg.lane_tables()
        for ln in np.flatnonzero(fin >= 0):
            f = int(fin[ln])
            a = int(arr[ln])
            nic, atomic, lock, service = _attribute_lane(seg, f, a)
            lat = int(comp[ln]) - a
            rows.append(dict(
                segment=si, label=seg.label, lane=int(ln),
                cs=int(seg.cs[f]),
                arrival_s=(seg.t0_ps + a) / PS_PER_S,
                comp_s=(seg.t0_ps + int(comp[ln])) / PS_PER_S,
                latency_us=lat / 1e6,
                nic_queue_us=nic / 1e6, atomic_ser_us=atomic / 1e6,
                lock_wait_us=lock / 1e6, service_us=service / 1e6,
                residual_ps=lat - (nic + atomic + lock + service)))
    rows.sort(key=lambda r: -r["latency_us"])
    return rows[:top_k] if top_k else rows


def attribution_totals(rows: list[dict]) -> dict:
    """Fold attribution rows into component totals + fractions."""
    tot = dict(nic_queue_s=0.0, atomic_ser_s=0.0, lock_wait_s=0.0,
               service_s=0.0)
    lat = 0.0
    for r in rows:
        tot["nic_queue_s"] += r["nic_queue_us"] * 1e-6
        tot["atomic_ser_s"] += r["atomic_ser_us"] * 1e-6
        tot["lock_wait_s"] += r["lock_wait_us"] * 1e-6
        tot["service_s"] += r["service_us"] * 1e-6
        lat += r["latency_us"] * 1e-6
    tot["latency_s"] = lat
    for k in ("nic_queue", "atomic_ser", "lock_wait", "service"):
        tot[k + "_frac"] = tot[k + "_s"] / lat if lat else 0.0
    tot["ops"] = len(rows)
    return tot


def span_accounting(rec: Recorder) -> dict:
    """Reconcile recorded spans with the simulator (DESIGN.md §14).

    Checks, per segment:

    * per-MS NIC spans ``[start, start+svc]`` are non-overlapping
      (FIFO), per-MS atomic spans ``[comp-rtt-cas, comp-rtt]`` likewise;
    * per-verb reconciliation ``comp - ready == nic_wait + svc
      [+ atomic_wait + cas] + rtt`` holds with integer equality;
    * no span extends past the segment's makespan.

    Returns per-MS busy totals (summed across segments) plus an ``ok``
    verdict; the busy totals are the utilization numerators the exporter
    and metrics registry reuse.
    """
    n_ms = 0
    for seg in rec.segments:
        if seg.n_verbs:
            n_ms = max(n_ms, int(seg.ms.max()) + 1)
    nic_busy = np.zeros(n_ms, np.int64)
    atomic_busy = np.zeros(n_ms, np.int64)
    ok = True
    horizon = 0
    for seg in rec.segments:
        if not seg.n_verbs:
            continue
        cm = seg.kind == V.CAS
        recon = (seg.comp_ps - seg.ready_ps
                 - seg.nic_wait_ps - seg.svc_ps - seg.rtt_ps
                 - np.where(cm, seg.atomic_wait_ps + seg.cas_ps, 0))
        ok &= bool((recon == 0).all())
        mk = seg.makespan_ps
        ok &= bool((seg.start_ps + seg.svc_ps <= mk).all())
        horizon = max(horizon, seg.t0_ps + mk)
        np.add.at(nic_busy, seg.ms, seg.svc_ps)
        if cm.any():
            np.add.at(atomic_busy, seg.ms[cm],
                      np.full(int(cm.sum()), seg.cas_ps, np.int64))
        # FIFO non-overlap per MS (NIC unit, then atomic unit)
        for msk, lo, hi in (
                (np.ones(seg.n_verbs, bool), seg.start_ps,
                 seg.start_ps + seg.svc_ps),
                (cm, seg.comp_ps - seg.rtt_ps - seg.cas_ps,
                 seg.comp_ps - seg.rtt_ps)):
            idx = np.flatnonzero(msk)
            if not idx.size:
                continue
            o = np.lexsort((lo[idx], seg.ms[idx]))
            idx = idx[o]
            same = seg.ms[idx][1:] == seg.ms[idx][:-1]
            ok &= bool((hi[idx][:-1][same] <= lo[idx][1:][same]).all())
    return dict(ok=bool(ok), n_ms=n_ms, horizon_s=horizon / PS_PER_S,
                nic_busy_s=(nic_busy / PS_PER_S).tolist(),
                atomic_busy_s=(atomic_busy / PS_PER_S).tolist())
