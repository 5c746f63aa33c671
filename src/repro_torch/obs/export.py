"""Render a recorded run as a Chrome/Perfetto trace + derived series.

:func:`to_chrome_trace` emits the Trace Event Format dict that
``chrome://tracing`` and https://ui.perfetto.dev load directly
(``{"traceEvents": [...]}``; timestamps in microseconds):

* one **process per memory server** (pid ``1000+ms``) with two threads —
  the NIC message unit (tid 0) and the atomic unit (tid 1) — carrying a
  complete ("X") event per verb service span, named ``role/KIND``;
* one **process per compute server** (pid ``2000+cs``; 2000 alone when
  the run has a single unattributed frontend) with one thread per lane
  group, carrying each op's arrival→completion span;
* chaos-plane faults as global instant ("i") markers;
* per-MS NIC utilization as counter ("C") tracks.

:func:`timeseries` computes the derived series on their own: per-MS NIC
utilization and queue depth over time buckets, and per-wave lock-chain
occupancy (time LOCK-plane verbs sat gated before their CAS posted).
"""
from __future__ import annotations

import json

import numpy as np

from repro_torch.core import verbs as V
from repro_torch.obs.recorder import PS_PER_S, Recorder

_KIND_NAMES = ("READ", "WRITE", "CAS")
_LANE_TRACKS = 16   # lanes fold onto this many threads per CS process


def _meta(pid: int, name: str, threads: dict[int, str]) -> list[dict]:
    ev = [dict(ph="M", pid=pid, tid=0, name="process_name",
               args=dict(name=name))]
    for tid, tname in threads.items():
        ev.append(dict(ph="M", pid=pid, tid=tid, name="thread_name",
                       args=dict(name=tname)))
    return ev


def to_chrome_trace(rec: Recorder, *, utilization_buckets: int = 64) -> dict:
    """Build the trace-viewer JSON dict for a recorded run."""
    ev: list[dict] = []
    seen_ms: set[int] = set()
    seen_cs: set[int] = set()
    for si, seg in enumerate(rec.segments):
        if not seg.n_verbs:
            continue
        t0 = seg.t0_ps
        seen_ms.update(int(m) for m in np.unique(seg.ms))
        # MS-side device spans
        for i in range(seg.n_verbs):
            k = int(seg.kind[i])
            name = f"{V.ROLE_NAMES[int(seg.role[i])]}/{_KIND_NAMES[k]}"
            args = dict(seg=si, verb=i, lane=int(seg.lane[i]),
                        cs=int(seg.cs[i]), doorbell=int(seg.doorbell[i]),
                        nbytes=int(seg.nbytes[i]),
                        nic_wait_us=int(seg.nic_wait_ps[i]) / 1e6)
            ev.append(dict(ph="X", pid=1000 + int(seg.ms[i]), tid=0,
                           ts=(t0 + int(seg.start_ps[i])) / 1e6,
                           dur=int(seg.svc_ps[i]) / 1e6,
                           name=name, cat=seg.label or "phase", args=args))
            if k == V.CAS:
                ev.append(dict(
                    ph="X", pid=1000 + int(seg.ms[i]), tid=1,
                    ts=(t0 + int(seg.comp_ps[i]) - seg.rtt_ps
                        - seg.cas_ps) / 1e6,
                    dur=seg.cas_ps / 1e6, name=name,
                    cat=seg.label or "phase",
                    args=dict(args, atomic_wait_us=int(
                        seg.atomic_wait_ps[i]) / 1e6)))
        # CS-side op spans (arrival -> completion per lane)
        arr, comp, fin = seg.lane_tables()
        for ln in np.flatnonzero(fin >= 0):
            c = int(seg.cs[int(fin[ln])])
            pid = 2000 + max(c, 0)
            seen_cs.add(max(c, 0))
            ev.append(dict(ph="X", pid=pid, tid=int(ln) % _LANE_TRACKS,
                           ts=(t0 + int(arr[ln])) / 1e6,
                           dur=int(comp[ln] - arr[ln]) / 1e6,
                           name=f"{seg.label or 'op'} lane{int(ln)}",
                           cat="ops", args=dict(seg=si, lane=int(ln))))
    for f in rec.faults:
        ev.append(dict(ph="i", s="g", pid=0, tid=0,
                       ts=f["t_ps"] / 1e6, name=f"fault:{f['kind']}",
                       cat="chaos",
                       args={k: v for k, v in f.items() if k != "t_ps"}))
    ts = timeseries(rec, buckets=utilization_buckets)
    for m in sorted(seen_ms):
        for t, u in zip(ts["t_s"], ts["nic_util"][m]):
            ev.append(dict(ph="C", pid=1000 + m, tid=0,
                           ts=t * 1e6, name="nic_util",
                           args=dict(util=round(float(u), 4))))
    head = _meta(0, "chaos", {0: "faults"}) if rec.faults else []
    for m in sorted(seen_ms):
        head += _meta(1000 + m, f"MS{m}",
                      {0: "nic msg unit", 1: "atomic unit"})
    for c in sorted(seen_cs):
        head += _meta(2000 + c, f"CS{c}",
                      {t: f"lanes %{_LANE_TRACKS}=={t}"
                       for t in range(_LANE_TRACKS)})
    return dict(traceEvents=head + ev, displayTimeUnit="ms")


def write_chrome_trace(rec: Recorder, path: str, **kw) -> str:
    """Serialize :func:`to_chrome_trace` to ``path``; returns the path."""
    with open(path, "w") as f:
        json.dump(to_chrome_trace(rec, **kw), f)
        f.write("\n")
    return path


def timeseries(rec: Recorder, buckets: int = 64) -> dict:
    """Derived time series over the recorded horizon.

    * ``nic_util[ms]``   — fraction of each time bucket the MS's NIC
      message unit was in service;
    * ``queue_depth[ms]`` — mean number of verbs released-but-unserved
      (waiting for the NIC unit) over each bucket;
    * ``lock_chain`` — per segment (wave): total time LOCK-role verbs
      sat gated between release and service (``ready - at`` summed, s) —
      the GLT/LLT chain occupancy of that wave — plus the wave's label
      and chained-verb count.
    """
    n_ms, hi = 0, 0
    for seg in rec.segments:
        if seg.n_verbs:
            n_ms = max(n_ms, int(seg.ms.max()) + 1)
            hi = max(hi, seg.t0_ps + seg.makespan_ps)
    if not n_ms or not hi:
        return dict(t_s=[], nic_util=[], queue_depth=[], lock_chain=[])
    edges = np.linspace(0, hi, buckets + 1).astype(np.int64)
    width = np.diff(edges).astype(np.float64)
    util = np.zeros((n_ms, buckets))
    depth = np.zeros((n_ms, buckets))
    lock_rows = []
    for si, seg in enumerate(rec.segments):
        if not seg.n_verbs:
            continue
        t0 = seg.t0_ps
        for m in np.unique(seg.ms):
            sel = seg.ms == m
            # busy overlap of each service span with each bucket
            lo = t0 + seg.start_ps[sel]
            hi_v = lo + seg.svc_ps[sel]
            ov = (np.minimum(hi_v[:, None], edges[None, 1:])
                  - np.maximum(lo[:, None], edges[None, :-1]))
            util[m] += np.maximum(ov, 0).sum(0) / width
            # waiting overlap: released but not yet in service
            lo = t0 + seg.ready_ps[sel]
            hi_v = t0 + seg.start_ps[sel]
            ov = (np.minimum(hi_v[:, None], edges[None, 1:])
                  - np.maximum(lo[:, None], edges[None, :-1]))
            depth[m] += np.maximum(ov, 0).sum(0) / width
        lk = seg.role == V.LOCK
        gated = lk & (seg.ready_ps > seg.at_ps)
        lock_rows.append(dict(
            segment=si, label=seg.label,
            lock_verbs=int(lk.sum()), chained=int(gated.sum()),
            chain_wait_s=float((seg.ready_ps[lk]
                                - seg.at_ps[lk]).sum() / PS_PER_S)))
    mid = (edges[:-1] + width / 2) / PS_PER_S
    return dict(t_s=mid.tolist(), nic_util=util.tolist(),
                queue_depth=depth.tolist(), lock_chain=lock_rows)
