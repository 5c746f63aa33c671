"""Recorder — capture the netsim replay's per-verb timing, exactly.

The replay engines (:func:`repro_torch.core.netsim.simulate` /
:func:`simulate_ref`) already compute every verb's NIC service start,
queueing wait and completion tick on the shared int64 picosecond grid,
then fold them into scalar totals.  A :class:`Recorder` attached to a
replay keeps them: at the end of the replay the engine hands the
recorder the ``(trace, comp, wait, start)`` it is about to fold, and
:meth:`Recorder.capture` reconstructs the full per-verb decomposition

    ``ready   = max(at, comp[dep], comp[dep2])``   (the release tick)
    ``nic_wait    = start - ready``                (NIC message-unit queue)
    ``atomic_wait = (comp - rtt - cas) - (start + svc)``  (CAS only)
    ``comp - ready = nic_wait + atomic_wait + svc [+ cas] + rtt``

from the same grid constants the engine used (``_grid_times`` is
deterministic).  Capture is a pure *observation* — it runs after the
replay's last ordering decision and mutates nothing the engine reads —
so recording off (or on) is bit-identical to an unrecorded run; the
neutrality property test in tests/test_obs.py pins this.

Timeline placement: closed-loop phases each start their own relative
timeline at t=0 and the caller accumulates makespans into
``counters["sim_time_s"]``.  Callers therefore :meth:`sync_cursor` to
that counter *before* pricing a phase, and the captured segment is
placed at the cursor — segments tile the accumulated timeline exactly
(and follow chaos-plane time jumps, which move the counter).  Open-loop
replays on a carried :class:`~repro_torch.core.netsim.ServerClock` are already
absolute, so clocked segments sit at t0=0 untranslated.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import netsim
from repro_torch.core import verbs as V

PS_PER_S = netsim.PS_PER_S


@dataclasses.dataclass
class Segment:
    """One captured replay (one phase / wave), per-verb on the ps grid."""

    label: str            # phase kind the caller set ("write", "read", ...)
    clocked: bool         # replayed on a carried absolute ServerClock
    t0_ps: int            # timeline offset (0 when clocked — already absolute)
    cas_ps: int           # atomic-unit service tick count this replay used
    rtt_ps: int
    n_lanes: int
    # per-verb structure (copied views of the trace)
    kind: np.ndarray      # [V] int8  READ/WRITE/CAS
    role: np.ndarray      # [V] int8  verb taxonomy (V.ROLE_NAMES)
    ms: np.ndarray        # [V] target memory server
    lane: np.ndarray      # [V] op lane (-1 = background)
    cs: np.ndarray        # [V] source compute server (-1 = unattributed)
    doorbell: np.ndarray  # [V] doorbell group id
    dep: np.ndarray       # [V] completion gates (-1 = none)
    dep2: np.ndarray
    nbytes: np.ndarray
    obj: np.ndarray       # [V] GLT lock row (-1 = not a lock-plane verb)
    # per-verb timing (int64 ps, segment-relative)
    at_ps: np.ndarray     # earliest-post floor
    ready_ps: np.ndarray  # release tick: max(at, gate completions)
    start_ps: np.ndarray  # NIC service start
    svc_ps: np.ndarray    # NIC service ticks
    comp_ps: np.ndarray   # client-observed completion
    nic_wait_ps: np.ndarray     # queueing for the NIC message unit
    atomic_wait_ps: np.ndarray  # queueing for the atomic unit (CAS only)

    @property
    def n_verbs(self) -> int:
        return int(self.kind.size)

    @property
    def makespan_ps(self) -> int:
        return int(self.comp_ps.max(initial=0))

    def lane_tables(self):
        """Per-lane (arrival, completion, final-verb index) — the op view.

        Arrival is the lane's earliest ``at`` floor (its release time in
        open loop, the phase start in closed loop); completion is the
        lane's last verb completion (``latency_s`` in ``_finish_sim``);
        the final verb is the latest-completing verb (max index on ties,
        matching the FIFO's deterministic order).  Lanes with no verbs
        report final = -1.
        """
        lm = self.lane >= 0
        arr = np.full(self.n_lanes, np.iinfo(np.int64).max, np.int64)
        comp = np.zeros(self.n_lanes, np.int64)
        fin = np.full(self.n_lanes, -1, np.int64)
        if self.n_lanes and lm.any():
            np.minimum.at(arr, self.lane[lm], self.at_ps[lm])
            np.maximum.at(comp, self.lane[lm], self.comp_ps[lm])
            lane_c = np.where(lm, self.lane, 0)
            cand = lm & (self.comp_ps == comp[lane_c])
            fin[self.lane[cand]] = np.flatnonzero(cand)  # later index wins
        arr[fin < 0] = 0
        return arr, comp, fin


class Recorder:
    """Collects :class:`Segment` captures plus chaos fault markers."""

    def __init__(self):
        self.segments: list[Segment] = []
        self.faults: list[dict] = []
        self.phase: str = ""
        self.cursor_ps: int = 0

    # -- caller-side placement helpers ---------------------------------
    def set_phase(self, label: str) -> None:
        """Label the next capture(s) (e.g. "write", "read", "maint")."""
        self.phase = str(label)

    def sync_cursor(self, t_s: float) -> None:
        """Place the next *unclocked* capture at absolute ``t_s`` —
        callers pass their accumulated ``counters["sim_time_s"]`` before
        pricing a closed-loop phase, so relative phase timelines tile
        the run's accumulated timeline (chaos time jumps included)."""
        self.cursor_ps = int(round(float(t_s) * PS_PER_S))

    def mark_fault(self, kind: str, t_s: float, **detail) -> None:
        """Record a chaos-plane fault event (an instant marker in the
        exported timeline)."""
        self.faults.append(dict(kind=str(kind),
                                t_ps=int(round(float(t_s) * PS_PER_S)),
                                **detail))

    # -- the capture hook (called by the replay engines) ----------------
    def capture(self, trace: V.VerbTrace, net, onchip: bool,
                comp_ps: np.ndarray, wait_ps: np.ndarray,
                start_ps: np.ndarray, *, clocked: bool) -> None:
        n = trace.n_verbs
        if n == 0:
            return
        svc, cas_ps, rtt_ps, at_ps = netsim._grid_times(trace, net, onchip)
        dep, dep2 = trace.dep, trace.dep2
        ready = at_ps.copy()
        for col in (dep, dep2):
            m = col >= 0
            if m.any():
                ready[m] = np.maximum(ready[m], comp_ps[col[m]])
        nic_wait = start_ps - ready
        atomic_wait = np.zeros(n, np.int64)
        cm = trace.kind == V.CAS
        if cm.any():
            # CAS: comp = atomic_start + cas + rtt; it queued for the
            # atomic unit from its NIC service end (start + svc)
            atomic_wait[cm] = (comp_ps[cm] - rtt_ps - cas_ps
                               - (start_ps[cm] + svc[cm]))
        lane_cs = trace.meta.get("lane_cs") if trace.meta else None
        if lane_cs is not None and len(lane_cs):
            lane_c = np.where(trace.lane >= 0, trace.lane, 0)
            cs = np.where(trace.lane >= 0,
                          np.asarray(lane_cs, np.int64)[lane_c], -1)
        else:
            cs = np.full(n, -1, np.int64)
        obj = (trace.obj.astype(np.int64) if trace.obj is not None
               else np.full(n, -1, np.int64))
        self.segments.append(Segment(
            label=self.phase, clocked=bool(clocked),
            t0_ps=0 if clocked else self.cursor_ps,
            cas_ps=cas_ps, rtt_ps=rtt_ps, n_lanes=trace.n_lanes,
            kind=np.array(trace.kind), role=np.array(trace.role),
            ms=np.array(trace.ms, np.int64),
            lane=np.array(trace.lane, np.int64), cs=cs,
            doorbell=np.array(trace.doorbell, np.int64),
            dep=np.array(dep, np.int64), dep2=np.array(dep2, np.int64),
            nbytes=np.array(trace.nbytes, np.int64), obj=obj,
            at_ps=at_ps, ready_ps=ready, start_ps=np.array(start_ps),
            svc_ps=svc, comp_ps=np.array(comp_ps),
            nic_wait_ps=nic_wait, atomic_wait_ps=atomic_wait))

    # -- totals ---------------------------------------------------------
    @property
    def n_verbs(self) -> int:
        return sum(s.n_verbs for s in self.segments)

    @property
    def n_segments(self) -> int:
        return len(self.segments)
