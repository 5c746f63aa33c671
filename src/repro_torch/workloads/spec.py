"""Workload specifications: the YCSB A-F suite plus Sherman's Table 3 mixes.

A :class:`WorkloadSpec` is a declarative description of a key-value workload
— operation mix, key distribution, scan length, and load/run-phase sizes —
that the engine (:mod:`repro_torch.workloads.engine`) can run against any feature
configuration of the index.  All named mixes used anywhere in the repo live
here; benchmarks and examples must not carry private copies.

Operation semantics (mapped onto the batched ``ShermanIndex`` API):

* ``read``    — point lookup of a live record.
* ``update``  — write to a live record drawn from the distribution (this is
  what the paper's skewed-write workloads stress: hot-leaf contention).
* ``insert``  — append a brand-new record (sequential insertion rank, the
  YCSB insert semantics; grows the live-record count).
* ``delete``  — remove a live record.
* ``scan``    — short ordered range scan of ``scan_len`` entries.
* ``rmw``     — read-modify-write: lookup then write back to the same key.
"""
from __future__ import annotations

import dataclasses

OP_KINDS = ("read", "insert", "update", "delete", "scan", "rmw")
DISTRIBUTIONS = ("zipfian", "uniform", "latest", "hotspot")
#: Arrival processes for the open-loop serving plane (repro.serve);
#: canonical here so the spec validates without importing the plane.
ARRIVAL_KINDS = ("closed", "poisson", "bursty", "diurnal")
#: Fault kinds the chaos plane (repro.chaos; DESIGN.md §13) can inject;
#: canonical here — like ARRIVAL_KINDS — so a spec carrying a fault
#: schedule validates without importing the plane.
FAULT_KINDS = ("ms_crash", "cs_leave", "cs_join", "skew_shift")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One declarative fault on the simulation's shared time grid.

    The chaos plane (:mod:`repro.chaos`) fires the event at the first
    scheduler-round boundary whose simulated time has reached ``at_s``
    (crash *effects* land mid-wave — see ``ChaosRunner``).  Which extra
    fields matter depends on ``kind``:

    * ``ms_crash``   — ``ms`` crashes, losing its HOCL on-chip lock table
      (GLT rows) and, with ``lose_memory``, its share of the pooled
      memory (recovery then restores the last checkpoint and replays the
      redo log); the server restarts ``down_s`` simulated seconds later
      with an empty NIC.
    * ``cs_leave``   — compute server ``cs`` leaves; its op stream fails
      over to the surviving CSs.
    * ``cs_join``    — ``cs`` (re)joins with a **cold** index cache.
    * ``skew_shift`` — the key distribution changes from here on
      (``distribution``/``theta``/``hot_frac``/``hot_n``; empty/negative
      fields keep the current value).  A hot-key storm is a shift onto
      ``hotspot`` and a later shift back.
    """

    kind: str
    at_s: float
    ms: int = 0                  # ms_crash target
    down_s: float = 0.0          # ms_crash restart delay
    lose_memory: bool = False    # ms_crash: pooled memory lost too
    cs: int = 0                  # cs_leave / cs_join target
    distribution: str = ""       # skew_shift ("" = keep current)
    theta: float = -1.0          # skew_shift (< 0 = keep current)
    hot_frac: float = -1.0       # skew_shift hotspot share (< 0 = keep)
    hot_n: int = 0               # skew_shift hot-set size (0 = keep)

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(want one of {FAULT_KINDS})")
        if self.at_s < 0:
            raise ValueError(f"fault at_s must be >= 0, got {self.at_s}")
        if self.kind == "ms_crash" and self.down_s < 0:
            raise ValueError(f"ms_crash down_s must be >= 0, "
                             f"got {self.down_s}")
        if self.kind == "skew_shift" and self.distribution \
                and self.distribution not in DISTRIBUTIONS:
            raise ValueError(
                f"skew_shift distribution {self.distribution!r} "
                f"unknown (want one of {DISTRIBUTIONS})")


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """One workload: op-mix fractions must sum to 1."""

    name: str
    read: float = 0.0
    insert: float = 0.0
    update: float = 0.0
    delete: float = 0.0
    scan: float = 0.0
    rmw: float = 0.0
    distribution: str = "zipfian"   # zipfian | uniform | latest | hotspot
    theta: float = 0.99             # zipfian/latest skew (0 => uniform)
    hot_frac: float = 0.9           # hotspot: share of ops on the hot set
    hot_n: int = 64                 # hotspot: hot-set size (records)
    scan_len: int = 10              # entries per scan op
    load_records: int = 60_000      # records bulk-loaded before the run
    ops: int = 8_192                # run-phase operation count
    batch: int = 1_024              # ops per batched wave

    # -- chaos plane (repro.chaos; DESIGN.md §13) ----------------------
    faults: tuple = ()              # FaultEvent schedule (empty = no faults)

    # -- open-loop serving plane (repro.serve; DESIGN.md §12) ----------
    arrival: str = "closed"         # closed | poisson | bursty | diurnal
    offered_mops: float = 0.0       # offered load (Mops/s); >0 when open
    burst_factor: float = 8.0       # bursty: burst-state rate multiplier
    burst_frac: float = 0.1         # bursty: fraction of time in burst
    diurnal_period_s: float = 5e-3  # diurnal: envelope period (sim s)
    diurnal_peak: float = 1.8       # diurnal: peak/mean rate ratio

    def __post_init__(self):
        total = sum(getattr(self, k) for k in OP_KINDS)
        if abs(total - 1.0) > 1e-6:
            raise ValueError(
                f"workload {self.name!r}: op fractions sum to {total}, not 1")
        if self.distribution not in DISTRIBUTIONS:
            raise ValueError(
                f"workload {self.name!r}: unknown distribution "
                f"{self.distribution!r} (want one of {DISTRIBUTIONS})")
        if self.arrival not in ARRIVAL_KINDS:
            raise ValueError(
                f"workload {self.name!r}: unknown arrival process "
                f"{self.arrival!r} (want one of {ARRIVAL_KINDS})")
        if self.arrival != "closed" and self.offered_mops <= 0:
            raise ValueError(
                f"workload {self.name!r}: open-loop arrival "
                f"{self.arrival!r} needs offered_mops > 0")
        if self.arrival == "bursty":
            if not 0.0 < self.burst_frac < 1.0 or self.burst_factor <= 1.0 \
                    or self.burst_factor * self.burst_frac >= 1.0:
                raise ValueError(
                    f"workload {self.name!r}: bursty arrivals need "
                    f"0 < burst_frac < 1, burst_factor > 1 and "
                    f"burst_factor*burst_frac < 1 (got "
                    f"{self.burst_factor} x {self.burst_frac})")
        if self.arrival == "diurnal":
            if not 1.0 < self.diurnal_peak <= 2.0 or \
                    self.diurnal_period_s <= 0:
                raise ValueError(
                    f"workload {self.name!r}: diurnal arrivals need "
                    f"1 < peak <= 2 and period > 0 (got peak="
                    f"{self.diurnal_peak}, period={self.diurnal_period_s})")
        if self.distribution == "hotspot":
            if not 0.0 <= self.hot_frac <= 1.0 or self.hot_n < 1:
                raise ValueError(
                    f"workload {self.name!r}: hotspot needs "
                    f"0 <= hot_frac <= 1 and hot_n >= 1 (got "
                    f"{self.hot_frac}, {self.hot_n})")
        for ev in self.faults:
            if not isinstance(ev, FaultEvent):
                raise ValueError(
                    f"workload {self.name!r}: faults must be FaultEvent "
                    f"instances, got {type(ev).__name__}")
        object.__setattr__(self, "faults", tuple(self.faults))

    def replace(self, **kw) -> "WorkloadSpec":
        return dataclasses.replace(self, **kw)

    def fractions(self) -> dict:
        return {k: getattr(self, k) for k in OP_KINDS}

    #: Golden-ratio conjugate: ``frac(s * GOLDEN)`` is a low-discrepancy
    #: sequence, so remainder slots sample the op mix *in proportion to
    #: the fractions* while staying deterministic and well-interleaved.
    _GOLDEN = 0.6180339887498949

    def batch_counts(self, b: int, salt: int = 0) -> dict:
        """Deterministic per-batch op counts: floor each fraction, then
        assign each remainder slot by a fraction-weighted low-discrepancy
        draw (golden-ratio sequence over the cumulative mix).

        ``salt`` advances the sequence — the cluster scheduler passes
        ``round * n_cs + cs`` so that tiny per-CS batches (down to one
        lane) still realize the *weighted* mix over rounds (a 95/5 mix
        stays 95/5, not 50/50) instead of collapsing onto one kind,
        while shapes stay drawn from a bounded set (stable jit cache).
        """
        fracs = [(k, getattr(self, k)) for k in OP_KINDS]
        counts = {k: int(f * b) for k, f in fracs}
        rem = b - sum(counts.values())
        eligible = [(k, f) for k, f in sorted(fracs, key=lambda kv: -kv[1])
                    if f > 0]
        total = sum(f for _, f in eligible)
        for i in range(rem):
            u = ((salt + i + 1) * self._GOLDEN) % 1.0
            acc = 0.0
            for k, f in eligible:
                acc += f / total
                if u < acc or (k, f) == eligible[-1]:
                    counts[k] += 1
                    break
        return counts

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _s(name: str, **kw) -> WorkloadSpec:
    return WorkloadSpec(name=name, **kw)


#: The six standard YCSB core workloads (A-F).
YCSB_PRESETS = {
    "ycsb-a": _s("ycsb-a", read=0.5, update=0.5),
    "ycsb-b": _s("ycsb-b", read=0.95, update=0.05),
    "ycsb-c": _s("ycsb-c", read=1.0),
    "ycsb-d": _s("ycsb-d", read=0.95, insert=0.05, distribution="latest"),
    "ycsb-e": _s("ycsb-e", scan=0.95, insert=0.05),
    "ycsb-f": _s("ycsb-f", read=0.5, rmw=0.5),
}

#: Sherman's Table 3 mixes (§5).  Writes are *updates of live records* so
#: that skew produces the hot-leaf contention the paper measures.
TABLE3_PRESETS = {
    "write-only": _s("write-only", update=1.0),
    "write-intensive": _s("write-intensive", read=0.5, update=0.5),
    "read-intensive": _s("read-intensive", read=0.95, update=0.05),
    "range-only": _s("range-only", scan=1.0),
    "range-write": _s("range-write", scan=0.5, update=0.5),
}

PRESETS = {**YCSB_PRESETS, **TABLE3_PRESETS}


def get_preset(name: str, **overrides) -> WorkloadSpec:
    """Look up a named workload, optionally overriding fields
    (``get_preset("ycsb-a", theta=0.7, ops=1024)``)."""
    try:
        spec = PRESETS[name]
    except KeyError:
        raise KeyError(f"unknown workload preset {name!r}; "
                       f"known: {', '.join(sorted(PRESETS))}") from None
    return spec.replace(**overrides) if overrides else spec
