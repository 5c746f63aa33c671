"""Fault-injection primitives for the chaos plane (DESIGN.md §13).

The PyTorch counterpart of :mod:`repro.chaos.faults`.  The declarative
side of a fault schedule lives with the workload spec
(:class:`repro_torch.workloads.spec.FaultEvent`, ``WorkloadSpec.faults``);
this module holds the *mechanisms* the runner applies when an event fires:

* **Repair-queue abandonment / re-derivation** — an MS crash breaks the
  wave in flight: half-splits parked in the shared repair queue are
  *abandoned* (mirrored on the host, then cleared).  The B-link invariant
  keeps the tree correct meanwhile — a half-split leaf is reachable
  through its sibling pointer — so abandonment is safe; recovery either
  **re-derives** the pending separators from the mirror after a priced
  survey scan of the crashed server's rows (memory survived) or lets the
  redo-log **replay** regenerate and drain them (memory lost).
* **Recovery verb traces** — the priced wire cost of coming back: the
  GLT re-initialization write (on-chip SRAM is re-armed to all-free),
  the survey scan or the checkpoint re-population writes.  Recovery
  traffic is merged onto the shared timeline like any other trace, so
  conservation invariants hold across crash boundaries.
* **Tree-content extraction + oracle replay** — the differential
  harness's ground truth: the final key→value map of a (possibly
  faulted) cluster must equal a :class:`repro_torch.core.ref.OracleIndex`
  replay of the executed write log.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import verbs as V
from repro_torch.core.api import REPAIR_CAP
from repro_torch.core.ref import OracleIndex
from repro_torch.core.tree import (EMPTY_KEY, TreeConfig, TreeState,
                                   state_to_numpy)
from repro_torch.core.write import (RepairQueue, repair_from_numpy,
                                    repair_to_numpy)
from repro_torch.workloads.spec import FaultEvent

#: Cap on discrete verbs per recovery trace: beyond this the modeled I/O
#: is aggregated into equal-sized chunks (bytes conserved, event count
#: bounded) so a huge restore never explodes the event loop.
MAX_RECOVERY_VERBS = 256


# --------------------------------------------------------------------------
# repair-queue crash handling
# --------------------------------------------------------------------------

def abandon_repairs(cluster):
    """Snapshot-and-clear the cluster's wave-scope repair queue.

    Returns a host-side mirror dict (``sep``/``child``/``level``/
    ``valid`` numpy arrays, copies) when entries were pending, else
    ``None``.  The mirror is what a real recovery scan would re-derive
    from the surviving B-link structure — half-splits are self-describing
    (the sibling pointer and fence keys name the missing separator), so
    the simulation keeps the mirror instead of re-walking the tree.
    """
    q = repair_to_numpy(cluster.repair)
    empty = RepairQueue.empty(REPAIR_CAP, cluster.device)
    if not cluster._repair_backlog and not q.valid.any():
        cluster.repair = empty
        cluster._repair_backlog = 0
        return None
    mirror = dict(sep=q.sep.copy(), child=q.child.copy(),
                  level=q.level.copy(), valid=q.valid.copy())
    cluster.repair = empty
    cluster._repair_backlog = 0
    return mirror


def requeue_repairs(cluster, mirror: dict) -> int:
    """Re-derive: push a mirror taken by :func:`abandon_repairs` back
    into the (empty) queue, on the device of the cluster's state, and
    return the pending count."""
    cluster.repair = repair_from_numpy(mirror, device=cluster.device)
    n = int(mirror["valid"].sum())
    cluster._repair_backlog = n
    return n


# --------------------------------------------------------------------------
# recovery verb traces
# --------------------------------------------------------------------------

def _chunks(total_bytes: int, max_verbs: int) -> np.ndarray:
    """Split a byte total into <= max_verbs near-equal chunks (>=1 each)."""
    total_bytes = int(total_bytes)
    if total_bytes <= 0:
        return np.zeros(0, np.int64)
    n = int(min(max_verbs, total_bytes))
    base = total_bytes // n
    out = np.full(n, base, np.int64)
    out[:total_bytes - base * n] += 1
    return out


def recovery_trace(cfg: TreeConfig, ms: int, *, scan_rows: int = 0,
                   restore_rows: int = 0, small_bytes: int = 64,
                   max_verbs: int = MAX_RECOVERY_VERBS) -> V.VerbTrace:
    """The restart protocol's wire cost, as one background verb trace.

    Always: one GLT re-initialization WRITE (the whole on-chip lock
    array is re-armed to free — ``n_locks_per_ms * 2`` bytes, §4.3's
    16-bit lock words).  Plus either

    * ``scan_rows`` small survey READs of the crashed server's allocated
      rows (memory survived: re-derive which half-splits were pending),
      or
    * ``restore_rows`` whole-node WRITEs re-populating the crashed
      server's share of the pool from the last checkpoint (memory lost;
      the checkpoint store itself is off-path, so only the writes back
      into the MS are priced — the redo replay is priced separately by
      the real write waves it re-runs).

    All verbs are background (lane -1), independent (own doorbells), and
    target the restarted ``ms`` whose NIC starts empty — so the trace's
    makespan is the server's genuine restart I/O time.
    """
    glt_bytes = np.array([cfg.n_locks_per_ms * 2], np.int64)
    scan = _chunks(int(scan_rows) * small_bytes, max_verbs)
    rest = _chunks(int(restore_rows) * cfg.node_bytes, max_verbs)
    nbytes = np.concatenate([glt_bytes, scan, rest])
    kind = np.concatenate([
        np.full(1, V.WRITE, np.int8),
        np.full(scan.size, V.READ, np.int8),
        np.full(rest.size, V.WRITE, np.int8)])
    role = np.concatenate([
        np.full(1, V.UNLOCK, np.int8),          # lock-plane re-arm
        np.full(scan.size, V.SYNC, np.int8),    # survey reads
        np.full(rest.size, V.MAINT, np.int8)])  # image re-population
    n = nbytes.size
    return V.VerbTrace(
        kind=kind, role=role,
        ms=np.full(n, int(ms), np.int32), nbytes=nbytes,
        lane=np.full(n, -1, np.int32),
        doorbell=np.arange(n, dtype=np.int64),
        dep=np.full(n, -1, np.int64), dep2=np.full(n, -1, np.int64),
        at=np.zeros(n), n_lanes=0, meta={})


# --------------------------------------------------------------------------
# differential-harness ground truth
# --------------------------------------------------------------------------

def tree_contents(state: TreeState) -> dict:
    """The live key→value map of a tree — leaf entries of non-free
    level-0 nodes.  This is the quantity every faulted run must agree
    with the fault-free oracle on.  It copies the whole state to the
    host: a check for small pools."""
    st = state_to_numpy(state)
    leaf = (st.level == 0) & ~st.free_bit
    keys = st.keys[leaf].ravel()
    vals = st.vals[leaf].ravel()
    m = keys != EMPTY_KEY
    return dict(zip(keys[m].tolist(), vals[m].tolist()))


def oracle_replay(base_keys, base_vals, write_log) -> OracleIndex:
    """Build the fault-free oracle: bulk-loaded records plus the
    *executed* write log replayed in lane order.

    ``write_log`` entries are ``(keys_by_slot, vals_by_slot, is_delete)``
    exactly as the waves executed them (after any CS-leave failover
    reassignment), so last-writer-wins resolves identically to the
    stacked dispatch's intra-batch dedupe."""
    oracle = OracleIndex()
    oracle.insert_batch(np.asarray(base_keys), np.asarray(base_vals))
    for keys_by, vals_by, is_del in write_log:
        for slot, k in enumerate(keys_by):
            if k is None or len(k) == 0:
                continue
            if is_del:
                oracle.delete_batch(k)
            else:
                v = None if vals_by is None else vals_by[slot]
                if v is None:
                    v = np.zeros(len(k), np.int32)
                oracle.insert_batch(k, v)
    return oracle


def schedule_for_horizon(horizon_s: float, *, ms: int = 0, cs: int = 1,
                         down_frac: float = 0.04,
                         lose_memory: bool = True,
                         storm_theta: float = 0.99) -> tuple:
    """A standard all-three-kinds schedule placed at fixed fractions of
    a (calibrated) run horizon: MS crash early, CS churn mid-run, a
    hot-key storm late that lifts before the end so time-to-recover is
    measurable for every fault.  Used by the chaos benchmark and tests.
    """
    h = float(horizon_s)
    return (
        FaultEvent("ms_crash", at_s=0.20 * h, ms=ms,
                   down_s=down_frac * h, lose_memory=lose_memory),
        FaultEvent("cs_leave", at_s=0.42 * h, cs=cs),
        FaultEvent("cs_join", at_s=0.58 * h, cs=cs),
        FaultEvent("skew_shift", at_s=0.72 * h, distribution="hotspot",
                   theta=storm_theta, hot_frac=0.95, hot_n=16),
        FaultEvent("skew_shift", at_s=0.86 * h, distribution="zipfian",
                   theta=storm_theta),
    )
