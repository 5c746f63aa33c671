"""The cluster scheduler: a fleet of ClusterNodes over one memory pool.

The PyTorch counterpart of :mod:`repro.cluster.sched`.  The shared state
lives on one device (CUDA unless the caller asks for the CPU); the stacked
write phase is :func:`repro_torch.core.write.write_phase`, which updates
the pool in place where the reference donates it to a jitted phase.  The
performance plane (trace merging, replay, the open-loop clock) is the
reference's host NumPy.

One **round** (scheduler tick) interleaves one op batch per compute
server (DESIGN.md §11):

1. *Functional plane* — the fleet's write batches execute as **one
   stacked ``[n_cs*B]``-lane dispatch** per phase: every lane carries its
   CS id, so HOCL's LLT grouping keeps wait queues private per CS while
   the batch applies in lane order (CS order is arrival order, the
   cluster analogue of §8's lane-order rule — intra-batch dedupe keeps
   the last lane, i.e. the last CS, exactly like the old sequential
   apply).  The stacked batch is padded to a power-of-two bucket and the
   repair queue is shared and of fixed capacity, so a cluster wave costs
   one write-phase call per phase instead of ``n_cs``.  Each node still
   uses only its private cache (write routing probes each CS's own
   image for its own lanes); remote splits reach a CS lazily (stale
   reads, periodic sweeps), never as shared split outputs.  Read waves
   stay per-CS — each descends through its own cache image — and are
   bucket-padded.
2. *Performance plane* — each phase's per-lane structure is split back
   into per-CS stats (the lane's CS id masks the stacked arrays), turned
   into per-CS verb traces, **merged**
   (:func:`repro_torch.core.verbs.merge_traces`) and replayed in one
   discrete-event timeline against the shared per-MS NIC and atomic-unit
   FIFOs.  Cross-CS GLT serialization, FG+ retry storms clogging the
   atomic unit, and HOCL's handover savings are emergent queueing, not
   formulas.

The scheduler keeps two tallies per run: the **merged** totals the event
loop reports and the **functional** per-CS trace totals accumulated
before merging.  Their equality (verbs, doorbells, bytes) is the
cluster's conservation invariant, exported as ``conservation_ok``.
"""
from __future__ import annotations

import hashlib
import math
import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.cluster.node import ClusterNode
from repro_torch.cluster.streams import ClusterStreams
from repro_torch.core import hocl, netsim, verbs as V, write
from repro_torch.core.api import (REPAIR_CAP, bucket_size, pad_to_bucket,
                                  run_repair_drain, write_stats_dict)
from repro_torch.core.netsim import Features, NetConfig, SHERMAN
from repro_torch.core.tree import TreeConfig, TreeState, _as_i32, bulkload
from repro_torch.core.write import RepairQueue
from repro_torch.workloads.spec import OP_KINDS, WorkloadSpec

VAL_MASK = (1 << 30) - 1


class Cluster:
    """A multi-CS simulation plane over one shared memory-side state."""

    def __init__(self, cfg: TreeConfig, state: TreeState,
                 features: Features = SHERMAN,
                 net: Optional[NetConfig] = None, *,
                 n_clients: int = 64,
                 cache_bytes: int = 64 << 20,
                 cache_levels: Optional[int] = None,
                 sync_rounds: int = 4):
        self.cfg = cfg
        self.state = state
        self.device = state.keys.device
        self.features = features
        self.net = net or NetConfig()
        n_cs = max(1, min(cfg.n_cs, int(n_clients)))
        self.per_cs = max(1, -(-int(n_clients) // n_cs))
        self.n_clients = self.per_cs * n_cs     # realized lanes per round
        if self.n_clients != int(n_clients):
            warnings.warn(
                f"n_clients={n_clients} is not a multiple of the "
                f"{n_cs}-CS fleet; running {self.n_clients} client "
                f"threads ({n_cs} CS x {self.per_cs})", stacklevel=2)
        self.nodes = [
            ClusterNode(i, cfg, cache_bytes=cache_bytes,
                        cache_levels=cache_levels, sync_rounds=sync_rounds,
                        device=self.device)
            for i in range(n_cs)]
        # the wave-scope repair queue: half-splits of the stacked dispatch
        self.repair = RepairQueue.empty(REPAIR_CAP, self.device)
        self._repair_backlog = 0
        # merged-timeline totals (the priced side) + wave-scope structure
        self.counters = {
            "msgs": 0, "verbs": 0, "doorbells": 0, "bytes": 0.0,
            "cas_msgs": 0, "sim_time_s": 0.0, "merged_waves": 0,
            "rounds": 0, "cross_cs_conflicts": 0,
            "stacked_phases": 0, "internal_splits": 0, "root_splits": 0,
        }
        self.latencies_write: list[np.ndarray] = []
        self.latencies_read: list[np.ndarray] = []
        self.doorbells_write: list[np.ndarray] = []
        self.write_bytes: list[np.ndarray] = []
        # open-loop serving plane (enable_open_loop; DESIGN.md §12):
        self.clock: Optional[netsim.ServerClock] = None
        self.queue_write: list[np.ndarray] = []   # per-op queueing delay
        self.queue_read: list[np.ndarray] = []
        self.last_read_comp: dict = {}  # cs -> absolute lookup completions
        self.trace_log: Optional[list] = None     # merged-trace digests
        # opt-in observability plane (repro_torch.obs, DESIGN.md §14):
        # attach a Recorder here and every merged wave captures its timeline
        self.recorder = None

    @property
    def n_cs(self) -> int:
        return len(self.nodes)

    # -- constructors ------------------------------------------------------
    @classmethod
    def build(cls, cfg: TreeConfig, keys, vals, fill: float = 0.8,
              device=None, **kw) -> "Cluster":
        """Bulk-load ``keys``/``vals`` on ``device`` (default CUDA)."""
        return cls(cfg, bulkload(cfg, keys, vals, fill=fill, device=device),
                   **kw)

    # -- open-loop mode / trace digests ------------------------------------
    def enable_open_loop(self) -> None:
        """Switch the performance plane onto one absolute timeline
        (the serving plane, DESIGN.md §12): waves replay against a
        carried per-MS :class:`~repro_torch.core.netsim.ServerClock`, per-op
        sojourns are measured from explicit arrival timestamps, and
        ``sim_time_s`` becomes the absolute horizon (max completion)
        instead of a sum of per-phase makespans."""
        self.clock = netsim.ServerClock.fresh(self.cfg.n_ms)
        self.clock.recorder = self.recorder

    def record_traces(self) -> None:
        """Log a structural digest of every merged trace — everything
        but the ``at`` release floors, which are *when*, not *what* — so
        open- and closed-loop runs can be compared wave-for-wave
        (the t=0 differential test in tests/test_serve_queueing.py)."""
        self.trace_log = []

    @staticmethod
    def _trace_digest(kind: str, merged) -> tuple:
        h = hashlib.sha1()
        for a in (merged.kind, merged.role, merged.ms, merged.nbytes,
                  merged.lane, merged.doorbell, merged.dep, merged.dep2):
            h.update(np.ascontiguousarray(a).tobytes())
        return (kind, merged.n_verbs, merged.n_doorbells, h.hexdigest())

    # -- merged pricing ----------------------------------------------------
    def _simulate_merged(self, tagged, kind: str, arrivals=None):
        """Merge per-CS traces (``tagged`` = [(cs, trace), ...]) and price
        the shared timeline; attribute functional totals per CS.

        Closed loop (default): every wave starts its own timeline at t=0
        and ``sim_time_s`` accumulates makespans.  Open loop
        (:meth:`enable_open_loop`): the wave replays on the carried
        absolute :class:`ServerClock` timeline; ``arrivals`` (a dict
        ``cs -> per-lane arrival seconds``, aligned with that CS's trace
        lanes) turns absolute completions into per-op sojourns and the
        replay's NIC/atomic waits into queueing-delay samples.  Returns
        ``(sim, kept)`` where ``kept`` lists the CS ids actually merged
        (in lane order) — the write wave uses it to fold multi-phase
        completions back onto ops.
        """
        tagged = [(cs, t) for cs, t in tagged if t.n_verbs]
        if not tagged:
            return None, []
        for cs, t in tagged:
            self.nodes[cs].note_trace(t)
        rec = self.recorder
        if rec is not None:
            rec.set_phase(kind)
            if self.clock is None:
                # closed loop: place this wave's relative timeline at the
                # accumulated sim time (open loop is already absolute)
                rec.sync_cursor(self.counters["sim_time_s"])
        sim, merged = netsim.price_merged_phase(
            [t for _, t in tagged], self.features, self.net, self.cfg,
            clock=self.clock, recorder=rec)
        if self.trace_log is not None:
            self.trace_log.append(self._trace_digest(kind, merged))
        c = self.counters
        c["msgs"] += sim["msgs"]
        c["verbs"] += sim["verbs"]
        c["doorbells"] += sim["doorbells"]
        c["bytes"] += sim["bytes"]
        c["cas_msgs"] += sim["cas_msgs"]
        if self.clock is not None:
            # absolute timeline: the horizon is the latest completion
            c["sim_time_s"] = max(c["sim_time_s"], sim["makespan_s"])
        else:
            c["sim_time_s"] += sim["makespan_s"]
        c["merged_waves"] += 1
        if kind == "write":
            self.doorbells_write.append(sim["lane_doorbells"])
            self.write_bytes.append(sim["write_bytes"])
            if self.clock is None:
                self.latencies_write.append(sim["latency_s"])
            # open loop: write_wave folds multi-phase completions into
            # per-op sojourns itself (one sample per op, not per phase)
        elif kind == "read":
            if self.clock is None:
                self.latencies_read.append(sim["latency_s"])
            elif arrivals is not None:
                off = 0
                self.last_read_comp = {}
                for cs, t in tagged:
                    nl = t.n_lanes
                    comp = sim["latency_s"][off:off + nl]
                    self.last_read_comp[cs] = comp
                    self.latencies_read.append(comp - arrivals[cs])
                    self.queue_read.append(
                        sim["lane_queue_s"][off:off + nl])
                    off += nl
        return sim, [cs for cs, _ in tagged]

    def _maintenance(self) -> None:
        """Price the fleet's cache maintenance (fills + sweeps), merged.
        In open-loop mode the background verbs are released at the
        current horizon — maintenance generated by a wave cannot start
        before the wave was admitted."""
        tagged = []
        for i, node in enumerate(self.nodes):
            nr, sr = node.take_maintenance()
            if nr or sr:
                tagged.append((i, V.maintenance_trace(
                    nr, sr, self.cfg.n_ms, self.cfg.node_bytes,
                    self.net.small_io_bytes,
                    rows_ms=node.cache.rows_ms())))
        if self.clock is not None and tagged:
            t0 = self.counters["sim_time_s"]
            tagged = [(i, V.shift_release(t, np.zeros(t.n_lanes), t0))
                      for i, t in tagged]
        self._simulate_merged(tagged, "maint")

    # -- cluster waves -----------------------------------------------------
    def write_wave(self, keys_by_cs: Sequence, vals_by_cs=None,
                   is_delete: bool = False, max_phases: int = 8,
                   arrivals_by_cs=None, drain: bool = True) -> None:
        """One cluster write wave: every CS's batch, stacked into a single
        ``[n_cs*B]``-lane write phase per phase, priced phase-by-phase in
        one merged timeline.

        In open-loop mode ``arrivals_by_cs[i]`` gives CS *i*'s per-op
        release times (absolute seconds); each retry phase is released
        by the op's previous phase completion (``release = max(release,
        completion)``), and one sojourn/queueing sample per *op* (not
        per phase) lands in ``latencies_write`` / ``queue_write``.

        ``drain=False`` leaves the wave's half-splits *pending* in the
        shared repair queue instead of completing them — the chaos plane
        uses this to crash a memory server while GLT handovers and
        repairs are in flight (DESIGN.md §13); the B-link invariant
        keeps the tree correct until they are re-derived or replayed."""
        segs = []
        for i in range(self.n_cs):
            k = keys_by_cs[i] if i < len(keys_by_cs) else None
            if k is None or len(k) == 0:
                continue
            k = np.asarray(k, np.int32)
            if vals_by_cs is not None and vals_by_cs[i] is not None:
                v = np.asarray(vals_by_cs[i], np.int32)
            else:
                v = np.zeros(k.size, np.int32)
            segs.append((i, k, v))
        if not segs:
            return
        keys = np.concatenate([k for _, k, _ in segs])
        vals = np.concatenate([v for _, _, v in segs])
        cs_l = np.concatenate([np.full(k.size, i, np.int32)
                               for i, k, _ in segs])
        n = keys.size
        m = bucket_size(n)
        dev = self.device
        keys_j = pad_to_bucket(_as_i32(keys, dev), m)
        vals_j = pad_to_bucket(_as_i32(vals, dev), m)
        # the stacked lanes' CS ids, padded with the bucket fill (0)
        cs_j = pad_to_bucket(_as_i32(cs_l, dev), m)
        cs_np = np.pad(cs_l, (0, m - n), constant_values=-1)
        is_del = torch.full((m,), bool(is_delete), device=dev)
        active = torch.arange(m, device=dev) < n
        # write routing probes each CS's private image for its own lanes;
        # each CS routes only its own (bucket-padded) segment, so the
        # work stays O(total lanes) instead of O(n_cs * total lanes)
        route_hits = np.zeros(m, bool)
        off = 0
        for i, k, _ in segs:
            node = self.nodes[i]
            node.counters["write_ops"] += k.size
            node.counters["ops"] += k.size
            if node.cache.enabled:
                kp = pad_to_bucket(_as_i32(k, dev),
                                   bucket_size(k.size))
                h = node.cache.route_hits(self.state, kp, n_valid=k.size)
                route_hits[off:off + k.size] = h[:k.size]
            off += k.size
        phase_sds = []
        for phase_no in range(max_phases):
            self.state, done, stats, self.repair = write.write_phase(
                self.cfg, self.state, keys_j, vals_j, is_del, active,
                cs_j, self.repair)
            act_np = active.cpu().numpy()
            sd = write_stats_dict(stats, act_np, route_hits,
                                  int(self.state.height))
            phase_sds.append(sd)
            c = self.counters
            c["stacked_phases"] += 1
            c["internal_splits"] += int(stats.n_internal_splits)
            c["root_splits"] += int(stats.n_root_splits)
            self._repair_backlog = int(stats.repair_backlog)
            for i, _, _ in segs:
                self.nodes[i].note_write_phase(
                    sd, act_np & (cs_np == i),
                    first_phase=phase_no == 0, st=self.state)
            active = active & ~done
            if not bool(active.any()):
                break
        if bool(active.any()):
            raise RuntimeError("cluster write wave did not converge; "
                               "pool exhausted or max_phases too low")
        if drain:
            self.drain_repairs()
        # cross-CS conflict decomposition over the first phase's targets
        sd0 = phase_sds[0]
        leaves = [sd0["leaf"][sd0["active"] & (cs_np == i)]
                  for i, _, _ in segs]
        if sum(1 for lv in leaves if lv.size) > 1:
            self.counters["cross_cs_conflicts"] += \
                hocl.cross_cs_contention(leaves)["contended_nodes"]
        # performance plane: split each phase back into per-CS traces
        open_mode = self.clock is not None
        if open_mode:
            arr_full = np.zeros(m, np.float64)
            off = 0
            for i, k, _ in segs:
                if arrivals_by_cs is not None and \
                        arrivals_by_cs[i] is not None:
                    arr_full[off:off + k.size] = np.asarray(
                        arrivals_by_cs[i], np.float64)
                off += k.size
            op_comp = arr_full.copy()      # per-op absolute completion
            op_queue = np.zeros(m)         # per-op NIC/atomic queueing
            release = arr_full.copy()      # next phase's release floor
        for sd in phase_sds:
            masks = {i: sd["active"] & (cs_np == i) for i, _, _ in segs}
            tagged = []
            for i, _, _ in segs:
                t = netsim.transformed_write_trace(
                    dict(sd, active=masks[i]), self.features, self.net,
                    self.cfg)
                if open_mode and t.n_verbs:
                    t = V.shift_release(t, release[masks[i]])
                tagged.append((i, t))
            sim, kept = self._simulate_merged(tagged, "write")
            if open_mode and sim is not None:
                lanes = {i: t.n_lanes for i, t in tagged if t.n_verbs}
                off = 0
                for i in kept:
                    nl = lanes[i]
                    idxs = np.flatnonzero(masks[i])[:nl]
                    op_comp[idxs] = sim["latency_s"][off:off + nl]
                    op_queue[idxs] += sim["lane_queue_s"][off:off + nl]
                    off += nl
                release = np.maximum(release, op_comp)
        if open_mode:
            off = 0
            for i, k, _ in segs:
                sl = slice(off, off + k.size)
                self.latencies_write.append(op_comp[sl] - arr_full[sl])
                self.queue_write.append(op_queue[sl])
                off += k.size
        self._maintenance()

    def drain_repairs(self, max_iters: int = 16, sync_every: int = 4):
        """Complete the wave's outstanding B-link half-splits (shared
        fixed-capacity queue, fleet scope).  Mirrors
        ``ShermanIndex.drain_repairs``: the host reads the pending count
        every ``sync_every`` iterations at most.  Repair-induced splits
        stay unannounced to the private caches — a root move surfaces
        through the root-pointer check on the next image use, internal
        splits through staleness (the lazy coherence protocol)."""
        if not self._repair_backlog:
            return
        (self.state, self.repair, n_int, n_root,
         self._repair_backlog) = run_repair_drain(
            self.cfg, self.state, self.repair, max_iters, sync_every)
        self.counters["internal_splits"] += n_int
        self.counters["root_splits"] += n_root
        if self._repair_backlog:
            raise RuntimeError("cluster repair queue did not drain")

    def _shift_reads(self, tagged, arrivals_by_cs):
        """Open-loop read release: trace lanes align with the CS's input
        key order (node batches are bucket-padded, actives first), so a
        per-lane shift by that CS's arrival times is exact."""
        if self.clock is None or arrivals_by_cs is None:
            return tagged, None
        arrs, shifted = {}, []
        for i, t in tagged:
            a = np.asarray(arrivals_by_cs[i], np.float64)[:t.n_lanes]
            arrs[i] = a
            shifted.append((i, V.shift_release(t, a)))
        return shifted, arrs

    def lookup_wave(self, keys_by_cs: Sequence,
                    arrivals_by_cs=None) -> list:
        """One cluster lookup wave; returns ``(values, found)`` per CS."""
        tagged, out = [], []
        for i, node in enumerate(self.nodes):
            keys = keys_by_cs[i] if i < len(keys_by_cs) else None
            if keys is None or len(keys) == 0:
                out.append((np.zeros(0, np.int32), np.zeros(0, bool)))
                continue
            vals, found, sd = node.lookup_batch(self.state, keys)
            tagged.append((i, netsim.read_trace_from_stats(sd, self.cfg)))
            out.append((vals, found))
        tagged, arrs = self._shift_reads(tagged, arrivals_by_cs)
        self._simulate_merged(tagged, "read", arrivals=arrs)
        self._maintenance()
        return out

    def scan_wave(self, lo_by_cs: Sequence, count: int,
                  max_leaves: Optional[int] = None,
                  arrivals_by_cs=None) -> list:
        """One cluster scan wave; returns ``(keys, vals, n)`` per CS."""
        tagged, out = [], []
        for i, node in enumerate(self.nodes):
            lo = lo_by_cs[i] if i < len(lo_by_cs) else None
            if lo is None or len(lo) == 0:
                out.append(None)
                continue
            res, sd = node.scan_batch(self.state, lo, count, max_leaves)
            tagged.append((i, netsim.read_trace_from_stats(sd, self.cfg)))
            out.append(res)
        tagged, arrs = self._shift_reads(tagged, arrivals_by_cs)
        self._simulate_merged(tagged, "read", arrivals=arrs)
        self._maintenance()
        return out

    def end_round(self) -> None:
        """Close one scheduler tick: per-CS coherence sweeps, then price
        any maintenance they generated."""
        for node in self.nodes:
            node.end_round(self.state)
        self._maintenance()
        self.counters["rounds"] += 1

    # -- reporting ---------------------------------------------------------
    def node_totals(self) -> dict:
        """Sum of the per-CS functional counters."""
        keys = self.nodes[0].counters.keys()
        return {k: sum(n.counters[k] for n in self.nodes) for k in keys}

    def conservation_ok(self) -> bool:
        """Merged-timeline totals == sum of per-CS functional trace
        totals (verbs, doorbells, bytes) — the cluster invariant."""
        nt = self.node_totals()
        return (self.counters["verbs"] == nt["verbs"]
                and self.counters["doorbells"] == nt["doorbells"]
                and math.isclose(self.counters["bytes"], nt["bytes"],
                                 rel_tol=1e-9, abs_tol=1e-6))

    def combined_counters(self) -> dict:
        """One flat counter dict: merged-timeline totals + per-CS sums —
        a superset of ``ShermanIndex.counters`` so cluster runs share the
        BENCH json schema.  Wave-scope structure (stacked phases,
        repair-cascade splits) accrues on the cluster's own counters and
        is added to the per-CS sums here."""
        nt = self.node_totals()
        out = dict(self.counters)
        for k in ("phases", "write_ops", "read_ops", "retried_ops",
                  "lookup_ops", "lookup_reads", "leaf_splits",
                  "split_same_ms",
                  "handovers", "hocl_cas", "flat_cas", "cache_hits",
                  "cache_misses", "cache_stale"):
            out[k] = nt[k]          # `phases` = per-CS sum, as pre-PR-5
        for k in ("internal_splits", "root_splits"):
            out[k] = nt[k] + self.counters[k]   # + wave-scope repairs
        return out

    def throughput_mops(self) -> float:
        t = self.counters["sim_time_s"]
        n = self.node_totals()["ops"]
        return n / t / 1e6 if t else 0.0


def build_cluster(features: Features, cfg: TreeConfig, *,
                  n_clients: int, records: int, keyspace: int = 1 << 20,
                  cache_bytes: int = 64 << 20,
                  cache_levels: Optional[int] = None,
                  sync_rounds: int = 4, seed: int = 0,
                  fill: float = 0.8,
                  net: Optional[NetConfig] = None,
                  device=None) -> Cluster:
    """Load phase: bulk-load ``records`` scrambled records into the shared
    pool on ``device`` (default CUDA) and stand up the CS fleet (mirrors
    ``workloads.build_index``; the records are the reference's, drawn in
    chunks by :func:`repro_torch.workloads.engine.load_arrays`)."""
    from repro_torch.workloads.engine import load_arrays
    keys, vals = load_arrays(records, keyspace, seed, device)
    return Cluster.build(cfg, keys, vals, fill=fill, features=features,
                         net=net, n_clients=n_clients,
                         cache_bytes=cache_bytes, cache_levels=cache_levels,
                         sync_rounds=sync_rounds)


def run_cluster(cluster: Cluster, spec: WorkloadSpec, *,
                partitioned: bool = False, seed: int = 1,
                keyspace: int = 1 << 20) -> int:
    """Drive ``spec``'s op mix through the cluster in scheduler rounds.

    Each round hands every CS a ``per_cs``-lane batch from its private
    stream (op mix realized per CS via the salted remainder rotation, so
    even one-lane batches mix over rounds) and executes the waves in a
    fixed kind order (scan, read, rmw, update, delete, insert — the
    engine's order).  Returns ``(done, op_counts)``: the number of client
    ops issued and the realized per-kind mix.
    """
    streams = ClusterStreams(spec, cluster.n_cs, keyspace=keyspace,
                             partitioned=partitioned, seed=seed)
    n_cs, per_cs = cluster.n_cs, cluster.per_cs
    ops_per_round = per_cs * n_cs
    rounds = max(1, -(-spec.ops // ops_per_round))
    done = 0
    op_counts = {k: 0 for k in OP_KINDS}
    for r in range(rounds):
        counts = [spec.batch_counts(per_cs, salt=r * n_cs + cs)
                  for cs in range(n_cs)]

        def gather(kind, draw):
            return [draw(cs, counts[cs][kind]) if counts[cs][kind] else None
                    for cs in range(n_cs)]

        if any(c["scan"] for c in counts):
            cluster.scan_wave(gather("scan", streams.draw),
                              count=spec.scan_len,
                              max_leaves=max(4, spec.scan_len))
        if any(c["read"] for c in counts):
            cluster.lookup_wave(gather("read", streams.draw))
        if any(c["rmw"] for c in counts):
            keys = gather("rmw", streams.draw)
            got = cluster.lookup_wave(keys)
            vals = [((g.astype(np.int64) + 1) & VAL_MASK)
                    if k is not None else None
                    for k, (g, _) in zip(keys, got)]
            cluster.write_wave(keys, vals)
        if any(c["update"] for c in counts):
            keys = gather("update", streams.draw)
            vals = [streams.rngs[cs].integers(0, VAL_MASK, k.size)
                    if k is not None else None
                    for cs, k in enumerate(keys)]
            cluster.write_wave(keys, vals)
        if any(c["delete"] for c in counts):
            cluster.write_wave(gather("delete", streams.draw), None,
                               is_delete=True)
        if any(c["insert"] for c in counts):
            keys = gather("insert", streams.draw_insert)
            vals = [streams.rngs[cs].integers(0, VAL_MASK, k.size)
                    if k is not None else None
                    for cs, k in enumerate(keys)]
            cluster.write_wave(keys, vals)
        cluster.end_round()
        for c in counts:
            for k in OP_KINDS:
                op_counts[k] += c[k]
        done += sum(sum(c.values()) for c in counts)
    return done, {k: v for k, v in op_counts.items() if v}
