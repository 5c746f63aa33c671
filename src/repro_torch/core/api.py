"""Public API of the Sherman index, in PyTorch.

The counterpart of :mod:`repro.core.api`: ``ShermanIndex`` offers batched
insert/delete/lookup/range with the paper's full write path, plus
per-phase netsim pricing so every paper metric (throughput, latency
percentiles, doorbell depth, write bytes, retries) falls out of normal use.
Reads route through the functional CS-side index cache
(:mod:`repro_torch.core.cache`).

The index lives on one device: CUDA unless the caller asks for the CPU.

Shape discipline, kept from the reference because it sets the verb traces:

* every batch is **padded to a power-of-two bucket** (:func:`bucket_size`)
  with the padding lanes masked inactive — the bucket length is the length
  of every priced stats array;
* the repair queue has a **fixed capacity** (:data:`REPAIR_CAP`);
* where the reference donates the tree state to its jitted phases, the port
  **updates the pool in place** (:mod:`repro_torch.core.write`): the
  index's state tensors are mutated by every write.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import netsim, ops, write
from repro_torch.core.cache import IndexCache
from repro_torch.core.hocl import sum32
from repro_torch.core.netsim import FG_PLUS, SHERMAN, Features, NetConfig
from repro_torch.core.ref import OracleIndex
from repro_torch.core.tree import TreeConfig, TreeState, bulkload
from repro_torch.core.write import RepairQueue

__all__ = ["ShermanIndex", "TreeConfig", "Features", "FG_PLUS", "SHERMAN",
           "OracleIndex", "IndexCache", "REPAIR_CAP", "bucket_size",
           "pad_to_bucket"]

#: Fixed capacity of every driver-owned repair queue (a dropped separator
#: is still safe — B-link rediscovery).
REPAIR_CAP = 256

#: Smallest dispatch bucket; batches below this pad up to it.
BUCKET_MIN = 16


def bucket_size(n: int) -> int:
    """Smallest power-of-two bucket holding ``n`` lanes (>= BUCKET_MIN)."""
    return max(BUCKET_MIN, 1 << max(0, int(n) - 1).bit_length())


def pad_to_bucket(arr: torch.Tensor, m: int, fill=0) -> torch.Tensor:
    """Pad a [n, ...] batch tensor to bucket length ``m`` with ``fill``."""
    n = arr.shape[0]
    if n == m:
        return arr
    pad = torch.full((m - n,) + tuple(arr.shape[1:]), fill, dtype=arr.dtype,
                     device=arr.device)
    return torch.cat([arr, pad])


def _repair_step(cfg, st, repair):
    """One repair step; also returns the post-step pending count."""
    st, repair, ni, nr = write.run_repair(cfg, st, repair, iters=2)
    return st, repair, ni, nr, sum32(repair.valid)


def run_repair_drain(cfg, state, repair, max_iters: int = 16,
                     sync_every: int = 4):
    """Drain a repair queue with k-batched host syncs.

    Runs repair steps back-to-back, accumulating the split counters on the
    device, and checks the pending count on the host only every
    ``sync_every`` iterations.  Returns ``(state, repair, n_internal,
    n_root, backlog)`` — ``backlog`` is the pending count after the drain.
    """
    ni_acc, nr_acc, pending = [], [], None
    for it in range(max_iters):
        state, repair, ni, nr, pending = _repair_step(cfg, state, repair)
        ni_acc.append(ni)
        nr_acc.append(nr)
        # one step usually clears a write batch's handful of separators,
        # so check after the first step too, then every sync_every
        if (it == 0 or (it + 1) % sync_every == 0) and not int(pending):
            break
    return (state, repair, sum(int(x) for x in ni_acc),
            sum(int(x) for x in nr_acc), int(pending))


def write_stats_dict(stats: write.WriteStats, active, route_hits,
                     height: int) -> dict:
    """Numpy view of one write phase's per-lane structure — the verb
    plane's input (netsim.price_write_phase / verbs.write_phase_trace)."""
    host = lambda x: x.cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)
    return dict(
        active=host(active),
        leaf=host(stats.leaf),
        local_rank=host(stats.local_rank),
        node_rank=host(stats.node_rank),
        node_size=host(stats.node_size),
        cycle_head=host(stats.cycle_head),
        chain_end=host(stats.chain_end),
        split_lane=host(stats.split_mask),
        split_same_ms=host(stats.split_same_ms),
        split_new_row=host(stats.split_new_row),
        cache_hit=host(route_hits),
        height=int(height),
        hocl_remote_cas=int(stats.hocl_remote_cas),
        flat_remote_cas=int(stats.flat_remote_cas),
    )


class ShermanIndex:
    """A write-optimized ordered index over a disaggregated node pool."""

    def __init__(self, cfg: TreeConfig, state: TreeState,
                 features: Features = SHERMAN,
                 net: Optional[NetConfig] = None,
                 cache_bytes: int = 64 << 20,
                 cache_levels: Optional[int] = None,
                 cache_sync_every: int = 8,
                 cache_chase_hops: int = 4):
        self.cfg = cfg
        self.state = state
        self.device = state.keys.device
        self.features = features
        self.net = net or NetConfig()
        self.cache = IndexCache(cfg, cache_bytes, levels=cache_levels,
                                chase_hops=cache_chase_hops,
                                sync_every=cache_sync_every)
        self.counters = {
            "phases": 0, "write_ops": 0, "retried_ops": 0, "read_ops": 0,
            "leaf_splits": 0,
            "internal_splits": 0, "root_splits": 0, "split_same_ms": 0,
            "cas_msgs": 0, "handovers": 0, "msgs": 0, "bytes": 0.0,
            "sim_time_s": 0.0, "cache_hits": 0, "cache_misses": 0,
            "cache_stale": 0, "lookup_ops": 0, "lookup_reads": 0,
            "verbs": 0, "doorbells": 0, "hocl_cas": 0, "flat_cas": 0,
        }
        self.latencies_write: list[np.ndarray] = []
        self.latencies_read: list[np.ndarray] = []
        self.doorbells_write: list[np.ndarray] = []
        self.write_bytes: list[np.ndarray] = []
        self._repair = RepairQueue.empty(REPAIR_CAP, self.device)
        self._repair_backlog = 0        # host-side mirror, no device sync
        # opt-in observability plane: attach a repro_torch.obs Recorder here
        # and every priced phase captures its per-verb timeline
        self.recorder = None

    # -- constructors --------------------------------------------------
    @classmethod
    def build(cls, cfg: TreeConfig, keys, vals, fill: float = 0.8,
              device=None, **kw) -> "ShermanIndex":
        """Bulk-load ``keys``/``vals`` on ``device`` (default CUDA)."""
        return cls(cfg, bulkload(cfg, keys, vals, fill=fill, device=device),
                   **kw)

    @classmethod
    def empty(cls, cfg: TreeConfig, device=None, **kw) -> "ShermanIndex":
        return cls(cfg, bulkload(cfg, np.zeros(0), np.zeros(0),
                                 device=device), **kw)

    # -- helpers --------------------------------------------------------
    def _i32(self, x) -> torch.Tensor:
        """A batch of keys or values as int32 on the index's device."""
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=torch.int32)
        return torch.from_numpy(np.asarray(x, np.int32).copy()).to(
            self.device)

    def _cs_of(self, n: int, m: int | None = None) -> torch.Tensor:
        """Lane -> compute-server assignment (contiguous blocks).

        Block size comes from the *real* batch length ``n``; the returned
        tensor spans the dispatch bucket ``m``."""
        per = max(1, -(-n // self.cfg.n_cs))
        lane = torch.arange(m or n, dtype=torch.int32, device=self.device)
        return torch.remainder(torch.div(lane, per, rounding_mode="floor"),
                               self.cfg.n_cs)

    def _rec(self, phase: str):
        """The phase's capture target: label it and place it at the
        accumulated sim time (each closed-loop phase is its own relative
        timeline; the cursor makes the captured segments tile)."""
        r = self.recorder
        if r is not None:
            r.set_phase(phase)
            r.sync_cursor(self.counters["sim_time_s"])
        return r

    def _price_cache_maintenance(self):
        """Charge the image fills / version sweeps the cache performed
        since the last drain by replaying their MAINT/SYNC verbs."""
        node_rd, small_rd = self.cache.take_maintenance()
        if not (node_rd or small_rd):
            return
        sim = netsim.price_maintenance(node_rd, small_rd, self.features,
                                       self.net, self.cfg,
                                       rows_ms=self.cache.rows_ms(),
                                       recorder=self._rec("maint"))
        self._charge(sim)

    def _charge(self, priced: dict):
        """Accumulate one simulated trace's totals into the counters."""
        c = self.counters
        c["msgs"] += priced["msgs"]
        c["verbs"] += priced["verbs"]
        c["doorbells"] += priced["doorbells"]
        c["bytes"] += priced["bytes"]
        c["sim_time_s"] += priced["makespan_s"]

    def _price_write(self, stats: write.WriteStats, active, hits):
        sd = write_stats_dict(stats, active, hits, int(self.state.height))
        priced = netsim.price_write_phase(sd, self.features, self.net,
                                          self.cfg,
                                          recorder=self._rec("write"))
        self.latencies_write.append(priced["latency_s"])
        self.doorbells_write.append(priced["lane_doorbells"])
        self.write_bytes.append(priced["write_bytes"])
        self._charge(priced)
        c = self.counters
        c["phases"] += 1
        c["cas_msgs"] += priced["cas_msgs"]
        c["hocl_cas"] += sd["hocl_remote_cas"]
        c["flat_cas"] += sd["flat_remote_cas"]
        c["leaf_splits"] += int(stats.n_leaf_splits)
        c["internal_splits"] += int(stats.n_internal_splits)
        c["root_splits"] += int(stats.n_root_splits)
        c["split_same_ms"] += int(stats.n_split_same_ms)
        c["handovers"] += int(stats.handovers)

    # -- write ops -------------------------------------------------------
    def _write(self, keys, vals, is_delete, max_phases: int = 8):
        keys = self._i32(keys)
        n = keys.shape[0]
        if n == 0:
            return
        m = bucket_size(n)
        vals = self._i32(vals) if vals is not None else \
            torch.zeros((n,), dtype=torch.int32, device=self.device)
        keys = pad_to_bucket(keys, m)
        vals = pad_to_bucket(vals, m)
        is_del = torch.full((m,), bool(is_delete), device=self.device)
        cs = self._cs_of(n, m)
        active = torch.arange(m, device=self.device) < n
        # the writes' traversal leg routes through the CS cache like a read;
        # probe once per batch (retry phases reuse the same routing)
        if self.cache.enabled:
            route_hits = self.cache.route_hits(self.state, keys, n_valid=n)
        else:
            route_hits = np.zeros(m, bool)
        # each client op counts once; lanes resubmitted by later phases
        # are tracked separately so throughput isn't inflated
        self.counters["write_ops"] += n
        for phase_no in range(max_phases):
            self.state, done, stats, self._repair = write.write_phase(
                self.cfg, self.state, keys, vals, is_del, active, cs,
                self._repair)
            active_np = active.cpu().numpy()
            self._price_write(stats, active_np, route_hits)
            if phase_no:
                self.counters["retried_ops"] += int(active_np.sum())
            # invalidation hook: feed this phase's split outputs to the cache
            self.cache.note_splits(int(stats.n_leaf_splits),
                                   int(stats.n_internal_splits),
                                   int(stats.n_root_splits), self.state)
            self._repair_backlog = int(stats.repair_backlog)
            active = active & ~done
            if not bool(active.any()):
                break
        if bool(active.any()):
            raise RuntimeError("write batch did not converge; "
                               "pool exhausted or max_phases too low")
        self.drain_repairs()
        self._price_cache_maintenance()

    def drain_repairs(self, max_iters: int = 16, sync_every: int = 4):
        """Complete any outstanding B-link half-splits (skipped when the
        last write phase reported an empty queue)."""
        if not self._repair_backlog:
            return
        (self.state, self._repair, n_int, n_root,
         self._repair_backlog) = run_repair_drain(
            self.cfg, self.state, self._repair, max_iters, sync_every)
        self.counters["internal_splits"] += n_int
        self.counters["root_splits"] += n_root
        if n_int or n_root:
            self.cache.note_splits(0, n_int, n_root, self.state)
        if self._repair_backlog:
            raise RuntimeError("repair queue did not drain")

    def insert(self, keys, vals):
        """Insert or update (the paper's combined 'insert')."""
        self._write(keys, vals, False)

    def delete(self, keys):
        self._write(keys, None, True)

    # -- read ops ----------------------------------------------------------
    def lookup(self, keys):
        keys = self._i32(keys)
        n = keys.shape[0]
        m = bucket_size(n)
        kp = pad_to_bucket(keys, m)
        c = self.counters
        active = np.arange(m) < n
        if self.cache.enabled:
            res, cst = self.cache.lookup(self.state, kp, n_valid=n)
            hit, stale = cst["hit"][:n], cst["stale"][:n]
            c["cache_hits"] += int((hit & ~stale).sum())
            c["cache_misses"] += int((~hit).sum())
            c["cache_stale"] += int(stale.sum())
            sd = dict(active=active,
                      cache_hit=cst["hit"] & ~cst["stale"],
                      remote_reads=cst["remote_reads"],
                      leaf=res.leaf.cpu().numpy(),
                      height=int(self.state.height))
        else:
            res = ops.lookup_batch(self.cfg, self.state, kp)
            c["cache_misses"] += n
            sd = dict(active=active,
                      cache_hit=np.zeros(m, bool),
                      leaf=res.leaf.cpu().numpy(),
                      height=int(self.state.height))
        priced = netsim.price_read_phase(sd, self.features, self.net,
                                         self.cfg,
                                         recorder=self._rec("read"))
        self.latencies_read.append(priced["latency_s"])
        c["read_ops"] += n
        c["lookup_ops"] += n
        c["lookup_reads"] += int(np.asarray(priced["lane_doorbells"]).sum())
        self._charge(priced)
        self._price_cache_maintenance()
        return res.value[:n].cpu().numpy(), res.found[:n].cpu().numpy()

    def range(self, lo, count: int, max_leaves: Optional[int] = None):
        lo = self._i32(lo)
        n = lo.shape[0]
        m = bucket_size(n)
        lo_p = pad_to_bucket(lo, m)
        if max_leaves is None:
            # Leaves may be sparse (deletes don't merge — §5.3 notes the same
            # partial-occupancy artifact), so scan generously.
            max_leaves = max(4, count)
        # the scan's initial descent consults the CS cache like a lookup
        if self.cache.enabled:
            res = ops.range_batch(self.cfg, self.state, lo_p, count,
                                  max_leaves, self.cache.image(self.state))
            hits = res.start_hit.cpu().numpy()
            self.cache.note_hits(hits[:n])
        else:
            res = ops.range_batch(self.cfg, self.state, lo_p, count,
                                  max_leaves)
            hits = np.zeros(m, bool)
        n_leaves = res.leaves_read.cpu().numpy()
        priced = netsim.price_read_phase(
            dict(active=np.arange(m) < n, cache_hit=hits,
                 retries=np.maximum(n_leaves - 1, 0),  # empty scans read 0
                 leaf=res.start_leaf.cpu().numpy(), scan=True,
                 height=int(self.state.height)),
            self.features, self.net, self.cfg,
            recorder=self._rec("scan"))
        self.latencies_read.append(priced["latency_s"])
        self.counters["read_ops"] += n
        self._charge(priced)
        self._price_cache_maintenance()
        return (res.keys[:n].cpu().numpy(), res.vals[:n].cpu().numpy(),
                res.n[:n].cpu().numpy())

    # -- reporting ---------------------------------------------------------
    def latency_percentiles(self, kind: str = "write"):
        arrs = self.latencies_write if kind == "write" else \
            self.latencies_read
        if not arrs:
            return {}
        lat = np.concatenate(arrs)
        return {p: float(np.percentile(lat, p)) * 1e6
                for p in (50, 90, 99)}   # µs

    def throughput_mops(self) -> float:
        """Ops per simulated second; 0.0 before any op has been priced."""
        t = self.counters["sim_time_s"]
        n = self.counters["write_ops"] + self.counters["read_ops"]
        return n / t / 1e6 if t else 0.0
