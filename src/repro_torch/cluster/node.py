"""ClusterNode — one compute server of the multi-CS cluster plane.

The PyTorch counterpart of :mod:`repro.cluster.node`.  A node owns
everything the paper gives a compute server privately:

* its **index cache** (:class:`repro_torch.core.cache.IndexCache`) — a
  private replica with its *own* staleness trajectory.  A node is never
  fed remote CSs' split outputs: it learns of remote splits lazily,
  through version/fence mismatch on its own reads or through its periodic
  sync sweeps (``IndexCache.end_round``);
* its **LLT view** — HOCL conflict grouping keys on the node's CS id, so
  local wait queues and handovers stay private even inside the
  scheduler's stacked ``[n_cs*B]``-lane write dispatch;
* its **functional counters** — per-CS op/verb/cache tallies, including
  the per-trace totals the merged simulation is conservation-checked
  against.

The write phases execute as one stacked fleet-wide dispatch owned by the
scheduler (:mod:`repro_torch.cluster.sched`).  Read batches run per node,
because each CS descends through its own cache image, padded to
power-of-two buckets (:func:`repro_torch.core.api.bucket_size`) as the
reference pads them.  Every cache image and every private cache lives on
the shared state's device; results come to the host as numpy arrays of the
reference's dtypes.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core import ops
from repro_torch.core.api import bucket_size, pad_to_bucket
from repro_torch.core.cache import IndexCache
from repro_torch.core.tree import TreeConfig, TreeState, _as_i32


class ClusterNode:
    """One compute server: private cache + LLT grouping + counters."""

    def __init__(self, cs_id: int, cfg: TreeConfig, *,
                 cache_bytes: int = 64 << 20,
                 cache_levels: Optional[int] = None,
                 cache_sync_every: int = 8,
                 cache_chase_hops: int = 4,
                 sync_rounds: int = 4, device=None):
        self.cs_id = int(cs_id)
        self.cfg = cfg
        self.cache = IndexCache(cfg, cache_bytes, levels=cache_levels,
                                chase_hops=cache_chase_hops,
                                sync_every=cache_sync_every,
                                sync_rounds=sync_rounds, device=device)
        self.counters = {
            "ops": 0, "write_ops": 0, "read_ops": 0, "retried_ops": 0,
            "phases": 0, "lookup_ops": 0, "lookup_reads": 0,
            "leaf_splits": 0, "internal_splits": 0, "root_splits": 0,
            "split_same_ms": 0, "handovers": 0, "hocl_cas": 0,
            "flat_cas": 0, "cache_hits": 0, "cache_misses": 0,
            "cache_stale": 0,
            # per-trace functional totals (pre-merge) — the conservation
            # oracle the merged simulation is checked against
            "verbs": 0, "doorbells": 0, "bytes": 0.0,
        }

    # -- trace attribution (called by the scheduler) -----------------------
    def note_trace(self, trace) -> None:
        """Accumulate one of this CS's traces' functional totals."""
        c = self.counters
        c["verbs"] += trace.n_verbs
        c["doorbells"] += trace.n_doorbells
        c["bytes"] += trace.total_bytes

    def note_write_phase(self, sd: dict, mine: np.ndarray,
                         first_phase: bool, st: TreeState) -> None:
        """Attribute one stacked write phase's per-lane structure to this
        CS (``mine`` = this node's active lanes in the stacked batch).

        Each handover-cycle head is one remote HOCL CAS; a lane at global
        node rank *r* is ``r + 1`` CAS attempts under the flat baseline;
        every non-head lane was served by a handover.  The node's own leaf
        splits feed its cache's invalidation hook; remote CSs stay
        oblivious.
        """
        k = int(mine.sum())
        if not k:
            return
        c = self.counters
        c["phases"] += 1
        if not first_phase:
            c["retried_ops"] += k
        heads = int((sd["cycle_head"] & mine).sum())
        n_leaf = int((sd["split_lane"] & mine).sum())
        c["leaf_splits"] += n_leaf
        c["split_same_ms"] += int((sd["split_same_ms"] & mine).sum())
        c["hocl_cas"] += heads
        c["flat_cas"] += int((sd["node_rank"][mine] + 1).sum())
        c["handovers"] += k - heads
        if n_leaf:
            self.cache.note_splits(n_leaf, 0, 0, st)

    # -- read path ---------------------------------------------------------
    def lookup_batch(self, st: TreeState, keys):
        """Point lookups through this CS's private cache.

        Returns ``(values, found, stats)`` where ``stats`` is the read
        trace's input dict (per-lane remote reads + target leaves, padded
        to the dispatch bucket with an ``active`` prefix mask)."""
        keys = _as_i32(keys, st.keys.device)
        n = keys.shape[0]
        m = bucket_size(n)
        kp = pad_to_bucket(keys, m)
        active = np.arange(m) < n
        c = self.counters
        if self.cache.enabled:
            res, cst = self.cache.lookup(st, kp, n_valid=n)
            hit, stale = cst["hit"][:n], cst["stale"][:n]
            c["cache_hits"] += int((hit & ~stale).sum())
            c["cache_misses"] += int((~hit).sum())
            c["cache_stale"] += int(stale.sum())
            reads = cst["remote_reads"]
            n_reads = int(reads[:n].sum())
            sd = dict(active=active,
                      cache_hit=cst["hit"] & ~cst["stale"],
                      remote_reads=reads,
                      leaf=res.leaf.cpu().numpy(),
                      height=int(st.height))
        else:
            res = ops.lookup_batch(self.cfg, st, kp)
            c["cache_misses"] += n
            n_reads = n * max(int(st.height), 1)
            sd = dict(active=active,
                      cache_hit=np.zeros(m, bool),
                      leaf=res.leaf.cpu().numpy(),
                      height=int(st.height))
        c["read_ops"] += n
        c["ops"] += n
        c["lookup_ops"] += n
        c["lookup_reads"] += n_reads
        return res.value[:n].cpu().numpy(), res.found[:n].cpu().numpy(), sd

    def scan_batch(self, st: TreeState, lo, count: int,
                   max_leaves: Optional[int] = None):
        """Range scans; the initial descent consults the private cache."""
        lo = _as_i32(lo, st.keys.device)
        n = lo.shape[0]
        m = bucket_size(n)
        lo_p = pad_to_bucket(lo, m)
        if max_leaves is None:
            max_leaves = max(4, count)
        if self.cache.enabled:
            res = ops.range_batch(self.cfg, st, lo_p, count, max_leaves,
                                  self.cache.image(st))
            hits = res.start_hit.cpu().numpy()
            self.cache.note_hits(hits[:n])
        else:
            res = ops.range_batch(self.cfg, st, lo_p, count, max_leaves)
            hits = np.zeros(m, bool)
        n_leaves = res.leaves_read.cpu().numpy()
        sd = dict(active=np.arange(m) < n, cache_hit=hits,
                  retries=np.maximum(n_leaves - 1, 0),
                  leaf=res.start_leaf.cpu().numpy(), scan=True,
                  height=int(st.height))
        c = self.counters
        c["read_ops"] += n
        c["ops"] += n
        return (res.keys[:n].cpu().numpy(), res.vals[:n].cpu().numpy(),
                res.n[:n].cpu().numpy()), sd

    # -- coherence tick ----------------------------------------------------
    def end_round(self, st: TreeState) -> None:
        """One scheduler round elapsed: run the private cache's periodic
        version sweep if due (the node's only non-lazy coherence)."""
        self.cache.end_round(st)

    def take_maintenance(self):
        """Drain the cache's un-priced fill/sweep reads (node, small)."""
        if not self.cache.enabled:
            return 0, 0
        return self.cache.take_maintenance()
