"""Batched write path: insert / update / delete with B-link node splits.

The PyTorch counterpart of :mod:`repro.core.write`, faithful to the paper's
Fig. 7 flow adapted to phase-synchronous SIMD execution (DESIGN.md §8):

* one batch is one wave of concurrent client ops; lane order is arrival
  order;
* lock/contention structure is computed by :mod:`repro_torch.core.hocl`
  and priced by netsim — data application itself is deterministic;
* without a split, an op touches exactly one entry and bumps its FEV/REV;
* splits sort the (unsorted) leaf, move the upper half to a freshly
  allocated sibling, bump FNV/RNV and write back whole nodes;
* separator insertion into parents may cascade; unfinished cascades are
  returned as a *repair queue* completed in later phases (B-link
  half-splits).

**The pool is updated in place.**  Every scatter is an ``index_put_`` into
the state's tensors — the counterpart of the reference's donated buffers:
at a deployment size a functional copy of the pool per scatter is
impossible.  The returned state shares those tensors; a caller that needs
the pre-state keeps a :func:`repro_torch.core.tree.clone_state`.  Masked
lanes write the park row's own old value back, so scatters with repeated
indices stay deterministic.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import hocl
from repro_torch.core.hocl import (cumsum32, inverse_perm, segment_min,
                                   segment_sum, stable_argsort, sum32)
from repro_torch.core.ops import first_true, take, traverse
from repro_torch.core.tree import (EMPTY_KEY, KEY_MIN, NULL_PTR, TreeConfig,
                                   TreeState, field_dict,
                                   tensors_from_numpy)
from repro_torch.device import resolve_device

INT_MAX = 2**31 - 1
I32 = torch.int32


# --------------------------------------------------------------------------
# small masked-scatter helpers (in place; duplicate writes on the park row
# all carry identical values, so the scatter stays deterministic)
# --------------------------------------------------------------------------

def _park(cfg: TreeConfig, idx: torch.Tensor, do: torch.Tensor
          ) -> torch.Tensor:
    return torch.where(do, idx.to(I32), cfg.park_row).long()


def _as(val, arr: torch.Tensor):
    """``val`` in ``arr``'s dtype; a Python scalar stays one (no
    host-to-device copy), and ``torch.where`` keeps ``arr``'s dtype."""
    return val.to(arr.dtype) if isinstance(val, torch.Tensor) else val


def _scatter_entry(cfg, arr, row, col, val, do):
    """arr[row, col] = val where do; parked lanes rewrite the park value."""
    r = _park(cfg, row, do)
    c = torch.where(do, col.to(I32), 0).long()
    old = arr[r, c]
    arr.index_put_((r, c), torch.where(do, _as(val, arr), old))
    return arr


def _scatter_row1(cfg, arr, row, val, do):
    """arr[row] = val (per-node scalar field)."""
    r = _park(cfg, row, do)
    old = arr[r]
    arr.index_put_((r,), torch.where(do, _as(val, arr), old))
    return arr


def _scatter_rowF(cfg, arr, row, val, do):
    """arr[row, :] = val[lane, :] (whole-node row write)."""
    r = _park(cfg, row, do)
    old = arr[r]
    arr.index_put_((r,), torch.where(do[:, None], _as(val, arr), old))
    return arr


def _bump_entry_version(cfg, st: TreeState, row, col, do) -> TreeState:
    r = _park(cfg, row, do)
    c = torch.where(do, col.to(I32), 0).long()
    _scatter_entry(cfg, st.fev, row, col, (st.fev[r, c] + 1) % 16, do)
    _scatter_entry(cfg, st.rev, row, col, (st.rev[r, c] + 1) % 16, do)
    return st


def _bump_node_version(cfg, st: TreeState, row, do) -> TreeState:
    r = _park(cfg, row, do)
    _scatter_row1(cfg, st.fnv, r, (st.fnv[r] + 1) % 16, do)
    _scatter_row1(cfg, st.rnv, r, (st.rnv[r] + 1) % 16, do)
    return st


def _rank_by(node_key: torch.Tensor, active: torch.Tensor,
             sentinel_base: int):
    """FIFO rank of each active lane within its (node_key) group."""
    b = node_key.shape[0]
    lane = torch.arange(b, dtype=I32, device=node_key.device)
    parked = torch.where(active, node_key.to(I32), sentinel_base + lane)
    perm = stable_argsort(parked)        # lexsort((lane, parked))
    inv = inverse_perm(perm).long()
    s = parked[perm]
    newg = s != torch.cat([torch.full((1,), -7, dtype=I32,
                                      device=s.device), s[:-1]])
    gid = cumsum32(newg) - 1
    start = segment_min(lane, gid, b)
    rank_sorted = lane - start[gid.long()]
    return rank_sorted[inv], newg[inv]


# --------------------------------------------------------------------------
# phase statistics
# --------------------------------------------------------------------------

class WriteStats(NamedTuple):
    """Structural counters for one write phase (netsim inputs).

    Per-lane tensors have batch shape [B]; scalars are 0-d.
    """
    applied_update: torch.Tensor     # [B] entry-granular update applied
    applied_delete: torch.Tensor     # [B]
    applied_insert: torch.Tensor     # [B]
    miss_delete: torch.Tensor        # [B] delete of absent key (no write)
    superseded: torch.Tensor         # [B] op overwritten by later lane
    deferred: torch.Tensor           # [B] must retry next phase
    leaf: torch.Tensor               # [B] target leaf (cache accounting)
    hops: torch.Tensor               # [B] traversal descents
    local_size: torch.Tensor         # [B] HOCL local group size
    local_rank: torch.Tensor         # [B] FIFO rank inside the local group
    node_size: torch.Tensor          # [B] per-leaf conflict group size
    node_rank: torch.Tensor          # [B] FIFO rank among all ops on leaf
    cs_rank: torch.Tensor            # [B] serialization rank of CS group
    lock_cycles: torch.Tensor        # [B] remote lock cycles of own group
    local_head: torch.Tensor         # [B] head of local group
    cycle_head: torch.Tensor         # [B] lane issues the remote LOCK CAS
    chain_end: torch.Tensor          # [B] lane issues the remote UNLOCK
    split_mask: torch.Tensor         # [B] lane performed a leaf split
    split_same_ms: torch.Tensor      # [B] sibling landed on the same MS
    split_new_row: torch.Tensor      # [B] sibling row (park_row if none)
    n_leaf_splits: torch.Tensor      # []
    n_internal_splits: torch.Tensor  # []
    n_root_splits: torch.Tensor      # []
    n_split_same_ms: torch.Tensor    # [] 3-way command combination (§4.5)
    hocl_remote_cas: torch.Tensor    # []
    flat_remote_cas: torch.Tensor    # [] no-hierarchy baseline CAS count
    handovers: torch.Tensor          # []
    repair_backlog: torch.Tensor     # [] separators left in the queue


class RepairQueue(NamedTuple):
    """Deferred separator insertions (B-link half-splits to complete)."""
    sep: torch.Tensor       # [Q] separator key
    child: torch.Tensor     # [Q] right node to link
    level: torch.Tensor     # [Q] level of the split node (parent: level+1)
    valid: torch.Tensor     # [Q] bool

    @staticmethod
    def empty(q: int, device=None) -> "RepairQueue":
        dev = resolve_device(device)
        return RepairQueue(
            sep=torch.full((q,), EMPTY_KEY, dtype=I32, device=dev),
            child=torch.full((q,), NULL_PTR, dtype=I32, device=dev),
            level=torch.zeros((q,), dtype=I32, device=dev),
            valid=torch.zeros((q,), dtype=torch.bool, device=dev))


REPAIR_DTYPES = dict(sep=torch.int32, child=torch.int32, level=torch.int32,
                     valid=torch.bool)


def repair_from_numpy(arrays, device=None) -> RepairQueue:
    """A :class:`RepairQueue` from numpy arrays of the reference's dtypes."""
    fields = field_dict(arrays, RepairQueue._fields)
    return RepairQueue(**tensors_from_numpy(fields, REPAIR_DTYPES,
                                            resolve_device(device)))


def repair_to_numpy(pend: RepairQueue) -> RepairQueue:
    return RepairQueue(*[x.cpu().numpy() for x in pend])


def _enqueue_pending(pend: RepairQueue, sep: torch.Tensor,
                     child: torch.Tensor, level: torch.Tensor,
                     did: torch.Tensor) -> RepairQueue:
    """Insert the ``did`` lanes' separators into the queue's free slots.

    The r-th new entry (by lane order) lands in the r-th free slot;
    entries beyond the free capacity are dropped, which is safe under the
    B-link invariant — the half-split is rediscovered by a later
    traversal.
    """
    q = pend.sep.shape[0]
    dev = pend.sep.device
    free = ~pend.valid
    new_rank, _ = _rank_by(torch.zeros_like(sep), did, 1)
    cumfree = cumsum32(free) - free.to(I32)
    # index of the r-th free slot: first slot with cumfree == r
    slot_of_rank = segment_min(
        torch.arange(q, dtype=I32, device=dev),
        torch.where(free, cumfree, q), q + 1)[:q]
    can = did & (new_rank < sum32(free))
    tgt = torch.where(can, slot_of_rank[torch.clamp(new_rank, max=q - 1)
                                        .long()], q).long()

    def put(a, v):
        # write into slot q + a spare slot that absorbs dropped lanes
        out = torch.cat([a, torch.zeros((1,), dtype=a.dtype, device=dev)])
        out.index_put_((tgt,), torch.where(can, v.to(a.dtype),
                                           torch.zeros((), dtype=a.dtype,
                                                       device=dev)))
        return out[:q]

    return RepairQueue(sep=put(pend.sep, sep), child=put(pend.child, child),
                       level=put(pend.level, level),
                       valid=put(pend.valid, can))


# --------------------------------------------------------------------------
# entry-granular application (the common, split-free path)
# --------------------------------------------------------------------------

def _apply_updates_deletes(cfg, st, leaf, slot, vals, upd, dele):
    do = upd | dele
    _scatter_entry(cfg, st.vals, leaf, slot, vals, upd)
    _scatter_entry(cfg, st.keys, leaf, slot, EMPTY_KEY, dele)
    return _bump_entry_version(cfg, st, leaf, slot, do)


def _apply_inserts(cfg, st, leaf, keys, vals, ins):
    """Assign each new key a free slot of its leaf; overflows are returned."""
    rank, _ = _rank_by(leaf, ins, cfg.n_nodes)
    lk = st.keys[leaf]                               # post-update snapshot
    free = lk == EMPTY_KEY
    nfree = sum32(free, dim=1)
    fits = ins & (rank < nfree)
    cum = cumsum32(free, dim=1)
    hit = free & (cum == (rank + 1)[:, None])
    slot = first_true(hit, dim=1).to(I32)
    _scatter_entry(cfg, st.keys, leaf, slot, keys, fits)
    _scatter_entry(cfg, st.vals, leaf, slot, vals, fits)
    st = _bump_entry_version(cfg, st, leaf, slot, fits)
    return st, fits, ins & ~fits


# --------------------------------------------------------------------------
# node split (generic over leaf / internal nodes)
# --------------------------------------------------------------------------

def _split_nodes(cfg, st: TreeState, node: torch.Tensor, rep: torch.Tensor):
    """Split ``node`` for every lane where ``rep`` (one lane per node).

    Returns (state, sep, new_row, did_split, same_ms).  The split sets the
    sibling pointer together with the content move, so the tree is a valid
    B-link structure even before the parent learns about ``new_row``.
    """
    b = node.shape[0]
    f = cfg.fanout
    dev = node.device
    nk = st.keys[node]
    nv = st.vals[node]
    occupied = nk != EMPTY_KEY
    cnt = sum32(occupied, dim=1)
    # a rep only splits a genuinely full-ish node (>= 2 entries)
    do = rep & (cnt >= 2)

    skey = torch.where(occupied, nk, INT_MAX)
    order = torch.sort(skey, dim=1, stable=True).indices
    sk = torch.gather(nk, 1, order)                  # sorted, EMPTY last
    sv = torch.gather(nv, 1, order)
    keep = torch.div(cnt + 1, 2, rounding_mode="floor")  # left: ceil half
    sep = take(sk, keep)

    # ---- allocate sibling rows (two-stage allocator, paper §4.2.4) ----
    rep_rank = cumsum32(do) - 1
    ms = torch.remainder(st.alloc_rr + rep_rank, cfg.n_ms).to(I32)
    off, _ = _rank_by(ms, do, cfg.n_ms)
    new_local = st.alloc_next[ms.long()] + off
    has_room = new_local < cfg.alloc_cap
    do = do & has_room
    new_row = torch.where(do, ms * cfg.nodes_per_ms + new_local,
                          cfg.park_row).to(I32)
    n_alloc = segment_sum(do.to(I32), ms, cfg.n_ms)
    st = st._replace(alloc_next=st.alloc_next + n_alloc,
                     alloc_rr=st.alloc_rr + sum32(do))

    # ---- write the new (right) node ----
    idx = torch.arange(f, dtype=I32, device=dev)[None, :]
    right_src = torch.clamp(keep[:, None] + idx, max=f - 1).long()
    in_right = (keep[:, None] + idx) < cnt[:, None]
    right_k = torch.where(in_right, torch.gather(sk, 1, right_src), EMPTY_KEY)
    right_v = torch.where(in_right, torch.gather(sv, 1, right_src), NULL_PTR)
    level_src = st.level[node]
    fence_hi_src = st.fence_hi[node]
    sibling_src = st.sibling[node]
    _scatter_rowF(cfg, st.keys, new_row, right_k, do)
    _scatter_rowF(cfg, st.vals, new_row, right_v, do)
    _scatter_rowF(cfg, st.fev, new_row, 0, do)
    _scatter_rowF(cfg, st.rev, new_row, 0, do)
    _scatter_row1(cfg, st.fnv, new_row, 0, do)
    _scatter_row1(cfg, st.rnv, new_row, 0, do)
    _scatter_row1(cfg, st.level, new_row, level_src, do)
    _scatter_row1(cfg, st.fence_lo, new_row, sep, do)
    _scatter_row1(cfg, st.fence_hi, new_row, fence_hi_src, do)
    _scatter_row1(cfg, st.sibling, new_row, sibling_src, do)
    _scatter_row1(cfg, st.free_bit, new_row, False, do)

    # ---- shrink the old (left) node; in place, then bump FNV/RNV ----
    left_keep = occupied & (nk < sep[:, None])
    left_k = torch.where(left_keep, nk, EMPTY_KEY)
    _scatter_rowF(cfg, st.keys, node, left_k, do)
    _scatter_row1(cfg, st.fence_hi, node, sep, do)
    _scatter_row1(cfg, st.sibling, node, new_row, do)
    st = _bump_node_version(cfg, st, node, do)

    same_ms = do & (cfg.ms_of(new_row) == cfg.ms_of(node.to(I32)))
    return st, sep, new_row, do, same_ms


# --------------------------------------------------------------------------
# separator insertion into (sorted) internal nodes, with cascade
# --------------------------------------------------------------------------

def _internal_insert_once(cfg, st: TreeState, parent, sep, child, sel):
    """One sorted insert per distinct parent. Returns (st, ok, full)."""
    f = cfg.fanout
    dev = parent.device
    nk = st.keys[parent]
    nv = st.vals[parent]
    valid = nk != EMPTY_KEY
    cnt = sum32(valid, dim=1)
    dup = (valid & (nk == sep[:, None])).any(dim=1)   # already repaired
    fits = sel & (cnt < f) & ~dup
    pos = sum32(valid & (nk < sep[:, None]), dim=1)
    idx = torch.arange(f, dtype=I32, device=dev)[None, :]
    shift_src = torch.clamp(torch.arange(f, device=dev) - 1, min=0)
    k_shift = nk[:, shift_src]
    v_shift = nv[:, shift_src]
    newk = torch.where(idx == pos[:, None], sep[:, None],
                       torch.where(idx > pos[:, None], k_shift, nk))
    newv = torch.where(idx == pos[:, None], child[:, None],
                       torch.where(idx > pos[:, None], v_shift, nv))
    _scatter_rowF(cfg, st.keys, parent, newk, fits)
    _scatter_rowF(cfg, st.vals, parent, newv, fits)
    st = _bump_node_version(cfg, st, parent, fits)
    return st, fits | (sel & dup), sel & (cnt >= f) & ~dup


def _root_split(cfg, st: TreeState, pend: RepairQueue):
    """Create a new root for (at most one) pending separator whose split
    node *was* the root."""
    dev = pend.sep.device
    lvl_arr = pend.level + 1
    tr = traverse(cfg, st, torch.clamp(pend.sep, min=KEY_MIN),
                  stop_level_arr=lvl_arr)
    no_parent = pend.valid & (st.level[tr.leaf].to(I32) != lvl_arr)
    pick = first_true(no_parent)                      # lowest lane wins
    b = pend.sep.shape[0]
    is_pick = (torch.arange(b, device=dev) == pick) & no_parent

    # allocate the new root on the round-robin MS
    ms = torch.remainder(st.alloc_rr, cfg.n_ms).long()
    room = st.alloc_next[ms] < cfg.alloc_cap
    do_lane = is_pick & room
    do = do_lane.any()
    new_root = torch.where(do, ms.to(I32) * cfg.nodes_per_ms
                           + st.alloc_next[ms], cfg.park_row).to(I32)
    f = cfg.fanout
    rk = torch.full((b, f), EMPTY_KEY, dtype=I32, device=dev)
    rk[:, 0] = KEY_MIN
    rk[:, 1] = pend.sep
    rv = torch.full((b, f), NULL_PTR, dtype=I32, device=dev)
    rv[:, 0] = st.root
    rv[:, 1] = pend.child
    row = torch.where(do_lane, new_root, cfg.park_row)
    _scatter_rowF(cfg, st.keys, row, rk, do_lane)
    _scatter_rowF(cfg, st.vals, row, rv, do_lane)
    _scatter_row1(cfg, st.level, row, pend.level + 1, do_lane)
    _scatter_row1(cfg, st.fence_lo, row, KEY_MIN, do_lane)
    _scatter_row1(cfg, st.fence_hi, row, INT_MAX, do_lane)
    one = do.to(I32)
    st = st._replace(
        alloc_next=st.alloc_next.index_add(0, ms.reshape(1),
                                           one.reshape(1)),
        alloc_rr=st.alloc_rr + one,
        root=torch.where(do, new_root, st.root),
        height=st.height + one,
    )
    return st, pend._replace(valid=pend.valid & ~do_lane), one


def run_repair(cfg, st: TreeState, pend: RepairQueue, iters: int = 2):
    """Complete half-splits: push pending separators into parents.

    Each iteration handles at most one root split and one separator per
    parent, may split full parents (emitting new pending entries at the
    next level), and leaves the remainder in the queue — safe under
    B-link semantics.
    """
    zero = torch.zeros((), dtype=I32, device=pend.sep.device)
    n_internal, n_root = zero, zero
    for _ in range(iters):
        st, pend, rs = _root_split(cfg, st, pend)
        n_root = n_root + rs
        tr = traverse(cfg, st, torch.clamp(pend.sep, min=KEY_MIN),
                      stop_level_arr=pend.level + 1)
        parent = tr.leaf
        ok_level = st.level[parent].to(I32) == pend.level + 1
        rank, _ = _rank_by(parent, pend.valid & ok_level, cfg.n_nodes)
        sel = pend.valid & ok_level & (rank == 0)
        st, done, full = _internal_insert_once(cfg, st, parent, pend.sep,
                                               pend.child, sel)
        pend = pend._replace(valid=pend.valid & ~done)
        # split the full parents; their separators enter the queue in the
        # slots of lanes that just completed (compaction via free slots)
        st, psep, pchild, did, _ = _split_nodes(cfg, st, parent, full)
        n_internal = n_internal + sum32(did)
        pend = _enqueue_pending(pend, psep, pchild,
                                st.level[parent].to(I32), did)
    return st, pend, n_internal, n_root


# --------------------------------------------------------------------------
# the full write phase
# --------------------------------------------------------------------------

def write_phase(cfg: TreeConfig, st: TreeState, keys, vals, is_delete,
                active, cs, repair: RepairQueue | None = None,
                split_rounds: int = 2, repair_iters: int = 2):
    """Apply one batch of write ops. Returns (state, done, stats, repair).

    ``done[i]`` False means lane i must be resubmitted (leaf still
    overflowing after ``split_rounds``, or allocator backpressure).  The
    state's pool tensors are updated in place.
    """
    b = keys.shape[0]
    dev = keys.device
    lane = torch.arange(b, dtype=I32, device=dev)
    if repair is None:
        repair = RepairQueue.empty(b, dev)

    # -- intra-batch dedupe: last op per key wins (DESIGN.md §8) --
    parked_key = torch.where(active, keys, -10 - lane)
    perm = stable_argsort(parked_key)        # lexsort((lane, parked_key))
    inv = inverse_perm(perm).long()
    ks = parked_key[perm]
    nxt = torch.cat([ks[1:], torch.full((1,), -7, dtype=I32, device=dev)])
    last_of_key = (ks != nxt)[inv]
    act = active & last_of_key
    superseded = active & ~last_of_key

    # -- route + conflict groups (lock plane); groups span every active
    # lane (pre-dedupe): every client op contends for the leaf lock --
    tr = traverse(cfg, st, keys)
    groups = hocl.group_by_node(cfg, tr.leaf, cs, active)
    lock_stats = hocl.lock_phase_stats(cfg, groups, active)

    # -- classify against the leaf image --
    lk = st.keys[tr.leaf]
    eq = lk == keys[:, None]
    found = eq.any(dim=1)
    slot = first_true(eq, dim=1).to(I32)
    upd = act & found & ~is_delete
    dele = act & found & is_delete
    miss_del = act & ~found & is_delete
    ins = act & ~found & ~is_delete

    st = _apply_updates_deletes(cfg, st, tr.leaf, slot, vals, upd, dele)
    st, ins_done, ins_defer = _apply_inserts(cfg, st, tr.leaf, keys, vals,
                                             ins)

    zero = torch.zeros((), dtype=I32, device=dev)
    n_leaf_splits, n_same_ms, n_internal, n_root = zero, zero, zero, zero
    split_mask = torch.zeros((b,), dtype=torch.bool, device=dev)
    split_same = torch.zeros((b,), dtype=torch.bool, device=dev)
    split_row = torch.full((b,), cfg.park_row, dtype=I32, device=dev)

    # -- split rounds for overflowing leaves --
    for _ in range(split_rounds):
        tr2 = traverse(cfg, st, keys)
        rank0, _ = _rank_by(tr2.leaf, ins_defer, cfg.n_nodes)
        rep = ins_defer & (rank0 == 0)
        st, sep, new_row, did, same = _split_nodes(cfg, st, tr2.leaf, rep)
        n_leaf_splits = n_leaf_splits + sum32(did)
        n_same_ms = n_same_ms + sum32(same)
        split_mask = split_mask | did
        split_same = split_same | same
        split_row = torch.where(did, new_row, split_row)
        # enqueue separators in the repair queue (free slots)
        repair = _enqueue_pending(repair, sep, new_row,
                                  st.level[new_row].to(I32), did)
        st, repair, ni, nr = run_repair(cfg, st, repair, iters=repair_iters)
        n_internal = n_internal + ni
        n_root = n_root + nr
        # retry the deferred inserts after the splits
        tr3 = traverse(cfg, st, keys)
        st, done2, ins_defer = _apply_inserts(cfg, st, tr3.leaf, keys, vals,
                                              ins_defer)
        ins_done = ins_done | done2

    done = (upd | dele | miss_del | ins_done | superseded | ~active)
    stats = WriteStats(
        applied_update=upd, applied_delete=dele,
        applied_insert=ins_done, miss_delete=miss_del,
        superseded=superseded, deferred=active & ~done,
        leaf=tr.leaf, hops=tr.hops,
        local_size=groups.local_size, local_rank=groups.local_rank,
        node_size=groups.node_size, node_rank=groups.node_rank,
        cs_rank=groups.cs_rank, lock_cycles=groups.lock_cycles,
        local_head=groups.local_head,
        cycle_head=groups.cycle_head, chain_end=groups.chain_end,
        split_mask=split_mask,
        split_same_ms=split_same, split_new_row=split_row,
        n_leaf_splits=n_leaf_splits, n_internal_splits=n_internal,
        n_root_splits=n_root, n_split_same_ms=n_same_ms,
        hocl_remote_cas=lock_stats["hocl_remote_cas"],
        flat_remote_cas=lock_stats["flat_remote_cas"],
        handovers=lock_stats["handovers"],
        repair_backlog=sum32(repair.valid),
    )
    return st, done, stats, repair
