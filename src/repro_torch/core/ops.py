"""Batched read-path operations: traversal, lookup, range query.

The PyTorch counterpart of :mod:`repro.core.ops`.  Reads are lock-free
(paper §4.2.2): a reader fetches node images with gathers and validates
them with the two-level version protocol of Fig. 9 — node-level versions
(FNV/RNV) guard whole-node consistency, entry-level versions (FEV/REV)
guard each key/value pair.  The reference's ``lax.scan`` loops become
Python loops over the static bounds, with the visited path stacked at the
end.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.tree import (EMPTY_KEY, KEY_MAX, NULL_PTR, TreeConfig,
                                   TreeState)

I32 = torch.int32


class TraceB(NamedTuple):
    """Traversal result: target nodes plus the visited path (for parent
    lookup during splits and for netsim cache accounting)."""
    leaf: torch.Tensor          # [B] node id at stop level
    path: torch.Tensor          # [max_height, B] node ids visited
    path_level: torch.Tensor    # [max_height, B] level of each visited node
    hops: torch.Tensor          # [B] number of distinct descents (netsim)


def first_true(mask: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Index of the first True along ``dim`` (0 when none) — ``argmax``
    over a bool array, which torch only takes as integers."""
    return torch.argmax(mask.to(torch.int8), dim=dim)


def take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a[i, idx[i]]`` for a [B, F] ``a`` (``take_along_axis``)."""
    return torch.gather(a, 1, idx.long()[:, None])[:, 0]


def _descend_once(st: TreeState, node: torch.Tensor, qkeys: torch.Tensor,
                  stop_level: torch.Tensor, chase_hops: int) -> torch.Tensor:
    """One traversal step: bounded B-link sibling chase, then one descent."""
    for _ in range(chase_hops):
        fh = st.fence_hi[node]
        sib = st.sibling[node]
        chase = (qkeys >= fh) & (sib != NULL_PTR)
        node = torch.where(chase, sib, node)
    lv = st.level[node].to(I32)
    nk = st.keys[node]                       # [B, F]
    nv = st.vals[node]
    valid = nk != EMPTY_KEY
    le = valid & (nk <= qkeys[:, None])
    j = torch.clamp(le.sum(dim=1, dtype=I32) - 1, min=0)
    child = take(nv, j)
    return torch.where(lv > stop_level, child, node)


def traverse(cfg: TreeConfig, st: TreeState, qkeys: torch.Tensor,
             stop_level: int = 0, start: torch.Tensor | None = None,
             stop_level_arr: torch.Tensor | None = None,
             chase_hops: int = 2) -> TraceB:
    """Route each query key to its node at ``stop_level`` (0 = leaf).

    ``stop_level_arr`` gives a per-lane stop level (used by the split-repair
    cascade, where each pending separator targets a different level).
    """
    b = qkeys.shape[0]
    node = st.root.to(I32).expand(b).clone()
    if start is not None:
        node = torch.where(start != NULL_PTR, start, node)
    stop = (torch.full((b,), stop_level, dtype=I32, device=qkeys.device)
            if stop_level_arr is None else stop_level_arr.to(I32))
    path, plevel = [], []
    for _ in range(cfg.max_height):
        path.append(node)
        plevel.append(st.level[node].to(I32))
        node = _descend_once(st, node, qkeys, stop, chase_hops)
    path = torch.stack(path)
    plevel = torch.stack(plevel)
    hops = 1 + (path[1:] != path[:-1]).sum(dim=0, dtype=I32)
    return TraceB(leaf=node, path=path, path_level=plevel, hops=hops)


def parent_at_level(trace: TraceB, level) -> torch.Tensor:
    """Node visited at ``level`` on each lane's path (NULL if none)."""
    hit = trace.path_level == level
    cand = torch.where(hit, trace.path, torch.full_like(trace.path, NULL_PTR))
    return cand.max(dim=0).values


class LookupResult(NamedTuple):
    value: torch.Tensor         # [B] int32 (NULL_PTR when absent)
    found: torch.Tensor         # [B] bool
    consistent: torch.Tensor    # [B] bool — two-level version check passed
    leaf: torch.Tensor          # [B] leaf visited (netsim / cache accounting)
    hops: torch.Tensor          # [B] descents (netsim)


def leaf_lookup(st: TreeState, leaf: torch.Tensor, qkeys: torch.Tensor
                ) -> LookupResult:
    """Search leaf images for ``qkeys`` with the Fig. 9 version protocol.

    The unsorted leaf layout (paper §4.4) forces a full-node scan.  Unlike
    the leaf-search kernel, the value is masked by ``found`` alone.
    """
    nk = st.keys[leaf]                       # [B, F] snapshot
    nv = st.vals[leaf]
    fev = st.fev[leaf]
    rev = st.rev[leaf]
    node_ok = (st.fnv[leaf] == st.rnv[leaf]) & ~st.free_bit[leaf]

    eq = nk == qkeys[:, None]                # unsorted: compare every slot
    found = eq.any(dim=1)
    slot = first_true(eq, dim=1)
    entry_ok = take(fev, slot) == take(rev, slot)
    value = torch.where(found, take(nv, slot),
                        torch.full_like(qkeys, NULL_PTR))
    consistent = node_ok & (entry_ok | ~found)
    return LookupResult(value=value, found=found & consistent,
                        consistent=consistent, leaf=leaf,
                        hops=torch.zeros_like(leaf))


def lookup_batch(cfg: TreeConfig, st: TreeState, qkeys: torch.Tensor,
                 cache_image: dict | None = None,
                 chase_hops: int = 4) -> LookupResult:
    """Batched point lookup.

    With a ``cache_image`` (see :mod:`repro_torch.core.cache`) the descent
    runs locally through the replicated CS cache and ``hops`` reports the
    *remote* reads a real CS would issue (1 on a clean hit); without one
    it is the plain root-to-leaf traversal.
    """
    if cache_image is not None:
        from repro_torch.core.cache import cached_lookup
        res, _ = cached_lookup(cfg, st, cache_image, qkeys,
                               chase_hops=chase_hops)
        return res
    tr = traverse(cfg, st, qkeys)
    res = leaf_lookup(st, tr.leaf, qkeys)
    return res._replace(hops=tr.hops)


class RangeResult(NamedTuple):
    keys: torch.Tensor          # [B, count] int32 (EMPTY_KEY padding)
    vals: torch.Tensor          # [B, count]
    n: torch.Tensor             # [B] number of valid results
    leaves_read: torch.Tensor   # [B] leaves fetched (netsim)
    consistent: torch.Tensor    # [B] bool
    start_hit: torch.Tensor     # [B] bool — initial descent was a cache hit
    start_leaf: torch.Tensor    # [B] first leaf of the scan


def range_batch(cfg: TreeConfig, st: TreeState, lo: torch.Tensor,
                count: int, max_leaves: int,
                cache_image: dict | None = None) -> RangeResult:
    """Fetch the first ``count`` pairs with key >= lo for each lane.

    Mirrors the paper §4.4: the client reads along the sibling chain and
    version-checks each leaf like a lookup.  With a ``cache_image`` the
    initial descent runs through the CS cache (``start_hit``).
    """
    b = lo.shape[0]
    dev = lo.device
    tr = traverse(cfg, st, lo)
    start = tr.leaf
    start_hit = torch.zeros((b,), dtype=torch.bool, device=dev)
    if cache_image is not None:
        from repro_torch.core.cache import descend_image, leaf_sound
        leaf0, hit, _ = descend_image(cache_image, lo, cfg.max_height)
        sound = hit & leaf_sound(st, leaf0, lo)   # a split start falls back
        start = torch.where(sound, leaf0, start)
        start_hit = sound

    leaves, leaf = [], start
    for _ in range(max_leaves):
        leaves.append(leaf)
        nxt = st.sibling[leaf]
        leaf = torch.where(nxt != NULL_PTR, nxt, leaf)
    leaves = torch.stack(leaves, dim=1)              # [B, max_leaves]
    # dedupe the tail (sibling chain may saturate at the rightmost leaf)
    dup = torch.cat([torch.zeros((b, 1), dtype=torch.bool, device=dev),
                     leaves[:, 1:] == leaves[:, :-1]], dim=1)

    nk = st.keys[leaves]                             # [B, L, F]
    nv = st.vals[leaves]
    node_ok = (st.fnv[leaves] == st.rnv[leaves]) & ~st.free_bit[leaves]
    entry_ok = st.fev[leaves] == st.rev[leaves]
    valid = ((nk != EMPTY_KEY) & (nk >= lo[:, None, None])
             & entry_ok & node_ok[:, :, None] & ~dup[:, :, None])
    flat = (b, leaves.shape[1] * cfg.fanout)
    flat_k = torch.where(valid, nk, torch.full_like(nk, KEY_MAX)
                         ).reshape(flat)
    flat_v = nv.reshape(flat)
    order = torch.sort(flat_k, dim=1, stable=True).indices[:, :count]
    sk = torch.gather(flat_k, 1, order)
    sv = torch.gather(flat_v, 1, order)
    got = sk != KEY_MAX
    return RangeResult(
        keys=torch.where(got, sk, torch.full_like(sk, EMPTY_KEY)),
        vals=torch.where(got, sv, torch.full_like(sv, NULL_PTR)),
        n=got.sum(dim=1, dtype=I32),
        leaves_read=(~dup).sum(dim=1, dtype=I32),
        consistent=(node_ok | dup).all(dim=1),
        start_hit=start_hit,
        start_leaf=start,
    )
