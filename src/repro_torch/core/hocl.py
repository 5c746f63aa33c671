"""HOCL — hierarchical on-chip lock, adapted to batched SIMD execution.

The PyTorch counterpart of :mod:`repro.core.hocl`.  The paper's lock
hierarchy (§4.3): a per-MS global lock table (GLT) in NIC on-chip memory,
acquired with masked RDMA_CAS, and a per-CS local lock table (LLT) whose
FIFO wait queues hand a released lock to the next local waiter (at most
MAX_DEPTH = 4 consecutive handovers).

SIMD adaptation (DESIGN.md §2/§8): a batch lane is a client thread; lanes
are grouped by (compute server, target node).  A local group of size k is a
local wait queue of depth k and costs ``ceil(k / (MAX_DEPTH+1))`` remote
lock cycles.  Cross-CS contention on a node serializes the per-CS groups;
the serialization rank of each group feeds the netsim queueing model.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.tree import TreeConfig

I32 = torch.int32
INT32_MAX = 2**31 - 1


class Groups(NamedTuple):
    """Conflict-group decomposition of a batch of node-targeted ops.

    All tensors are in *lane* order.
    """
    perm: torch.Tensor              # [B] lanes sorted by (node, cs, lane)
    inv: torch.Tensor               # [B] inverse permutation
    local_rank: torch.Tensor        # [B] FIFO rank inside the (cs, node) group
    local_size: torch.Tensor        # [B] size of own (cs, node) group
    local_head: torch.Tensor        # [B] bool — first lane of local group
    cycle_head: torch.Tensor        # [B] bool — issues the remote LOCK CAS
    chain_end: torch.Tensor         # [B] bool — issues the remote UNLOCK
    node_rank: torch.Tensor         # [B] rank inside the node group
    node_size: torch.Tensor         # [B] size of own node group
    node_head: torch.Tensor         # [B] bool — first lane of node group
    cs_rank: torch.Tensor           # [B] serialization rank of own CS's group
    n_cs_on_node: torch.Tensor      # [B] #distinct CSs contending for the node
    lock_cycles: torch.Tensor       # [B] remote lock acquisitions by own group
    n_node_groups: torch.Tensor     # [] distinct nodes targeted
    n_local_groups: torch.Tensor    # [] distinct (cs, node) pairs


def cumsum32(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Inclusive int32 cumulative sum (torch would promote to int64)."""
    return torch.cumsum(x.to(I32), dim=dim, dtype=I32)


def sum32(x: torch.Tensor, **kw) -> torch.Tensor:
    """int32 sum (torch would promote to int64)."""
    return torch.sum(x.to(I32), dtype=I32, **kw)


def stable_argsort(*keys: torch.Tensor) -> torch.Tensor:
    """``jnp.lexsort(keys)``: the last key is the primary one.  Chained
    stable sorts, least significant key first; int32 like the reference."""
    perm = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in keys:
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm.to(I32)


def inverse_perm(perm: torch.Tensor) -> torch.Tensor:
    inv = torch.empty_like(perm)
    inv[perm.long()] = torch.arange(perm.shape[0], dtype=perm.dtype,
                                    device=perm.device)
    return inv


def segment_sum(values, seg_ids, num_segments):
    """``jax.ops.segment_sum``: empty segments are 0."""
    out = torch.zeros((num_segments,), dtype=values.dtype,
                      device=values.device)
    return out.index_add_(0, seg_ids.long(), values)


def segment_min(values, seg_ids, num_segments):
    """``jax.ops.segment_min``: empty segments keep the int32 maximum."""
    out = torch.full((num_segments,), INT32_MAX, dtype=values.dtype,
                     device=values.device)
    return out.scatter_reduce_(0, seg_ids.long(), values, "amin")


def _ids_from_flags(flags: torch.Tensor) -> torch.Tensor:
    """Group ids (0-based) from per-position new-group flags, sorted order."""
    return cumsum32(flags) - 1


def group_by_node(cfg: TreeConfig, node: torch.Tensor, cs: torch.Tensor,
                  active: torch.Tensor) -> Groups:
    """Decompose a batch into HOCL conflict groups.

    Inactive lanes are parked on a sentinel node id so they never collide
    with real groups (and are excluded from all counters).
    """
    b = node.shape[0]
    dev = node.device
    lane = torch.arange(b, dtype=I32, device=dev)
    big = cfg.n_nodes                        # sentinel beyond any node id
    node_k = torch.where(active, node.to(I32), big + lane)

    # lexsort((lane, cs, node_k)): lane is the identity order already
    perm = stable_argsort(cs, node_k)
    inv = inverse_perm(perm)
    ns = node_k[perm]
    cssrt = cs.to(I32)[perm]
    act_s = active[perm]

    minus2 = torch.full((1,), -2, dtype=I32, device=dev)
    prev_node = torch.cat([minus2, ns[:-1]])
    prev_cs = torch.cat([minus2, cssrt[:-1]])
    new_node = ns != prev_node
    new_local = new_node | (cssrt != prev_cs)

    node_gid = _ids_from_flags(new_node)
    local_gid = _ids_from_flags(new_local)
    ones = torch.ones((b,), dtype=I32, device=dev)

    node_size_g = segment_sum(ones, node_gid, b)
    local_size_g = segment_sum(ones, local_gid, b)
    node_start_g = segment_min(lane, node_gid, b)       # sorted pos
    local_start_g = segment_min(lane, local_gid, b)

    pos = lane                                        # position in sorted order
    node_rank_s = pos - node_start_g[node_gid.long()]
    local_rank_s = pos - local_start_g[local_gid.long()]

    # serialization rank of each (cs,node) group among groups on same node:
    # count local-group heads on this node before me.
    head_flag = new_local.to(I32)
    heads_before = cumsum32(head_flag) - head_flag
    node_first_head = segment_min(heads_before + head_flag, node_gid,
                                  b)[node_gid.long()]
    cs_rank_s = (heads_before + head_flag) - node_first_head
    n_cs_on_node_s = segment_sum(head_flag, node_gid, b)[node_gid.long()]

    # remote lock cycles of the local group: first acquire + re-acquire after
    # every MAX_DEPTH handovers (paper lines 24-28).
    k = local_size_g[local_gid.long()]
    cycles_s = torch.div(k + cfg.handover_max, cfg.handover_max + 1,
                         rounding_mode="floor")
    cyc_pos = torch.remainder(local_rank_s, cfg.handover_max + 1)
    cycle_head_s = cyc_pos == 0
    chain_end_s = (cyc_pos == cfg.handover_max) | (local_rank_s == k - 1)

    def unsort(x):
        return x[inv.long()]

    return Groups(
        perm=perm, inv=inv,
        local_rank=unsort(local_rank_s), local_size=unsort(k),
        local_head=unsort(new_local),
        cycle_head=unsort(cycle_head_s), chain_end=unsort(chain_end_s),
        node_rank=unsort(node_rank_s),
        node_size=unsort(node_size_g[node_gid.long()]),
        node_head=unsort(new_node),
        cs_rank=unsort(cs_rank_s),
        n_cs_on_node=unsort(n_cs_on_node_s),
        lock_cycles=unsort(cycles_s),
        n_node_groups=sum32(new_node & act_s),
        n_local_groups=sum32(new_local & act_s),
    )


def reset_glt(state, ms: int):
    """Crash of memory server ``ms``: its GLT lives in NIC on-chip SRAM,
    so a crash zeroes that server's lock rows.  Updates the state in place
    and returns it."""
    state.glt[ms].zero_()
    return state


def cross_cs_contention(leaves_by_cs) -> dict:
    """Cross-CS conflict decomposition of one cluster wave (numpy, host):
    how many nodes are contended by more than one CS, the worst per-node
    CS fan-in, and the number of cross-CS (CS, node) conflict pairs."""
    pairs = [(np.unique(np.asarray(lv)), c)
             for c, lv in enumerate(leaves_by_cs)
             if np.asarray(lv).size]
    if not pairs:
        return dict(contended_nodes=0, max_cs_fanin=0, cross_pairs=0)
    nodes = np.concatenate([p[0] for p in pairs])
    uniq, counts = np.unique(nodes, return_counts=True)
    contended = counts > 1
    return dict(contended_nodes=int(contended.sum()),
                max_cs_fanin=int(counts.max()),
                cross_pairs=int((counts[contended] - 1).sum()))


def lock_phase_stats(cfg: TreeConfig, g: Groups, active: torch.Tensor):
    """Scalar lock-plane counters for one write phase (netsim inputs)."""
    act = active
    zero = torch.zeros((), dtype=I32, device=active.device)
    sel = lambda x: torch.where(act, x, zero)
    # Sherman/HOCL: remote CAS issued once per lock cycle by group heads.
    hocl_cas = sum32(torch.where(act & g.local_head, g.lock_cycles, zero))
    # handovers: ops served without a remote acquisition
    handovers = sum32(sel(g.local_size * 0 + 1)) - sum32(
        torch.where(act & g.local_head, g.lock_cycles, zero))
    # no-hierarchy baseline: every op CASes remotely; a lane at global node
    # rank r burns ~r failed attempts while the r earlier ops hold the lock.
    flat_cas = sum32(sel(g.node_rank + 1))
    # queue depth distribution drives tail latency in netsim
    max_node_group = torch.where(act, g.node_size, zero).max()
    max_cs_depth = torch.where(act, g.cs_rank, zero).max()
    return dict(hocl_remote_cas=hocl_cas, handovers=handovers,
                flat_remote_cas=flat_cas, max_node_group=max_node_group,
                max_cs_depth=max_cs_depth)

