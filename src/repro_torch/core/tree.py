"""Sherman tree state: a disaggregated node pool as a NamedTuple of tensors.

The PyTorch counterpart of :mod:`repro.core.tree`.  The memory pool of the
paper (a set of memory servers, each exposing registered memory regions) is
a struct-of-arrays node pool: row ``i`` of every tensor is one tree node,
owned by memory server ``i // nodes_per_ms``.  A pointer is the global row
index (int32); ``NULL_PTR`` (-1) is the null pointer.

Node layout (paper Fig. 8):

* leaf:      FNV | [FEV, key, value, REV] * fanout | RNV   (entries UNSORTED)
* internal:  FNV | [key, child] * fanout | RNV             (entries SORTED)

Internal nodes use the separator representation: entry ``(k_j, c_j)`` means
child ``c_j`` covers keys in ``[k_j, k_{j+1})``; the first separator equals
the node's lower fence.  Every node carries fence keys and its level.

The tensors keep the reference's dtypes field for field (see
:data:`STATE_DTYPES`), so a JAX state carried across with
:func:`state_from_numpy` is bit-identical.  Unlike the JAX pytree, the
port's state is **mutable**: the write path updates the pool in place
(``index_put_``), which is what ``donate_argnums`` buys the reference.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device

NULL_PTR = -1
EMPTY_KEY = -1                     # slot never used / deleted ("null" key)
KEY_MIN = -(2**31) + 2             # lower fence of leftmost nodes
KEY_MAX = 2**31 - 1                # upper fence of rightmost nodes
VERSION_MOD = 16                   # 4-bit versions

#: Leaves written per step of :func:`bulkload` (bounds its temporaries).
_LEAF_CHUNK = 1 << 22


@dataclasses.dataclass(frozen=True)
class TreeConfig:
    """Static configuration of a Sherman tree."""

    n_ms: int = 4                  # number of memory servers (mem shards)
    nodes_per_ms: int = 4096       # node-pool rows per MS
    fanout: int = 16               # entries per node (leaf and internal)
    n_locks_per_ms: int = 131072   # GLT entries per MS (paper: 256KB/16bit)
    max_height: int = 6            # static traversal bound
    handover_max: int = 4          # MAX_DEPTH consecutive lock handovers
    n_cs: int = 4                  # compute servers (data shards)
    # Modeled wire sizes (bytes) for netsim accounting; defaults follow the
    # paper's 1KB nodes with 8B keys / 8B values and 4-bit paired versions.
    key_bytes: int = 8
    value_bytes: int = 8

    @property
    def n_nodes(self) -> int:
        return self.n_ms * self.nodes_per_ms

    @property
    def park_row(self) -> int:
        """Reserved row used as the scatter target of masked-out lanes.

        The last row of every MS is reserved (never allocated) so that
        masked scatters can always be parked on a row that carries no live
        node.  ``park_row`` is the global instance."""
        return self.n_nodes - 1

    @property
    def alloc_cap(self) -> int:
        """Allocatable rows per MS (last row reserved for parking)."""
        return self.nodes_per_ms - 1

    @property
    def entry_bytes(self) -> int:
        # key + value + FEV/REV pair (1 byte total) — the paper's 17B.
        return self.key_bytes + self.value_bytes + 1

    @property
    def node_bytes(self) -> int:
        # header: FNV/RNV (1B), fences (2 keys), level+free+sibling (10B)
        return self.fanout * self.entry_bytes + 2 * self.key_bytes + 11

    def ms_of(self, node_id):
        return node_id // self.nodes_per_ms

    def lock_index(self, node_id):
        """Hash a node address into its MS's global lock table (paper l.5)."""
        return node_id % self.n_locks_per_ms


class TreeState(NamedTuple):
    """The disaggregated tree: one tuple of tensors on one device."""

    keys: torch.Tensor          # [N, F] int32; EMPTY_KEY = empty slot
    vals: torch.Tensor          # [N, F] int32; leaf: value, internal: child
    fev: torch.Tensor           # [N, F] uint8 front entry versions (4-bit)
    rev: torch.Tensor           # [N, F] uint8 rear  entry versions (4-bit)
    fnv: torch.Tensor           # [N]    uint8 front node version
    rnv: torch.Tensor           # [N]    uint8 rear  node version
    level: torch.Tensor         # [N]    int8  (0 = leaf, -1 = unallocated)
    fence_lo: torch.Tensor      # [N]    int32 inclusive lower fence
    fence_hi: torch.Tensor      # [N]    int32 exclusive upper fence
    sibling: torch.Tensor       # [N]    int32 right sibling (B-link)
    free_bit: torch.Tensor      # [N]    bool  True = node freed (§4.2.4)
    glt: torch.Tensor           # [n_ms, n_locks] uint16 global lock tables
    root: torch.Tensor          # []     int32
    height: torch.Tensor        # []     int32 (#levels; 1 = root is a leaf)
    alloc_next: torch.Tensor    # [n_ms] int32 per-MS bump pointer
    alloc_rr: torch.Tensor      # []     int32 round-robin MS cursor


#: The reference dtype of every :class:`TreeState` field.
STATE_DTYPES = dict(
    keys=torch.int32, vals=torch.int32, fev=torch.uint8, rev=torch.uint8,
    fnv=torch.uint8, rnv=torch.uint8, level=torch.int8,
    fence_lo=torch.int32, fence_hi=torch.int32, sibling=torch.int32,
    free_bit=torch.bool, glt=torch.uint16, root=torch.int32,
    height=torch.int32, alloc_next=torch.int32, alloc_rr=torch.int32)


def empty_state(cfg: TreeConfig, device=None) -> TreeState:
    dev = resolve_device(device)
    n, f = cfg.n_nodes, cfg.fanout
    i32 = dict(dtype=torch.int32, device=dev)
    u8 = dict(dtype=torch.uint8, device=dev)
    return TreeState(
        keys=torch.full((n, f), EMPTY_KEY, **i32),
        vals=torch.full((n, f), NULL_PTR, **i32),
        fev=torch.zeros((n, f), **u8),
        rev=torch.zeros((n, f), **u8),
        fnv=torch.zeros((n,), **u8),
        rnv=torch.zeros((n,), **u8),
        level=torch.full((n,), -1, dtype=torch.int8, device=dev),
        fence_lo=torch.zeros((n,), **i32),
        fence_hi=torch.zeros((n,), **i32),
        sibling=torch.full((n,), NULL_PTR, **i32),
        free_bit=torch.zeros((n,), dtype=torch.bool, device=dev),
        glt=torch.zeros((cfg.n_ms, cfg.n_locks_per_ms), dtype=torch.uint16,
                        device=dev),
        root=torch.zeros((), **i32),
        height=torch.zeros((), **i32),
        alloc_next=torch.zeros((cfg.n_ms,), **i32),
        alloc_rr=torch.zeros((), **i32),
    )


def field_dict(arrays, names) -> dict:
    """Field dict of a NamedTuple, a mapping, or a sequence in field order."""
    if hasattr(arrays, "_asdict"):
        return dict(arrays._asdict())
    if isinstance(arrays, dict):
        return dict(arrays)
    return dict(zip(names, arrays))


def tensors_from_numpy(arrays: dict, dtypes: dict, device) -> dict:
    """Move numpy arrays onto ``device``, refusing any dtype drift."""
    out = {}
    for name, want in dtypes.items():
        a = np.array(arrays[name])             # a writable copy
        got = torch.from_numpy(a)
        if got.dtype != want:
            raise TypeError(f"{name}: expected {want}, got numpy {a.dtype}")
        out[name] = got.to(device)
    return out


def state_from_numpy(arrays, device=None) -> TreeState:
    """A :class:`TreeState` from numpy arrays of the reference's dtypes —
    e.g. ``jax.tree_util.tree_map(np.asarray, jax_state)``."""
    dev = resolve_device(device)
    fields = field_dict(arrays, TreeState._fields)
    return TreeState(**tensors_from_numpy(fields, STATE_DTYPES, dev))


def state_to_numpy(st: TreeState) -> TreeState:
    """Host copy of every field (a TreeState of numpy arrays)."""
    return TreeState(*[x.cpu().numpy() for x in st])


def clone_state(st: TreeState) -> TreeState:
    """A deep copy — the write path mutates the pool in place."""
    return TreeState(*[x.clone() for x in st])


def _as_i32(x, dev: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.int32)
    return torch.from_numpy(np.asarray(x, np.int32).copy()).to(dev)


def _alloc_rows(cfg: TreeConfig, k0: int, n: int,
                dev: torch.device) -> torch.Tensor:
    """Rows of allocations ``k0..k0+n``: the two-stage allocator
    (round-robin MS choice + per-MS bump pointer) gives its k-th
    allocation row ``(k % n_ms) * nodes_per_ms + k // n_ms``."""
    k = torch.arange(k0, k0 + n, dtype=torch.int64, device=dev)
    return (k % cfg.n_ms) * cfg.nodes_per_ms + k // cfg.n_ms


def bulkload(cfg: TreeConfig, keys, vals, fill: float = 0.8,
             device=None) -> TreeState:
    """Build a tree from unique keys, each leaf ``fill`` full.

    Vectorized counterpart of the reference's per-node loop: leaves left to
    right, then each internal level left to right, are allocated in that
    order, so every row, fence and sibling pointer equals the reference's.
    ``keys``/``vals`` may be numpy arrays or tensors; ``device=None`` means
    the device of a tensor ``keys``, else CUDA.
    """
    if device is None and isinstance(keys, torch.Tensor):
        device = keys.device
    dev = resolve_device(device)
    keys = _as_i32(keys, dev)
    vals = _as_i32(vals, dev)
    if keys.ndim != 1 or keys.shape != vals.shape:
        raise ValueError("bulkload takes 1-D keys and vals of one length")
    keys, order = torch.sort(keys, stable=True)
    vals = vals[order]
    del order
    if keys.numel() > 1 and bool((keys[1:] == keys[:-1]).any()):
        raise ValueError("bulkload requires unique keys")

    f = cfg.fanout
    per_leaf = max(1, min(f, int(round(f * fill))))
    r = keys.numel()
    n_leaves = max(1, -(-r // per_leaf))
    sizes = [n_leaves]
    while sizes[-1] > 1:
        sizes.append(-(-sizes[-1] // f))
    if sum(sizes) > cfg.n_ms * cfg.alloc_cap:
        raise RuntimeError("node pool exhausted during bulkload")

    st = empty_state(cfg, dev)
    i32 = dict(dtype=torch.int32, device=dev)

    # ---- leaf level: leaf j holds keys[j*per_leaf : (j+1)*per_leaf] ----
    level_rows = torch.empty(n_leaves, **i32)
    level_keys = torch.empty(n_leaves, **i32)     # lower fence of each leaf
    for j0 in range(0, n_leaves, _LEAF_CHUNK):
        j1 = min(n_leaves, j0 + _LEAF_CHUNK)
        n = j1 - j0
        rows = _alloc_rows(cfg, j0, n, dev)
        lo, hi = j0 * per_leaf, min(j1 * per_leaf, r)
        kk = torch.full((n * per_leaf,), EMPTY_KEY, **i32)
        vv = torch.full((n * per_leaf,), NULL_PTR, **i32)
        kk[:hi - lo] = keys[lo:hi]
        vv[:hi - lo] = vals[lo:hi]
        st.keys[rows, :per_leaf] = kk.view(n, per_leaf)
        st.vals[rows, :per_leaf] = vv.view(n, per_leaf)
        st.level[rows] = 0
        fence_lo = kk.view(n, per_leaf)[:, 0].clone()
        if j0 == 0:
            fence_lo[0] = KEY_MIN
        fence_hi = torch.full((n,), KEY_MAX, **i32)
        nxt = keys[(j0 + 1) * per_leaf:min((j1 + 1) * per_leaf, r):per_leaf]
        fence_hi[:nxt.numel()] = nxt
        st.fence_lo[rows] = fence_lo
        st.fence_hi[rows] = fence_hi
        n_sib = min(j1, n_leaves - 1) - j0
        st.sibling[rows[:n_sib]] = \
            _alloc_rows(cfg, j0 + 1, n_sib, dev).to(torch.int32)
        level_rows[j0:j1] = rows.to(torch.int32)
        level_keys[j0:j1] = fence_lo

    # ---- internal levels bottom-up: parent p holds children p*F.. ----
    k0, lvl = n_leaves, 0
    while level_rows.numel() > 1:
        lvl += 1
        c = level_rows.numel()
        p = -(-c // f)
        rows = _alloc_rows(cfg, k0, p, dev)
        k0 += p
        pk = torch.full((p * f,), EMPTY_KEY, **i32)
        pv = torch.full((p * f,), NULL_PTR, **i32)
        pk[:c] = level_keys
        pv[:c] = level_rows
        pk, pv = pk.view(p, f), pv.view(p, f)
        st.keys[rows] = pk
        st.vals[rows] = pv
        st.level[rows] = lvl
        # the first separator is the lower fence (KEY_MIN for the first
        # node: the leftmost child's fence is KEY_MIN on every level)
        parent_keys = pk[:, 0].clone()
        st.fence_lo[rows] = parent_keys
        fence_hi = torch.full((p,), KEY_MAX, **i32)
        fence_hi[:-1] = parent_keys[1:]
        st.fence_hi[rows] = fence_hi
        st.sibling[rows[:-1]] = rows[1:].to(torch.int32)
        level_rows, level_keys = rows.to(torch.int32), parent_keys

    total = k0
    ms = torch.arange(cfg.n_ms, dtype=torch.int64, device=dev)
    return st._replace(
        root=level_rows[0].clone(),
        height=torch.tensor(lvl + 1, **i32),
        alloc_next=((total + cfg.n_ms - 1 - ms) // cfg.n_ms).to(torch.int32),
        alloc_rr=torch.tensor(total, **i32),
    )
