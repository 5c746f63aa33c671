"""CS-side index cache (paper §4.2.3): a functional replicated image of the
internal tree levels, with versioned invalidation.

The PyTorch counterpart of :mod:`repro.core.cache`.  Each compute server
keeps an image of the internal B+Tree levels (keys + child pointers + the
node version observed at fill time) so that a lookup descends locally and
issues exactly one remote leaf read on a hit.  The leaf read is validated
by the two-level version protocol and the leaf's fence keys; a stale entry
is recovered by the B-link sibling chase, then a root retraversal.  The
coherence protocol is the reference's (docs/DESIGN.md §9).

The image is built and searched on the state's device; only the cached
rows (never the whole pool) are copied to the host.  The fetched leaves
are searched by the CUDA leaf-search kernel on a CUDA state and by its
plain version on a CPU state.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.ops import LookupResult, take, traverse
from repro_torch.core.tree import (EMPTY_KEY, NULL_PTR, TreeConfig,
                                   TreeState, tensors_from_numpy)
from repro_torch.device import resolve_device

ROW_SENTINEL = np.int32(2**31 - 1)     # "no row" padding in the sorted image
I32 = torch.int32

#: Dtypes of the image dict's entries (the reference's).
IMAGE_DTYPES = dict(rows=torch.int32, keys=torch.int32, vals=torch.int32,
                    level=torch.int8, valid=torch.bool, fnv=torch.uint8,
                    root=torch.int32)


class CacheStats(NamedTuple):
    """Per-lane cache outcome of one batched cached lookup."""
    hit: torch.Tensor           # [B] bool — descent resolved in the cache
    stale: torch.Tensor         # [B] bool — hit, but the leaf was stale
    remote_reads: torch.Tensor  # [B] int32 — node reads a real CS issues


def image_from_numpy(image: dict, device=None) -> dict:
    """A cache image from numpy arrays of the reference's dtypes."""
    return tensors_from_numpy(image, IMAGE_DTYPES, resolve_device(device))


def image_to_numpy(image: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in image.items()}


# --------------------------------------------------------------------------
# image construction
# --------------------------------------------------------------------------

def fill_image(cfg: TreeConfig, st: TreeState, levels: Optional[int] = None,
               max_rows: Optional[int] = None) -> tuple[dict, int]:
    """Snapshot the top ``levels`` internal levels into a replicated image.

    Returns ``(image, evicted)``: a dict of tensors on the state's device
    and the number of nodes dropped for the row budget.  The image holds
    sorted global ``rows`` (padded with ``ROW_SENTINEL``), their
    ``keys``/``vals``/``level``, a ``valid`` mask, the ``fnv`` observed at
    fill time, and the ``root``.  Rows are chosen top-down so the upper
    levels are always cached and level-1 nodes are the first evicted.
    """
    dev = st.keys.device
    height = int(st.height)
    if levels is None:
        levels = max(0, height - 1)          # every internal level
    lo_level = max(1, height - levels)
    cand = torch.nonzero((st.level >= lo_level) & ~st.free_bit)[:, 0]
    # top-down: higher levels first, row order within a level
    order = torch.sort(-st.level[cand].to(I32), stable=True).indices
    cand = cand[order].to(I32)
    if max_rows is None:
        max_rows = max(1, cand.shape[0])
    kept = torch.sort(cand[:max_rows]).values
    evicted = max(0, cand.shape[0] - max_rows)
    pad = max_rows - kept.shape[0]
    rows = torch.cat([kept, torch.full((pad,), int(ROW_SENTINEL), dtype=I32,
                                       device=dev)])
    safe = torch.clamp(rows, 0, cfg.n_nodes - 1)
    img = dict(
        rows=rows,
        keys=st.keys[safe],
        vals=st.vals[safe],
        level=st.level[safe],
        valid=rows != int(ROW_SENTINEL),
        fnv=st.fnv[safe],
        root=st.root.clone(),
    )
    return img, evicted


# --------------------------------------------------------------------------
# cached descent + validated lookup
# --------------------------------------------------------------------------

def descend_image(image: dict, qkeys: torch.Tensor, max_steps: int
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Route ``qkeys`` through the cached internal levels.

    Returns ``(target, hit, depth)``: for hit lanes ``target`` is the
    predicted leaf; for miss lanes it is the *frontier* — the first
    uncached node on the path — from which a real CS resumes its remote
    descent.  ``depth`` counts the cached descents.
    """
    crows, cvalid = image["rows"], image["valid"]
    ckeys, cvals, clevel = image["keys"], image["vals"], image["level"]
    b = qkeys.shape[0]
    dev = qkeys.device
    node = image["root"].to(I32).expand(b).clone()
    leaf = torch.zeros((b,), dtype=I32, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    dead = torch.zeros((b,), dtype=torch.bool, device=dev)
    depth = torch.zeros((b,), dtype=I32, device=dev)
    for _ in range(max_steps):
        pos = torch.clamp(torch.searchsorted(crows, node), 0,
                          crows.shape[0] - 1)
        ok = (crows[pos] == node) & cvalid[pos]
        lv = clevel[pos].to(I32)
        nk = ckeys[pos]
        nv = cvals[pos]
        occupied = nk != EMPTY_KEY
        le = occupied & (nk <= qkeys[:, None])
        j = torch.clamp(le.sum(dim=1, dtype=I32) - 1, min=0)
        child = take(nv, j)
        live = ~done & ~dead
        reach = live & ok & (lv == 1) & (child != NULL_PTR)
        leaf = torch.where(reach, child, leaf)
        done = done | reach
        dead = dead | (live & (~ok | (ok & (lv <= 0))))
        step = live & ok & (lv >= 1)
        depth = depth + step.to(I32)
        node = torch.where(live & ok & (lv > 1), child, node)
    return torch.where(done, leaf, node), done, depth


def _leaf_probe(cfg: TreeConfig, st: TreeState, leaf: torch.Tensor,
                qkeys: torch.Tensor) -> LookupResult:
    """Search the fetched leaf images with :func:`lookup_leaves`: the CUDA
    kernel on a CUDA state, its plain version on a CPU state.  The kernel
    masks its own ragged edge, so no lane padding is needed.
    """
    from repro_torch.kernels.leaf_search.ops import lookup_leaves
    value, found, cons = lookup_leaves(cfg, st, leaf, qkeys)
    return LookupResult(value=value, found=found, consistent=cons,
                        leaf=leaf, hops=torch.zeros_like(leaf))


def leaf_sound(st: TreeState, leaf: torch.Tensor, keys: torch.Tensor
               ) -> torch.Tensor:
    """Is the fetched node a live leaf whose fence range covers ``keys``?
    The shared validation for every cached descent (lookups and scans)."""
    return (st.level[leaf].to(I32) == 0) & ~st.free_bit[leaf] & \
        (st.fence_lo[leaf] <= keys) & (keys < st.fence_hi[leaf])


def cached_lookup(cfg: TreeConfig, st: TreeState, image: dict,
                  qkeys: torch.Tensor, chase_hops: int = 4
                  ) -> tuple[LookupResult, CacheStats]:
    """One batched lookup through the cache: local descent, one remote leaf
    read on a hit, B-link chase + root retraversal on staleness.

    ``CacheStats.remote_reads`` counts what a real CS would have issued,
    and is what netsim prices.
    """
    leaf0, hit, depth = descend_image(image, qkeys, cfg.max_height)
    leaf = torch.where(hit, leaf0, torch.zeros_like(leaf0))

    # --- the single remote leaf read, validated by fences + B-link chase ---
    chased = torch.zeros_like(leaf)
    for _ in range(chase_hops):
        beyond = hit & (qkeys >= st.fence_hi[leaf]) & \
            (st.sibling[leaf] != NULL_PTR)
        chased = chased + beyond.to(I32)
        leaf = torch.where(beyond, st.sibling[leaf], leaf)
    sound = hit & leaf_sound(st, leaf, qkeys)

    # --- fallback: full root-to-leaf retraversal for miss/unrecovered
    # lanes; skipped entirely when the whole batch hit (the warm case) ---
    if bool(sound.all()):
        final = leaf
    else:
        final = torch.where(sound, leaf, traverse(cfg, st, qkeys).leaf)
    res = _leaf_probe(cfg, st, final, qkeys)

    height = st.height.to(I32)
    stale = hit & ((chased > 0) | ~sound)
    # a partial descent resumes remotely from the first uncached level
    miss_reads = torch.clamp(height - depth, min=1)
    reads = torch.where(sound, 1 + chased,
                        torch.where(hit, 1 + chased + height, miss_reads))
    return (res._replace(hops=reads),
            CacheStats(hit=hit, stale=stale, remote_reads=reads))


# --------------------------------------------------------------------------
# the stateful per-CS cache subsystem
# --------------------------------------------------------------------------

@dataclasses.dataclass
class CacheCounters:
    hits: int = 0            # descent resolved in-cache, leaf read clean
    misses: int = 0          # descent left the cached/valid set
    stale: int = 0           # hit but the leaf image was stale (chase/retrav)
    evictions: int = 0       # nodes dropped at fill for the byte budget
    invalidations: int = 0   # entries invalidated (lazy + version sync)
    fills: int = 0           # full image (re)fills
    sync_sweeps: int = 0     # version-sync sweeps over the cached rows
    remote_reads: int = 0    # leaf/node reads issued by cached lookups
    fill_reads: int = 0      # whole-node reads spent (re)filling the image
    sync_reads: int = 0      # small version reads spent on sync sweeps

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class IndexCache:
    """The per-CS cache: replicated image + counters + coherence policy.

    The single-frontend ``ShermanIndex`` holds one instance standing in
    for every CS's identical replica (modeled footprint is
    ``capacity_bytes`` *per CS*); in the cluster plane each
    ``ClusterNode`` owns its **own** instance with its own staleness
    trajectory (DESIGN.md §11).  ``sync_every`` is the number of
    split-bearing write phases between version sweeps; ``sync_rounds``
    adds a scheduler-round-periodic sweep (see :meth:`end_round`); a
    root split always forces a refresh on the next read.  The image lives
    on the state's device, ``device`` (default CUDA); the host keeps
    copies of its small per-row columns (rows, valid, fnv, level, first
    separator).
    """

    def __init__(self, cfg: TreeConfig, capacity_bytes: int = 64 << 20,
                 levels: Optional[int] = None, chase_hops: int = 4,
                 sync_every: int = 8, refresh_frac: float = 0.125,
                 sync_rounds: int = 0, device=None):
        self.cfg = cfg
        self._device = device
        self.capacity_bytes = int(capacity_bytes)
        self.capacity_rows = max(1, min(
            self.capacity_bytes // max(cfg.node_bytes, 1), cfg.n_nodes))
        self.levels = levels
        self.chase_hops = int(chase_hops)
        self.sync_every = int(sync_every)
        self.refresh_frac = float(refresh_frac)
        self.sync_rounds = int(sync_rounds)
        self.counters = CacheCounters()
        self._image: Optional[dict] = None
        self._set_host_columns(None)
        self._splitty_phases = 0
        self._rounds_since_sync = 0
        self._needs_refresh = True
        self._maint_taken = (0, 0)      # (fill_reads, sync_reads) drained

    def _set_host_columns(self, image: Optional[dict]) -> None:
        if image is None:
            self._rows = np.zeros(0, np.int32)
            self._valid = np.zeros(0, bool)
            self._fnv = np.zeros(0, np.uint8)
            self._level = np.zeros(0, np.int8)
            self._lo = np.zeros(0, np.int32)
            self._root = -1
        else:
            self._rows = image["rows"].cpu().numpy()
            self._valid = image["valid"].cpu().numpy().copy()
            self._fnv = image["fnv"].cpu().numpy().copy()
            self._level = image["level"].cpu().numpy()
            self._lo = image["keys"][:, 0].cpu().numpy()  # first separator
            self._root = int(image["root"])
        self._filled = self._rows != ROW_SENTINEL

    # -- image lifecycle ---------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self.capacity_bytes > 0

    @property
    def cached_bytes(self) -> int:
        return int(self._valid.sum()) * self.cfg.node_bytes

    def fill(self, st: TreeState) -> None:
        """(Re)build the image from the current tree state."""
        self._image, evicted = fill_image(
            self.cfg, st, levels=self.levels, max_rows=self.capacity_rows)
        self._set_host_columns(self._image)
        self._root = int(st.root)
        self.counters.evictions += evicted
        self.counters.fills += 1
        self.counters.fill_reads += int(self._filled.sum())
        self._splitty_phases = 0
        self._needs_refresh = False

    def image(self, st: TreeState) -> dict:
        if self._image is None or self._needs_refresh or \
                int(st.root) != self._root or self._stale_frac() > \
                self.refresh_frac:
            self.fill(st)
        return self._image

    def _stale_frac(self) -> float:
        n = int(self._filled.sum())
        return (int((self._filled & ~self._valid).sum()) / n) if n else 0.0

    def _set_valid(self, valid: np.ndarray) -> None:
        self._valid = valid
        dev = self._image["valid"].device
        self._image = dict(self._image,
                           valid=torch.from_numpy(valid.copy()).to(dev))
        # an invalid upper-level (or root) row cuts off descent for a huge
        # key range — far more than its 1/rows share of _stale_frac — so
        # losing one forces a refresh rather than waiting on the threshold
        bad = self._filled & ~valid
        if bad.any():
            if (self._level[bad] > 1).any() or \
                    bad[self._rows == self._root].any():
                self._needs_refresh = True

    # -- invalidation ------------------------------------------------------
    def invalidate_covering(self, keys: np.ndarray) -> int:
        """Lazy invalidation: drop the level-1 entries routing ``keys``
        (the paper's invalidate-on-stale-detection)."""
        if self._image is None or keys.size == 0:
            return 0
        lo, lv = self._lo, self._level
        # covering is keyed over ALL filled level-1 entries (valid or
        # already dropped): the entry with max lo <= k covers k
        cand = np.nonzero(self._filled & (lv == 1))[0]
        if cand.size == 0:
            return 0
        order = np.argsort(lo[cand], kind="stable")
        cand = cand[order]
        pos = np.searchsorted(lo[cand], np.unique(keys), side="right") - 1
        cover = np.unique(cand[pos[pos >= 0]])
        hit = cover[self._valid[cover]]
        if hit.size:
            valid = self._valid.copy()
            valid[hit] = False
            self._set_valid(valid)
            self.counters.invalidations += int(hit.size)
        return int(hit.size)

    def sync_versions(self, st: TreeState) -> int:
        """Versioned invalidation: re-read the FNV of every cached row and
        invalidate entries whose version moved since fill.  The sweep's
        wire cost accrues in ``counters.sync_reads`` (one small read per
        cached row).  Only the cached rows leave the device."""
        if self._image is None:
            return 0
        safe = torch.clamp(self._image["rows"], 0, self.cfg.n_nodes - 1)
        now = st.fnv[safe].cpu().numpy()
        freed = st.free_bit[safe].cpu().numpy()
        changed = self._valid & ((now != self._fnv) | freed)
        n = int(changed.sum())
        if n:
            self._set_valid(self._valid & ~changed)
            self.counters.invalidations += n
        self.counters.sync_sweeps += 1
        self.counters.sync_reads += int(self._filled.sum())
        self._splitty_phases = 0
        return n

    def end_round(self, st: TreeState) -> None:
        """Cluster-plane coherence tick: one scheduler round elapsed.

        In the multi-CS plane a compute server is *not* fed remote CSs'
        split outputs (``note_splits`` fires only for its own writes); it
        learns of remote structural changes lazily — stale detection on
        its own reads — or through this periodic sweep, one version sync
        every ``sync_rounds`` rounds (0 disables).  The sweep's wire cost
        accrues like any other sync (``counters.sync_reads``) and is
        drained by ``take_maintenance``.
        """
        if not (self.enabled and self.sync_rounds and
                self._image is not None):
            return
        self._rounds_since_sync += 1
        if self._rounds_since_sync >= self.sync_rounds:
            self._rounds_since_sync = 0
            self.sync_versions(st)

    def note_splits(self, n_leaf: int, n_internal: int, n_root: int,
                    st: TreeState) -> None:
        """Invalidation hook: called by the API with the split outputs of
        one write batch (:class:`repro_torch.core.write.WriteStats`)."""
        if not self.enabled or self._image is None:
            return
        if n_root:
            self._needs_refresh = True
            return
        if n_leaf or n_internal:
            self._splitty_phases += 1
            if self.sync_every and self._splitty_phases >= self.sync_every:
                self.sync_versions(st)

    # -- lookups -----------------------------------------------------------
    def lookup(self, st: TreeState, qkeys: torch.Tensor,
               n_valid: Optional[int] = None) -> tuple[LookupResult, dict]:
        """Batched cached lookup; returns the result plus numpy stats
        (``hit``/``stale``/``remote_reads`` per lane) for netsim.

        ``n_valid`` marks the real batch length when the caller padded
        ``qkeys`` to a dispatch bucket — the returned arrays stay full
        width, but only the first ``n_valid`` lanes touch the counters
        and the lazy invalidation.
        """
        img = self.image(st)
        res, cst = cached_lookup(self.cfg, st, img, qkeys, self.chase_hops)
        hit = cst.hit.cpu().numpy()
        stale = cst.stale.cpu().numpy()
        reads = cst.remote_reads.cpu().numpy()
        k = hit.shape[0] if n_valid is None else int(n_valid)
        self.counters.hits += int((hit[:k] & ~stale[:k]).sum())
        self.counters.misses += int((~hit[:k]).sum())
        self.counters.stale += int(stale[:k].sum())
        self.counters.remote_reads += int(reads[:k].sum())
        if stale[:k].any():                  # lazy invalidation on detection
            self.invalidate_covering(qkeys.cpu().numpy()[:k][stale[:k]])
        return res, dict(hit=hit, stale=stale, remote_reads=reads)

    def route_hits(self, st: TreeState, qkeys: torch.Tensor,
                   n_valid: Optional[int] = None) -> np.ndarray:
        """Descent-only hit mask (no state mutation of the counters' stale
        plane) — used to price the traversal leg of write ops.  With
        ``n_valid``, padding lanes beyond it stay out of the counters."""
        if not self.enabled:
            return np.zeros(qkeys.shape[0], bool)
        img = self.image(st)
        _, hit, _ = descend_image(img, qkeys, self.cfg.max_height)
        hit = hit.cpu().numpy()
        self.note_hits(hit if n_valid is None else hit[:int(n_valid)])
        return hit

    def note_hits(self, hit: np.ndarray) -> None:
        """Count descent-only hit/miss outcomes (write routing, scans)."""
        hit = np.asarray(hit)
        self.counters.hits += int(hit.sum())
        self.counters.misses += int((~hit).sum())

    def take_maintenance(self) -> tuple[int, int]:
        """Drain the un-priced maintenance traffic since the last call:
        ``(node_reads, small_reads)`` for image fills and version sweeps."""
        f0, s0 = self._maint_taken
        f1, s1 = self.counters.fill_reads, self.counters.sync_reads
        self._maint_taken = (f1, s1)
        return f1 - f0, s1 - s0

    def rows_ms(self) -> np.ndarray:
        """Owning MS of every filled cache row — the verb plane spreads
        maintenance reads over these instead of a blind round-robin."""
        if self._image is None:
            return np.zeros(0, np.int32)
        return self.cfg.ms_of(self._rows[self._filled]).astype(np.int32)

    # -- chaos plane: cold restart + full-state snapshot -------------------
    def reset(self) -> None:
        """Cold restart: drop the image (a CS that just joined the fleet
        has nothing cached — its first read triggers a full fill, the
        warm-up transient the chaos plane prices; DESIGN.md §13).
        Cumulative counters are kept: they are this CS's *history*, and
        the cluster conservation invariant sums them across the run."""
        self._image = None
        self._set_host_columns(None)
        self._splitty_phases = 0
        self._rounds_since_sync = 0
        self._needs_refresh = True

    def export_state(self) -> tuple[Optional[dict], dict]:
        """Snapshot the cache's full mutable state as
        ``(image_arrays, scalars)`` — everything a tick-for-tick resume
        needs (the image drives routing and maintenance pricing, so a
        resumed run with a refilled-instead-of-restored cache would
        diverge from the uninterrupted one).  The image arrays are host
        copies: the port updates images in place, and ``.numpy()`` of a
        CPU tensor would alias it.  The scalars are plain Python ints and
        bools, so ``json.dump`` takes them."""
        image = None
        if self._image is not None:
            image = {k: v.cpu().numpy().copy()
                     for k, v in self._image.items()}
        scalars = dict(
            counters=self.counters.as_dict(),
            rounds_since_sync=int(self._rounds_since_sync),
            splitty_phases=int(self._splitty_phases),
            needs_refresh=bool(self._needs_refresh),
            maint_taken=[int(x) for x in self._maint_taken],
        )
        return image, scalars

    def import_state(self, image: Optional[dict], scalars: dict) -> None:
        """Restore a snapshot taken by :meth:`export_state` (by either
        package); the image goes onto the cache's own device."""
        if image is None:
            self.reset()
        else:
            self._image = image_from_numpy(image, self._device)
            self._set_host_columns(self._image)
        self.counters = CacheCounters(**scalars["counters"])
        self._rounds_since_sync = int(scalars["rounds_since_sync"])
        self._splitty_phases = int(scalars["splitty_phases"])
        self._needs_refresh = bool(scalars["needs_refresh"])
        self._maint_taken = tuple(scalars["maint_taken"])

    # -- reporting ---------------------------------------------------------
    @property
    def hit_ratio(self) -> float:
        c = self.counters
        t = c.hits + c.misses + c.stale
        return c.hits / t if t else 1.0
