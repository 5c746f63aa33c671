"""Distributed execution of the Sherman index on a mesh of processes.

The PyTorch counterpart of :mod:`repro.core.sharded`, over
``torch.distributed``.  A mesh (:class:`repro_torch.launch.mesh.Mesh`) is
``data x model`` ranks: the node pool's rows shard over ``model`` (the
"mem" axis, one memory server's block of ``nodes_per_ms`` rows a rank),
the client ops over ``data``, and the CS-side cache image is replicated.
Every function here runs on every rank of the mesh, as the reference's
``shard_map`` and ``jit`` bodies run on every device.

* **routed path** — :func:`routed_lookup_fn`: each rank descends the
  replicated image, reads every lane's row from its owner
  (:func:`_remote_read_rows`: each mem rank serves the rows it owns and
  zeros elsewhere, and one ``all_reduce`` over the mem row sums them, the
  collective analogue of one RDMA_READ), then searches the rows with the
  leaf-search kernel's gathered-row entry (the CUDA kernel on the card,
  its plain version on the CPU).
* **pjit path (baseline)** — :func:`pjit_phase_fns`: the single-pool
  :func:`repro_torch.core.write.write_phase` on the whole pool and the
  whole wave.  The ranks' blocks and data shards are gathered on one
  coordinating rank (mesh rank 0), which runs the write phase and sends
  every block back: two block transfers a memory server a wave, the
  function XLA's SPMD partitioner gives the reference, which calls its own
  "all-gather heavy".  It is the baseline, as the reference's is.

**Communication.**  One card is one device, and NCCL refuses two ranks on
one GPU, so a mesh on the card runs on ``gloo``, whose CUDA side takes
``broadcast``, ``all_reduce`` and ``barrier`` (staged through host
memory).  The routed read packs its fields into one int32 tensor and
makes one ``all_reduce``; the gather and the send-back are broadcasts
over two-rank groups and over the coordinator with one data column.
Broadcasts move raw bytes (gloo has no uint16), in chunks of
:data:`CHUNK_BYTES`.

**Aliasing.**  Nothing is donated: the port's write phase updates its pool
in place.  :func:`pjit_phase_fns`'s function writes the new block and the
new replicated scalars into the caller's ``st_local`` tensors and returns
``st_local`` itself, so every tensor of the returned state aliases the
one passed in, as :func:`repro_torch.core.write.write_phase`'s does.
"""
from __future__ import annotations

import time
from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.core.tree import TreeConfig, TreeState
from repro_torch.core.write import RepairQueue, WriteStats, write_phase

MEM_AXIS = "model"       # the mem pool shards over the TP/model axis
DATA_AXIS = "data"

#: Bytes a broadcast moves at once (gloo stages a CUDA message through a
#: pinned host buffer of its size).
CHUNK_BYTES = 1 << 28

I32 = torch.int32


def tree_pspecs(cfg: TreeConfig) -> TreeState:
    """Partition specs (``PartitionSpec`` stand-ins: entry i names the mesh
    axis that splits dim i, ``()`` is replicated): pool rows over the mem
    axis, lock tables likewise."""
    row = (MEM_AXIS,)
    return TreeState(
        keys=row, vals=row, fev=row, rev=row, fnv=row, rnv=row,
        level=row, fence_lo=row, fence_hi=row, sibling=row, free_bit=row,
        glt=(MEM_AXIS, None), root=(), height=(),
        alloc_next=(MEM_AXIS,), alloc_rr=(),
    )


def _is_sharded(spec) -> bool:
    return bool(spec) and spec[0] == MEM_AXIS


def shard_tree(st: TreeState, mesh, cfg: TreeConfig) -> TreeState:
    """This rank's local state on ``mesh.device``: its block of every field
    sharded over ``model`` (rows ``[j N/model, (j+1) N/model)`` on mem rank
    ``j``), and copies of the replicated fields.  Every tensor is a copy,
    so ``st`` may be freed afterwards."""
    j, k = mesh.axis_index(MEM_AXIS), mesh.shape[MEM_AXIS]
    out = []
    for name, x, spec in zip(TreeState._fields, st, tree_pspecs(cfg)):
        if _is_sharded(spec):
            n = x.shape[0]
            if n % k:
                raise ValueError(f"{name}: {n} rows do not split over {k} "
                                 "mem ranks")
            x = x[j * (n // k):(j + 1) * (n // k)]
        out.append(x.to(mesh.device, copy=True).contiguous())
    return TreeState(*out)


def _check_mesh(cfg: TreeConfig, mesh) -> None:
    """The port's one guard: the reference's ``owner = rows //
    nodes_per_ms`` counts memory servers while each device holds ``N /
    model`` rows, so its lookups read wrong rows unless ``model ==
    n_ms``; here that raises."""
    if mesh.shape[MEM_AXIS] != cfg.n_ms:
        raise ValueError(
            f"the pool shards one memory server a mem rank: the mesh has "
            f"{mesh.shape[MEM_AXIS]} along {MEM_AXIS!r} but cfg.n_ms is "
            f"{cfg.n_ms}")


def _check_block(cfg: TreeConfig, st_local: TreeState) -> None:
    if st_local.keys.shape[0] != cfg.nodes_per_ms:
        raise ValueError(f"a rank holds one memory server's "
                         f"{cfg.nodes_per_ms} rows, got "
                         f"{st_local.keys.shape[0]}")


# --------------------------------------------------------------------------
# routed one-sided primitives (every rank of the mesh)
# --------------------------------------------------------------------------

def _remote_read_rows(cfg: TreeConfig, mesh, local: TreeState,
                      rows: torch.Tensor) -> dict:
    """Read arbitrary global pool rows from their owning mem ranks.

    ``local`` holds this rank's row block [N/n_ms, ...]; ``rows`` (global
    ids) is the same on every rank of the mem row, so each owner serves
    its rows and one all_reduce combines them — the collective analogue of
    a one-sided RDMA_READ (one "round trip").  The fields travel packed as
    int32: each lane's come from at most one rank and the others add
    zeros, so the sum is exact; a row no rank owns reads as zeros.
    """
    me = mesh.axis_index(MEM_AXIS)
    owner = torch.div(rows, cfg.nodes_per_ms, rounding_mode="floor")
    mine = owner == me
    local_idx = torch.where(mine, torch.remainder(rows, cfg.nodes_per_ms),
                            0).long()
    node = torch.stack([local.fnv[local_idx].to(I32),
                        local.rnv[local_idx].to(I32),
                        local.level[local_idx].to(I32),
                        local.free_bit[local_idx].to(I32)], dim=1)
    packed = torch.cat([local.keys[local_idx], local.vals[local_idx],
                        local.fev[local_idx].to(I32),
                        local.rev[local_idx].to(I32), node], dim=1)
    packed = torch.where(mine[:, None], packed, 0)
    dist.all_reduce(packed, group=mesh.mem_group)
    f = cfg.fanout
    keys, vals, fev, rev, node = packed.split([f, f, f, f, 4], dim=1)
    u8 = torch.uint8
    return dict(
        keys=keys.contiguous(), vals=vals.contiguous(),
        fev=fev.to(u8).contiguous(), rev=rev.to(u8).contiguous(),
        fnv=node[:, 0].to(u8).contiguous(),
        rnv=node[:, 1].to(u8).contiguous(),
        level=node[:, 2].contiguous(), free=node[:, 3] != 0)


class RoutedLookupResult(NamedTuple):
    value: torch.Tensor
    found: torch.Tensor
    consistent: torch.Tensor
    leaf: torch.Tensor


def _routed_lookup_body(cfg: TreeConfig, mesh, st_local: TreeState,
                        cache: dict, qkeys: torch.Tensor,
                        depth: int) -> RoutedLookupResult:
    """Per-rank body: traverse the replicated cache image, then one routed
    remote read of the target leaves (the paper's cache-hit fast path: a
    single RDMA_READ), searched by the leaf-search kernel."""
    from repro_torch.core.cache import descend_image
    from repro_torch.kernels.leaf_search.kernel import leaf_search
    # miss lanes resume from the frontier (first uncached node on the path)
    node, _, _ = descend_image(cache, qkeys, max(depth, cfg.max_height))
    img = _remote_read_rows(cfg, mesh, st_local, node)
    # a fetched non-leaf (cache too shallow / evicted level-1 node) must
    # not answer: its separators alias real keys and its "values" are
    # child pointers.  The kernel's node check is (fnv == rnv) & (free ==
    # 0), so folding level != 0 into free adds the reference's level == 0.
    free = (img["free"] | (img["level"] != 0)).to(I32)
    value, found, consistent = leaf_search(
        qkeys.to(I32).contiguous(), img["keys"], img["vals"], img["fev"],
        img["rev"], img["fnv"].to(I32), img["rnv"].to(I32), free)
    return RoutedLookupResult(value=value, found=found,
                              consistent=consistent, leaf=node)


def build_cache(cfg: TreeConfig, st: TreeState, depth: int = 2,
                max_rows: int | None = None) -> dict:
    """Replicated CS-side image of the top ``depth`` tree levels — a thin
    wrapper over :func:`repro_torch.core.cache.fill_image`, the single
    source of image construction (paper §4.2.3).  The default row budget
    is the reference's ``1 + F^(depth-1) + F^depth``; at a deployment's
    size give it explicitly."""
    from repro_torch.core.cache import fill_image
    if max_rows is None:
        max_rows = 1 + cfg.fanout ** (depth - 1) + cfg.fanout ** depth
    image, _ = fill_image(cfg, st, levels=depth, max_rows=max_rows)
    return image


def routed_lookup_fn(cfg: TreeConfig, mesh, depth: int = 2):
    """The routed lookup, as a function of ``(st_local, cache,
    qkeys_local)``: the rank's block (:func:`shard_tree`), the replicated
    image (:func:`build_cache`) and the rank's data shard of the keys.
    Each rank returns its data shard's result, the same across its mem
    row.  Raises unless ``mesh.shape['model'] == cfg.n_ms``."""
    _check_mesh(cfg, mesh)

    def fn(st_local: TreeState, cache: dict, qkeys: torch.Tensor
           ) -> RoutedLookupResult:
        _check_block(cfg, st_local)
        return _routed_lookup_body(cfg, mesh, st_local, cache, qkeys, depth)

    return fn


# --------------------------------------------------------------------------
# pjit path: the verified single-pool phase on a gathered pool
# --------------------------------------------------------------------------

def _bcast(t: torch.Tensor, src: int, group) -> None:
    """Broadcast ``t`` in place as raw bytes, :data:`CHUNK_BYTES` at a
    time."""
    if not t.is_contiguous():
        raise ValueError("broadcast needs a contiguous tensor")
    flat = t.reshape(-1).view(torch.uint8)
    for lo in range(0, flat.numel(), CHUNK_BYTES):
        dist.broadcast(flat[lo:lo + CHUNK_BYTES], src, group=group)


#: WriteStats fields that are per-lane bool (the rest are int32).
_BOOL_STATS = frozenset((
    "applied_update", "applied_delete", "applied_insert", "miss_delete",
    "superseded", "deferred", "local_head", "cycle_head", "chain_end",
    "split_mask", "split_same_ms"))
_SCALAR_STATS = ("n_leaf_splits", "n_internal_splits", "n_root_splits",
                 "n_split_same_ms", "hocl_remote_cas", "flat_remote_cas",
                 "handovers", "repair_backlog")
_LANE_STATS = tuple(n for n in WriteStats._fields if n not in _SCALAR_STATS)
_REPLICATED = ("root", "height", "alloc_rr")


def _pack_outputs(st: TreeState, done, stats: WriteStats,
                  rq: RepairQueue) -> torch.Tensor:
    """The coordinator's replicated scalars and whole-wave outputs as one
    int32 vector."""
    for n in _LANE_STATS + _SCALAR_STATS:
        x = getattr(stats, n)
        want = torch.bool if n in _BOOL_STATS else I32
        if x.dtype != want or x.ndim != (1 if n in _LANE_STATS else 0):
            raise TypeError(f"WriteStats.{n}: {x.dtype} {tuple(x.shape)}")
    head = torch.stack([getattr(st, n).to(I32) for n in _REPLICATED]
                       + [getattr(stats, n).to(I32) for n in _SCALAR_STATS])
    lanes = torch.stack([done.to(I32)] + [getattr(stats, n).to(I32)
                                         for n in _LANE_STATS])
    q = torch.stack([x.to(I32) for x in rq])
    return torch.cat([head, lanes.reshape(-1), q.reshape(-1)])


def _unpack_outputs(packed: torch.Tensor, b: int, q: int, shard: int,
                    b_local: int, q_local: int):
    """This rank's replicated scalars and data shard of the outputs."""
    nh = len(_REPLICATED) + len(_SCALAR_STATS)
    nl = 1 + len(_LANE_STATS)
    head = packed[:nh]
    lanes = packed[nh:nh + nl * b].view(nl, b)
    lanes = lanes[:, shard * b_local:(shard + 1) * b_local]
    rq = packed[nh + nl * b:].view(4, q)[:, shard * q_local:
                                         (shard + 1) * q_local]
    scalars = dict(zip(_REPLICATED, head[:len(_REPLICATED)]))
    fields = dict(zip(_SCALAR_STATS, head[len(_REPLICATED):]))
    for n, x in zip(_LANE_STATS, lanes[1:]):
        fields[n] = (x != 0) if n in _BOOL_STATS else x.contiguous()
    done = lanes[0] != 0
    repair = RepairQueue(sep=rq[0].contiguous(), child=rq[1].contiguous(),
                         level=rq[2].contiguous(), valid=rq[3] != 0)
    return scalars, done, WriteStats(**fields), repair


def pjit_phase_fns(cfg: TreeConfig, mesh):
    """The single-pool write phase on the sharded state (baseline path).

    Returns ``wp(st_local, keys, vals, is_delete, active, cs, repair)``:
    the rank's block and its data shards of the wave (int32 keys, vals
    and cs, bool is_delete and active) and of the repair queue.  Every
    rank ends with the block, ``done``, ``stats`` and repair queue shards
    that :func:`repro_torch.core.write.write_phase` gives on the whole pool
    and the whole wave.  ``wp.split`` holds this rank's last call on the
    host clock (``gather_s``, ``write_phase_s``, ``send_s``, and the bytes
    of one block).  Collective: every rank of the process group calls
    this (it creates the transfer groups) and then every ``wp`` call.
    Raises unless ``mesh.shape['model'] == cfg.n_ms``.
    """
    _check_mesh(cfg, mesh)
    data, model = mesh.shape[DATA_AXIS], mesh.shape[MEM_AXIS]
    # every rank of the process group makes every group, in one order
    pair = {r: dist.new_group([0, r]) for r in range(1, mesh.size)}
    send = [mesh.col_groups[0]] + [
        dist.new_group(sorted({0} | {mesh.rank_of(i, j)
                                     for i in range(data)}))
        for j in range(1, model)]
    everyone = dist.new_group(list(range(mesh.size)))
    specs = tree_pspecs(cfg)
    sharded = [n for n, s in zip(TreeState._fields, specs) if _is_sharded(s)]
    i_me, j_me = mesh.axis_index(DATA_AXIS), mesh.axis_index(MEM_AXIS)
    coord = mesh.rank == 0

    def sync(dev):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def wp(st_local: TreeState, keys, vals, is_delete, active, cs,
           repair: RepairQueue | None = None):
        _check_block(cfg, st_local)
        dev = st_local.keys.device
        b_local = keys.shape[0]
        if repair is None:
            repair = RepairQueue.empty(b_local, dev)
        q_local = repair.sep.shape[0]
        b, q = b_local * data, q_local * data
        t0 = time.perf_counter()

        # 1. the data shards of the wave and the blocks, on the coordinator
        wave = torch.cat([torch.stack([keys.to(I32), vals.to(I32),
                                       is_delete.to(I32), active.to(I32),
                                       cs.to(I32)]).reshape(-1),
                          torch.stack([x.to(I32) for x in repair]
                                      ).reshape(-1)])
        if coord:
            waves = [wave]
            for i in range(1, data):
                got = torch.empty_like(wave)
                _bcast(got, mesh.rank_of(i, 0), pair[mesh.rank_of(i, 0)])
                waves.append(got)
            full = {}
            for n in sharded:
                x = getattr(st_local, n)
                k = x.shape[0]
                out = torch.empty((k * model,) + tuple(x.shape[1:]),
                                  dtype=x.dtype, device=dev)
                out[:k] = x
                full[n] = out
            for j in range(1, model):
                for n in sharded:
                    k = getattr(st_local, n).shape[0]
                    _bcast(full[n][j * k:(j + 1) * k], j, pair[j])
        elif j_me == 0:
            _bcast(wave, mesh.rank, pair[mesh.rank])
        elif i_me == 0:
            for n in sharded:
                _bcast(getattr(st_local, n), mesh.rank, pair[mesh.rank])
        sync(dev)
        t1 = time.perf_counter()

        # 2. the single-pool write phase on the coordinator
        nw = 5 * b_local
        if coord:
            parts = [w[:nw].view(5, b_local) for w in waves]
            lanes = torch.cat(parts, dim=1)
            rqs = torch.cat([w[nw:].view(4, q_local) for w in waves], dim=1)
            st_full = TreeState(**full, **{n: getattr(st_local, n)
                                           for n in _REPLICATED})
            st_full, done, stats, rq = write_phase(
                cfg, st_full, lanes[0].contiguous(), lanes[1].contiguous(),
                lanes[2] != 0, lanes[3] != 0, lanes[4].contiguous(),
                RepairQueue(sep=rqs[0].contiguous(),
                            child=rqs[1].contiguous(),
                            level=rqs[2].contiguous(), valid=rqs[3] != 0))
            packed = _pack_outputs(st_full, done, stats, rq)
            del full
        else:
            nh = len(_REPLICATED) + len(_SCALAR_STATS)
            packed = torch.empty(nh + (1 + len(_LANE_STATS)) * b + 4 * q,
                                 dtype=I32, device=dev)
        sync(dev)
        t2 = time.perf_counter()

        # 3. every block back to its mem column, the outputs to every rank
        for j in range(model):
            if not (coord or j_me == j):
                continue
            for n in sharded:
                mine = getattr(st_local, n)
                if coord:
                    k = mine.shape[0]
                    block = getattr(st_full, n)[j * k:(j + 1) * k]
                    if j == 0:
                        mine.copy_(block)
                    _bcast(block, 0, send[j])
                else:
                    _bcast(mine, 0, send[j])
        if coord:
            del st_full
        _bcast(packed, 0, everyone)
        scalars, done, stats, rq = _unpack_outputs(packed, b, q, i_me,
                                                   b_local, q_local)
        for n, v in scalars.items():
            getattr(st_local, n).copy_(v)
        sync(dev)
        t3 = time.perf_counter()
        wp.split = dict(gather_s=t1 - t0, write_phase_s=t2 - t1,
                        send_s=t3 - t2,
                        block_bytes=sum(getattr(st_local, n).nbytes
                                        for n in sharded))
        return st_local, done, stats, rq

    wp.split = {}
    return wp
