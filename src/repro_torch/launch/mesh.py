"""Host mesh: ``torch.distributed`` ranks laid out as a (data, model) grid.

The PyTorch counterpart of :func:`repro.launch.mesh.make_host_mesh`, and
the port's stand-in for ``jax.sharding.Mesh`` on the sharded index's path
(:mod:`repro_torch.core.sharded`).  A mesh of shape ``(data, model)`` is
``data * model`` processes, one rank each; rank ``r`` sits at
``(r // model, r % model)``, the row-major order of
``jax.make_mesh((data, model), ...)``.  Every rank holds one process group
per *mem row* (the ranks of one ``data`` index, over which the reference's
``psum(..., "model")`` runs) and one per *data column* (the ranks of one
``model`` index).

:func:`start_mesh` / :func:`run_mesh` start the ranks with
``torch.multiprocessing`` (``spawn``: the parent may hold a CUDA context)
and run one function on each.  They rendezvous through a file in a fresh
temporary directory, so concurrent launches never race for a port, and
take the backend by name: nothing is chosen by catching a failure.  One
card cannot hold two NCCL ranks, so a mesh on one card runs on ``gloo``.

What gloo takes (``python scripts/gloo_probe.py``; torch 2.13.0+cpu on
CPU tensors, torch 2.11.0+cu128 on an H100's): ``all_reduce``,
``broadcast``, ``all_gather_into_tensor``, ``all_gather``,
``reduce_scatter_tensor`` and ``all_to_all_single``, each in float32,
bfloat16, int32 and uint8, on CPU and CUDA tensors alike.
:class:`Collectives`, the sharded train step's transport, so takes one
path on either device: an ``all_gather_into_tensor`` of raw bytes for
the weights (which come back bit for bit), an ``all_reduce`` in float32
for the gradients.

:func:`make_production_mesh` is the reference's mesh as a shape only (no
process is started; the dry-run planner counts one rank's program on
it), and the module holds the H100 SXM's data-sheet rates that the
roofline and the kernels' bounds divide by.  No TPU constant is carried
over.
"""
from __future__ import annotations

import dataclasses
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from collections import OrderedDict
from datetime import timedelta
from multiprocessing.reduction import ForkingPickler
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing

from repro_torch.device import resolve_device
from repro_torch.obs import spans

#: NVIDIA H100 SXM data sheet (dense rates, 700 W): HBM bytes/s, the
#: float32 rate outside the tensor cores, the bf16 tensor-core rate, and
#: NVLink 4's bytes/s a direction (900 GB/s both ways), the counterpart of
#: the reference's ICI term.
HBM_BYTES_S = 3.35e12
SCALAR_OPS_S = 67e12
BF16_TENSOR_OPS_S = 989e12
NVLINK_BYTES_S = 450e9


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a ``(data, model)`` mesh of processes."""

    shape: "OrderedDict[str, int]"   # {"data": d, "model": m}, as JAX's
    rank: int                        # this process's rank in the world
    coords: Optional[dict]           # {"data": i, "model": j}; None outside
    device: torch.device             # where this rank's tensors live
    row_groups: tuple                # per data index: ranks (i, 0..m-1)
    col_groups: tuple                # per model index: ranks (0..d-1, j)
    parent: Optional[object] = None  # the launcher's queue (start_mesh)
    ranks: Optional[tuple] = None    # world rank of each position, row-
                                     # major; None: position p is rank p
    group: Any = None                # the mesh's ranks; None: the world

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    def rank_of(self, data: int, model: int) -> int:
        p = data * self.shape["model"] + model
        return p if self.ranks is None else self.ranks[p]

    def axis_index(self, name: str) -> int:
        """This rank's index along ``name`` (``lax.axis_index``)."""
        if self.coords is None:
            raise ValueError(f"rank {self.rank} lies outside the "
                             f"{dict(self.shape)} mesh")
        return self.coords[name]

    def notify_parent(self, obj) -> None:
        """Send ``obj`` (tensors as numpy) to the process that started the
        ranks, which hands it to ``MeshRanks.join``'s ``on_message`` while
        the ranks run on."""
        if self.parent is None:
            raise RuntimeError("notify_parent needs a mesh made by "
                               "start_mesh's ranks")
        self.parent.put(("msg", self.rank, to_host(obj)))

    @property
    def mem_group(self):
        """The ranks sharing this rank's data index (the ``model`` axis)."""
        return self.row_groups[self.axis_index("data")]


def make_host_mesh(data: int = 1, model: int = 1, device=None) -> Mesh:
    """A small mesh over the ranks that exist, clamped as the reference
    clamps to its devices.  Collective: every rank of the initialised
    process group calls it, in the same order as its other group
    creations.  ``device=None`` is the card."""
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialised "
                           "torch.distributed process group (start_mesh "
                           "starts one a rank)")
    n = dist.get_world_size()
    data = min(data, n)
    model = min(model, max(1, n // data))
    rows = tuple(dist.new_group([i * model + j for j in range(model)])
                 for i in range(data))
    cols = tuple(dist.new_group([i * model + j for i in range(data)])
                 for j in range(model))
    group = None if data * model == n else dist.new_group(
        list(range(data * model)))
    r = dist.get_rank()
    coords = dict(data=r // model, model=r % model) \
        if r < data * model else None
    return Mesh(shape=OrderedDict(data=data, model=model), rank=r,
                coords=coords, device=_rank_device(device), row_groups=rows,
                col_groups=cols, group=group)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh as a shape: ``(16, 16)`` over
    ``("data", "model")``, or ``(2, 16, 16)`` with ``pod`` in front; rank
    0's view (every coordinate 0), on ``meta``, with no process group.
    Nothing is started: it exists for the dry-run planner."""
    shape = OrderedDict(pod=2, data=16, model=16) if multi_pod else \
        OrderedDict(data=16, model=16)
    return Mesh(shape=shape, rank=0, coords={a: 0 for a in shape},
                device=torch.device("meta"), row_groups=(), col_groups=())


# --------------------------------------------------------------------------
# the sharded train step's collectives
# --------------------------------------------------------------------------

class Collectives:
    """The collectives of the sharded train step on this rank of ``mesh``:
    :meth:`gather_model` (an all-gather over the rank's ``model`` row) and
    :meth:`all_reduce` (a sum over the whole mesh).  Each call's host
    seconds (the card synchronised before and after) add up in
    ``seconds``; each runs in the span ``rt/gather`` or ``rt/all_reduce``
    (:mod:`repro_torch.obs.spans`)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.seconds = {"gather": 0.0, "all_reduce": 0.0}

    def _timed(self, kind: str, t: torch.Tensor, fn) -> None:
        with spans.span(spans.PREFIX + kind):
            if t.is_cuda:
                torch.cuda.synchronize(t.device)
            t0 = time.perf_counter()
            fn()
            if t.is_cuda:
                torch.cuda.synchronize(t.device)
            self.seconds[kind] += time.perf_counter() - t0

    def gather_model(self, row: torch.Tensor) -> torch.Tensor:
        """``[m, *row.shape]``: row ``j`` is the ``row`` of the rank at
        model index ``j`` of this rank's data index."""
        m = self.mesh.shape["model"]
        if m == 1:
            return row[None]
        out = row.new_empty((m * row.numel(),))
        self._timed("gather", row, lambda: dist.all_gather_into_tensor(
            out, row.contiguous().view(-1), group=self.mesh.mem_group))
        return out.view((m,) + tuple(row.shape))

    def barrier(self) -> None:
        """Every rank of the mesh has reached this call."""
        if self.mesh.size > 1:
            dist.barrier(group=self.mesh.group)

    def all_reduce(self, buf: torch.Tensor) -> torch.Tensor:
        """``buf`` summed over every rank of the mesh, in place."""
        if self.mesh.size > 1:
            self._timed("all_reduce", buf, lambda: dist.all_reduce(
                buf, group=self.mesh.group))
        return buf


def _rank_device(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------

def to_host(obj):
    """``obj`` with every tensor replaced by a numpy copy (NamedTuples,
    tuples, lists and dicts walked): what a rank sends its launcher."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*[to_host(x) for x in obj])
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_host(x) for x in obj)
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    return obj


def _rank_main(rank, world, data, model, backend, init_file, device,
               timeout_s, inbox, parent):
    try:
        fn, args = ForkingPickler.loads(inbox.get())
        torch.set_num_threads(1)
        dev = _rank_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"file://{init_file}",
                                world_size=world, rank=rank,
                                timeout=timedelta(seconds=timeout_s))
        mesh = dataclasses.replace(make_host_mesh(data, model, dev),
                                   parent=parent)
        parent.put(("ok", rank, to_host(fn(mesh, *args))))
    except Exception:       # the rank's boundary: report, then exit
        parent.put(("err", rank, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class MeshRanks:
    """Ranks started by :func:`start_mesh`; :meth:`join` collects them."""

    def __init__(self, procs, inbox, parent, tmpdir: str, timeout: float):
        # the queues live as long as the ranks: a queue's semaphores are
        # unlinked when it is collected, and a rank may not have opened
        # them yet
        self.procs, self.inbox, self.parent = procs, inbox, parent
        self.tmpdir, self.timeout = tmpdir, timeout

    def join(self, on_message: Optional[Callable] = None) -> list:
        """Every rank's result, in rank order.  Raises with the rank's
        traceback when one fails, exits without a result, or the ranks
        are not done within the launch's timeout; every rank still alive
        is then killed."""
        world = len(self.procs)
        deadline = time.monotonic() + self.timeout
        results: dict = {}
        try:
            while len(results) < world:
                try:
                    kind, rank, payload = self.parent.get(timeout=0.5)
                except queue_mod.Empty:
                    self._check_alive(results, deadline)
                    continue
                if kind == "err":
                    raise RuntimeError(f"rank {rank} of {world} failed:\n"
                                       f"{payload}")
                if kind == "msg":
                    if on_message is not None:
                        on_message(rank, payload)
                    continue
                results[rank] = payload
            for p in self.procs:
                p.join(max(0.1, deadline - time.monotonic()))
            if any(p.is_alive() for p in self.procs):
                raise TimeoutError(f"mesh ranks did not exit within "
                                   f"{self.timeout} s")
            return [results[r] for r in range(world)]
        finally:
            self.close()

    def _check_alive(self, results: dict, deadline: float) -> None:
        dead = [(r, p.exitcode) for r, p in enumerate(self.procs)
                if p.exitcode not in (None, 0) and r not in results]
        if dead:
            try:     # its traceback may still be in flight
                kind, rank, payload = self.parent.get(timeout=2.0)
                if kind == "err":
                    raise RuntimeError(f"rank {rank} of {len(self.procs)} "
                                       f"failed:\n{payload}")
            except queue_mod.Empty:
                pass
            raise RuntimeError(f"rank {dead[0][0]} exited with code "
                               f"{dead[0][1]} before it reported")
        if time.monotonic() > deadline:
            missing = [r for r in range(len(self.procs)) if r not in results]
            raise TimeoutError(f"ranks {missing} of {len(self.procs)} did "
                               f"not finish within {self.timeout} s")

    def close(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.kill()
        for p in self.procs:
            p.join(5.0)
        # a payload no rank read must not hold the feeder thread (and
        # this process's exit) on a full pipe
        self.inbox.cancel_join_thread()
        self.inbox.close()
        shutil.rmtree(self.tmpdir, ignore_errors=True)


def start_mesh(fn: Callable, data: int, model: int, *, backend: str,
               args: tuple = (), device=None,
               timeout: float = 600.0) -> MeshRanks:
    """Start ``data * model`` ranks, each running ``fn(mesh, *args)``.

    ``fn`` and ``args`` must pickle (``fn`` at a module's top level); CUDA
    tensors in ``args`` reach the ranks as CUDA IPC handles onto the
    caller's memory.  ``backend`` is ``torch.distributed``'s (``"gloo"``
    on the CPU and for several ranks on one card).  ``device=None`` puts
    every rank on the card (``cuda:0``), and raises without one.  Each rank
    runs one intra-op thread.  A rank's result has its tensors turned into
    numpy arrays (:func:`to_host`).
    """
    if not isinstance(backend, str) or not backend:
        raise ValueError("start_mesh needs the backend by name, e.g. 'gloo'")
    _rank_device(device)           # raise here, not in every rank
    world = data * model
    if world < 1:
        raise ValueError(f"a ({data}, {model}) mesh has no ranks")
    # one pickle a rank, made here so a failure raises here; the ranks
    # get it from a queue once all have started (args given to a spawned
    # Process are written to its pipe in start(), which blocks until the
    # child has imported its modules, so the ranks would start one by one)
    payloads = [bytes(ForkingPickler.dumps((fn, args)))
                for _ in range(world)]
    ctx = torch.multiprocessing.get_context("spawn")
    tmpdir = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    init_file = os.path.join(tmpdir, "rendezvous")
    inbox, parent = ctx.Queue(), ctx.Queue()
    procs = []
    try:
        for rank in range(world):
            p = ctx.Process(target=_rank_main, daemon=True, args=(
                rank, world, data, model, backend, init_file, device,
                timeout, inbox, parent))
            p.start()
            procs.append(p)
        for payload in payloads:
            inbox.put(payload)
    except BaseException:
        MeshRanks(procs, inbox, parent, tmpdir, timeout).close()
        raise
    return MeshRanks(procs, inbox, parent, tmpdir, timeout)


def run_mesh(fn: Callable, data: int, model: int, *, backend: str,
             args: tuple = (), device=None, timeout: float = 600.0) -> list:
    """:func:`start_mesh`, then every rank's result in rank order."""
    return start_mesh(fn, data, model, backend=backend, args=args,
                      device=device, timeout=timeout).join()


__all__ = ["BF16_TENSOR_OPS_S", "Collectives", "HBM_BYTES_S", "Mesh",
           "MeshRanks", "NVLINK_BYTES_S", "SCALAR_OPS_S", "make_host_mesh",
           "make_production_mesh", "run_mesh", "start_mesh", "to_host"]
