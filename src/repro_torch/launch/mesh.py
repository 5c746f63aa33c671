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
card cannot hold two NCCL ranks, so a mesh on one card runs on ``gloo``,
whose CUDA side takes ``broadcast``, ``all_reduce`` and ``barrier``.

The reference's production mesh (the 16 x 16 TPU pod) and its hardware
constants come with the LM scaffold; nothing of them is carried over.
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
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing

from repro_torch.device import resolve_device


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

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["model"]

    def rank_of(self, data: int, model: int) -> int:
        return data * self.shape["model"] + model

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
    r = dist.get_rank()
    coords = dict(data=r // model, model=r % model) \
        if r < data * model else None
    return Mesh(shape=OrderedDict(data=data, model=model), rank=r,
                coords=coords, device=_rank_device(device), row_groups=rows,
                col_groups=cols)


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


__all__ = ["Mesh", "MeshRanks", "make_host_mesh", "run_mesh", "start_mesh",
           "to_host"]
