"""Training launcher: the train step, its sharded form, and the
fault-tolerant loop.  The port of :mod:`repro.launch.train`.

``make_train_step`` builds the (model, opt_state, batch) -> (model,
opt_state, metrics) step: ``api.loss`` and its backward (the attention and
WKV6 kernels' backward kernels on the card), optional gradient
compression, and AdamW over the weights in the reference's leaf order.
``run`` drives it with checkpoint/restore, auto-resume, a straggler
watchdog and the reference's log lines (``ckpt_every`` 0 saves no
checkpoint, where the reference's modulo would raise), and also returns
each step's seconds on the host clock (``step_seconds``, the watchdog's
reading: from the end of one step, its loss read back, to the end of the
next).  The
checkpoint holds the reference's tree, ``(params, AdamWState(step, m,
v))`` with every layer leaf stacked [L, ...], so a checkpoint of either
package restores in the other.  The model and the moments are updated
in place, where the reference's jitted step donates them.

``shard_train_fns`` is the step on a mesh of ``torch.distributed`` ranks
(:mod:`repro_torch.launch.mesh`), each rank calling it with its view of
the mesh.  It computes the function ``make_train_step`` computes, under
the reference's specs (:mod:`repro_torch.parallel.sharding`): a rank
holds its block of every parameter and of both AdamW moments
(:class:`Sharded`).  A step gathers the blocks over the rank's ``model``
row into the rank's whole model, runs ``api.loss`` and its backward on the
rank's rows of the batch (the batch over the data axes as
``batch_pspecs`` puts it, a row's share split among its ``model`` ranks),
sums the gradients and the loss over the whole mesh and divides by the
number of ranks, so the gradient norm and the clipping see the whole
gradient, and updates only the rank's blocks.  Where the batch does not
divide, or in an MoE config (an expert's capacity counts the whole
batch's tokens), every rank computes the whole batch: the sum over the
ranks divided by their number is then that batch's gradient.  ``run``
on a mesh is called on every rank: rank 0 saves the gathered reference
tree, the checkpoint a single-device run writes, and on resume every rank
restores it and keeps its blocks.

Usage (CPU, a reduced model; the card is the default device):
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --reduced --device cpu --steps 4 --batch 2 --seq 16
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import configs as cfglib
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.tokens import synthetic_batches
from repro_torch.launch.mesh import Collectives, Mesh
from repro_torch.models.common import (flat_params, tree_from_host,
                                       tree_map, tree_to_host)
from repro_torch.models.registry import ModelAPI, build
from repro_torch.obs import spans
from repro_torch.optim import adamw
from repro_torch.optim.compression import compress_grads
from repro_torch.parallel import sharding as sh


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50             # 0: no checkpoint is saved
    ckpt_dir: str = "checkpoints"
    keep: int = 3
    grad_compression: str = "none"   # none | int8
    straggler_factor: float = 3.0    # step-time watchdog threshold
    opt: adamw.AdamWConfig = dataclasses.field(
        default_factory=adamw.AdamWConfig)


def make_train_step(api: ModelAPI, opt_cfg: adamw.AdamWConfig,
                    compression: str = "none") -> Callable:
    def step(model, opt_state, batch):
        with spans.span(spans.STEP):
            params = flat_params(api.param_tree(model))
            for p in params:
                p.grad = None
            with spans.span(spans.FORWARD):
                loss = api.loss(model, batch)
            with spans.span(spans.BACKWARD):
                loss.backward()
            grads = [p.grad for p in params]  # None: a leaf loss misses
            if compression != "none":
                grads = compress_grads(grads, compression)
            _, opt_state, info = adamw.update(opt_cfg, grads, opt_state,
                                              params)
            for p in params:
                p.grad = None
            metrics = dict(loss=loss.detach(), grad_norm=info["grad_norm"],
                           lr=info["lr"])
            return model, opt_state, metrics

    return step


# --------------------------------------------------------------------------
# the step on a mesh
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Sharded:
    """This rank's blocks of a list of tensors laid out on ``mesh`` like a
    model's parameters: ``blocks[k]`` is this rank's block of the k-th
    tensor of ``flat_params(tree)`` (of its values, or of one of its AdamW
    moments) under ``specs[k]`` (``sharding.flat_pspecs``); a replicated
    tensor's block is the whole tensor.  None on a rank outside the
    mesh."""

    tree: Any                  # the model's param_tree: names, full shapes
    mesh: Mesh
    specs: list
    blocks: Optional[list]


def _sharded_dim(spec) -> Optional[int]:
    """The dim a parameter spec shards (over ``model``), or None."""
    dims = [d for d, e in enumerate(spec) if e is not None]
    if not dims:
        return None
    if len(dims) > 1 or spec[dims[0]] != sh.MODEL:
        raise ValueError(f"spec {spec}: a parameter shards one dim over "
                         f"{sh.MODEL!r}")
    return dims[0]


def shard(tree, values: list, mesh: Mesh) -> Sharded:
    """This rank's blocks of ``values`` (whole tensors in ``flat_params``
    order): a sharded tensor's block copied out, a replicated one as it
    is."""
    specs = sh.flat_pspecs(tree, mesh)
    blocks = None if mesh.coords is None else [
        v if _sharded_dim(s) is None else
        v.detach()[sh.block_slices(v.shape, s, mesh)].clone()
        for v, s in zip(values, specs)]
    return Sharded(tree, mesh, specs, blocks)


def gather(x: Sharded, comm: Collectives, into: Optional[list] = None
           ) -> list:
    """Every tensor whole, from the blocks of the ranks of this rank's
    ``model`` row: one collective (``comm.gather_model``) of the sharded
    blocks' raw bytes, a rank a row (each block at a 4-byte boundary).
    Written into ``into`` (whole tensors) where given; a replicated
    tensor is its block."""
    full = list(x.blocks)
    idx = [k for k, s in enumerate(x.specs) if _sharded_dim(s) is not None]
    if not idx:
        return full
    raw = [x.blocks[k].detach().contiguous().view(-1).view(torch.uint8)
           for k in idx]
    pad = [(-r.numel()) % 4 for r in raw]
    rows = comm.gather_model(torch.cat([t for r, p in zip(raw, pad)
                                        for t in (r, r.new_zeros(p))]))
    m = rows.shape[0]
    at = 0
    for k, r, p in zip(idx, raw, pad):
        blk = x.blocks[k]
        parts = rows[:, at:at + r.numel()].view(blk.dtype).reshape(
            (m,) + tuple(blk.shape))
        at += r.numel() + p
        whole = torch.cat(list(parts), dim=_sharded_dim(x.specs[k]))
        if into is None:
            full[k] = whole
        else:
            with torch.no_grad():
                into[k].copy_(whole)
            full[k] = into[k]
    return full


def rank_rows(cfg, b: int, mesh: Mesh) -> slice:
    """This rank's rows of a batch of ``b``: the batch over the data axes
    where ``batch_pspecs`` shards it, each data index's rows split among
    its ``model`` ranks where they divide; the whole batch where it does
    not divide or in an MoE config (capacity counts the batch's
    tokens)."""
    dp = sh.dp_axes(mesh)
    d = 1
    i = 0
    for a in dp:
        d *= mesh.shape[a]
        i = i * mesh.shape[a] + mesh.axis_index(a)
    if cfg.is_moe or b % d or b < d:
        return slice(0, b)
    per = b // d
    m = mesh.shape[sh.MODEL]
    if per % m or per < m:
        return slice(i * per, (i + 1) * per)
    j = mesh.axis_index(sh.MODEL)
    return slice(i * per + j * (per // m), i * per + (j + 1) * (per // m))


class ShardedStep:
    """``make_train_step``'s function on this rank of ``mesh``:
    ``step(params, opt_state, batch) -> (params, opt_state, metrics)``
    with ``params`` and the state's moments :class:`Sharded` and
    ``batch`` the whole batch (the step takes its rows).  ``model`` is
    the rank's whole model: a step gathers the weights into it before the
    loss.  ``comm`` (a :class:`~repro_torch.launch.mesh.Collectives` by
    default) carries the gather and the gradient's sum."""

    def __init__(self, api: ModelAPI, mesh: Mesh, model,
                 opt_cfg: adamw.AdamWConfig, compression: str = "none",
                 comm=None):
        self.api, self.mesh, self.model = api, mesh, model
        self.opt_cfg, self.compression = opt_cfg, compression
        self.tree = api.param_tree(model)
        self.params = flat_params(self.tree)
        self.comm = comm or Collectives(mesh)

    def shard_params(self) -> Sharded:
        """This rank's blocks of the model's weights (a replicated
        weight's block is the model's own tensor)."""
        return shard(self.tree, self.params, self.mesh)

    def shard_opt(self, opt_state: Optional[adamw.AdamWState] = None
                  ) -> adamw.AdamWState:
        """The AdamW state with this rank's blocks of the moments: of
        ``opt_state``'s whole moments, or zero at step 0 when None."""
        if opt_state is None:
            specs = sh.flat_pspecs(self.tree, self.mesh)
            zeros = lambda: Sharded(self.tree, self.mesh, specs, [
                torch.zeros([b.stop - b.start for b in sh.block_slices(
                    p.shape, sp, self.mesh)], dtype=torch.float32,
                    device=p.device) for p, sp in zip(self.params, specs)])
            return adamw.AdamWState(
                step=torch.zeros((), dtype=torch.int32,
                                 device=self.params[0].device),
                m=zeros(), v=zeros())
        return opt_state._replace(
            m=shard(self.tree, opt_state.m, self.mesh),
            v=shard(self.tree, opt_state.v, self.mesh))

    def gather_params(self, params: Sharded) -> None:
        """The whole weights into the model."""
        gather(params, self.comm, into=self.params)

    def checkpoint_tree(self, params: Sharded, opt_state: adamw.AdamWState):
        """:func:`checkpoint_tree` of the gathered weights and moments
        (collective over the mesh's ranks; the model ends up current)."""
        self.gather_params(params)
        return checkpoint_tree(self.api, self.model, opt_state._replace(
            m=gather(opt_state.m, self.comm),
            v=gather(opt_state.v, self.comm)))

    def __call__(self, params: Sharded, opt_state: adamw.AdamWState,
                 batch: dict):
        with spans.span(spans.STEP):
            return self._step(params, opt_state, batch)

    def _step(self, params: Sharded, opt_state: adamw.AdamWState,
              batch: dict):
        self.gather_params(params)
        first = next(iter(batch.values()))
        rows = rank_rows(self.api.cfg, first.shape[0], self.mesh)
        for p in self.params:
            p.grad = None
        with spans.span(spans.FORWARD):
            loss = self.api.loss(self.model, {k: v[rows]
                                              for k, v in batch.items()})
        with spans.span(spans.BACKWARD):
            loss.backward()
        # every gradient (zero where the loss misses a leaf) and the loss,
        # summed over the mesh in one f32 buffer
        buf = torch.zeros(sum(p.numel() for p in self.params) + 1,
                          dtype=torch.float32, device=loss.device)
        at = 0
        for p in self.params:
            if p.grad is not None:
                buf[at:at + p.numel()].copy_(p.grad.reshape(-1))
            p.grad = None
            at += p.numel()
        buf[-1] = loss.detach()
        self.comm.all_reduce(buf)
        buf /= self.mesh.size
        grads, at = [], 0
        for p in self.params:      # the whole gradient, in the param dtype
            grads.append(buf[at:at + p.numel()].view(p.shape).to(p.dtype))
            at += p.numel()
        if self.compression != "none":
            grads = compress_grads(grads, self.compression)
        gn = adamw.global_norm(grads)
        g_blocks = [g if _sharded_dim(s) is None else
                    g[sh.block_slices(g.shape, s, self.mesh)]
                    for g, s in zip(grads, params.specs)]
        _, st, info = adamw.update(
            self.opt_cfg, g_blocks,
            opt_state._replace(m=opt_state.m.blocks, v=opt_state.v.blocks),
            params.blocks, grad_norm=gn)
        metrics = dict(loss=buf[-1], grad_norm=gn, lr=info["lr"])
        return params, st._replace(m=opt_state.m, v=opt_state.v), metrics


def shard_train_fns(api: ModelAPI, mesh: Mesh, model, opt_state, batch,
                    opt_cfg, compression="none"):
    """The step on this rank of ``mesh`` (:class:`ShardedStep`) and the
    specs it holds the state and reads the batch by: ``(step, (p_spec,
    o_spec, b_spec))`` as the reference returns them (``opt_state``, as
    there, is not read: the moments' specs are the parameters')."""
    p_spec = sh.params_pspecs(api.param_tree(model), mesh)
    o_spec = adamw.AdamWState(step=sh.P(), m=p_spec, v=p_spec)
    b_spec = sh.batch_pspecs(batch, mesh)
    return (ShardedStep(api, mesh, model, opt_cfg, compression),
            (p_spec, o_spec, b_spec))


class StragglerWatchdog:
    """EWMA step-time monitor — flags steps that exceed factor×mean.

    On real fleets this feeds the controller that re-schedules slow hosts;
    here it logs and counts (exercised by tests with an injected delay)."""

    def __init__(self, factor: float = 3.0):
        self.factor = factor
        self.ewma: Optional[float] = None
        self.flagged = 0

    def observe(self, dt: float) -> bool:
        slow = self.ewma is not None and dt > self.factor * self.ewma
        self.ewma = dt if self.ewma is None else 0.9 * self.ewma + 0.1 * dt
        if slow:
            self.flagged += 1
        return slow


def checkpoint_tree(api: ModelAPI, model, opt_state: adamw.AdamWState):
    """``(params, AdamWState(step, m, v))`` in the reference's tree, each
    layer leaf stacked on the host (numpy; bfloat16 leaves as CPU
    tensors)."""
    tree = api.param_tree(model)
    params = flat_params(tree)
    moment = lambda ms: (lambda p, of=dict(zip(map(id, params), ms)):
                         of[id(p)])
    return (tree_to_host(tree),
            adamw.AdamWState(
                step=opt_state.step.detach().cpu().numpy(),
                m=tree_to_host(tree, moment(opt_state.m), torch.float32),
                v=tree_to_host(tree, moment(opt_state.v), torch.float32)))


def checkpoint_template(api: ModelAPI, model):
    """The checkpoint's structure with ``meta`` leaves of each leaf's shape,
    for :meth:`CheckpointManager.restore`."""
    tree = api.param_tree(model)
    meta = lambda dtype=None: (lambda x: torch.empty(
        x.shape, dtype=dtype or x.dtype, device="meta"))
    moments = tree_map(meta(torch.float32), tree)
    return (tree_map(meta(), tree),
            adamw.AdamWState(step=torch.empty((), dtype=torch.int32,
                                              device="meta"),
                             m=moments, v=moments))


def load_checkpoint(api: ModelAPI, model, opt_state: adamw.AdamWState,
                    restored) -> adamw.AdamWState:
    """Copy a restored checkpoint into ``model`` and ``opt_state``'s
    moments in place; returns the state with the restored step."""
    tree = api.param_tree(model)
    params = flat_params(tree)
    tree_params, st = restored
    tree_from_host(tree, tree_params)
    for ms, loaded in ((opt_state.m, st.m), (opt_state.v, st.v)):
        of = dict(zip(map(id, params), ms))
        tree_from_host(tree, loaded, lambda p, of=of: of[id(p)])
    step = torch.as_tensor(np.asarray(st.step), dtype=torch.int32)
    return opt_state._replace(step=step.to(opt_state.step.device))


def _on_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def run(api: ModelAPI, train_cfg: TrainConfig, mesh: Optional[Mesh] = None,
        batch_size: int = 8, seq: int = 256, seed: int = 0,
        data_iter=None, verbose: bool = True) -> dict:
    """Fault-tolerant training loop with auto-resume, on ``api.device``;
    on a ``mesh`` of more than one rank, called on every rank, the step
    is :func:`shard_train_fns`' (rank 0 logs and saves the checkpoint).
    Returns the losses, grad norms and host seconds a step, the model
    (gathered whole on a mesh), the AdamW state (the rank's blocks of the
    moments on a mesh) and, on a mesh, the rank's blocks of the weights
    (``shards``) and each step's collective host seconds by kind
    (``collective_seconds``: the gather, the gradients' all-reduce)."""
    dev = api.device
    sharded = mesh is not None and mesh.size > 1
    model = api.init(torch.Generator(device=dev).manual_seed(seed))
    params = flat_params(api.param_tree(model))
    data_iter = data_iter or synthetic_batches(api.cfg, batch_size, seq,
                                               seed=seed)
    first = next(data_iter)
    if sharded:
        step_fn, _ = shard_train_fns(api, mesh, model, None, first,
                                     train_cfg.opt,
                                     train_cfg.grad_compression)
        verbose = verbose and mesh.rank == mesh.rank_of(0, 0)
    else:
        step_fn = make_train_step(api, train_cfg.opt,
                                  train_cfg.grad_compression)

    ckpt = CheckpointManager(train_cfg.ckpt_dir, keep=train_cfg.keep)
    start = 0
    opt_state = None if sharded else adamw.init(params)
    restored = ckpt.restore_latest(checkpoint_template(api, model))
    if restored is not None:
        tree, start = restored
        opt_state = load_checkpoint(api, model, opt_state or
                                    adamw.init(params), tree)
        if verbose:
            print(f"[train] resumed from step {start}")
    state = model
    if sharded:     # every rank keeps its blocks
        state, opt_state = step_fn.shard_params(), step_fn.shard_opt(
            opt_state)

    dog = StragglerWatchdog(train_cfg.straggler_factor)
    losses, norms, seconds, coll = [], [], [], []
    t_step = time.perf_counter()
    batch = _on_device(first, dev)
    for i in range(start, train_cfg.steps):
        if sharded:
            c0 = dict(step_fn.comm.seconds)
        state, opt_state, metrics = step_fn(state, opt_state, batch)
        if sharded:
            coll.append({k: v - c0[k]
                         for k, v in step_fn.comm.seconds.items()})
        batch = _on_device(next(data_iter), dev)
        with spans.span(spans.LOSS_READ):
            loss = float(metrics["loss"])
        losses.append(loss)
        norms.append(metrics["grad_norm"])
        dt = time.perf_counter() - t_step
        t_step = time.perf_counter()
        seconds.append(dt)
        if dog.observe(dt) and verbose:
            print(f"[train] straggler step {i}: {dt * 1e3:.0f} ms")
        if verbose and (i % train_cfg.log_every == 0
                        or i == train_cfg.steps - 1):
            print(f"[train] step {i:5d} loss {loss:.4f} "
                  f"gnorm {float(norms[-1]):.3f} "
                  f"lr {float(metrics['lr']):.2e} {dt * 1e3:.0f} ms")
        if train_cfg.ckpt_every and ((i + 1) % train_cfg.ckpt_every == 0
                                     or i == train_cfg.steps - 1):
            with spans.span(spans.CHECKPOINT):
                if not sharded:
                    ckpt.save(checkpoint_tree(api, model, opt_state),
                              step=i + 1)
                    continue
                tree = step_fn.checkpoint_tree(state, opt_state)
                if mesh.rank == mesh.rank_of(0, 0):
                    ckpt.save(tree, step=i + 1)
                del tree
                step_fn.comm.barrier()     # the checkpoint is on disk
    out = dict(losses=losses, grad_norms=[float(g) for g in norms],
               params=model, opt_state=opt_state,
               straggler_flags=dog.flagged, step_seconds=seconds)
    if sharded:
        step_fn.gather_params(state)
        out.update(shards=state, collective_seconds=coll)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--compression", default="none")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    cfg = (cfglib.get_reduced(args.arch) if args.reduced
           else cfglib.get(args.arch))
    api = build(cfg, device=args.device)
    tc = TrainConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                     grad_compression=args.compression)
    out = run(api, tc, batch_size=args.batch, seq=args.seq)
    print(f"final loss: {out['losses'][-1]:.4f}  "
          f"(first {out['losses'][0]:.4f})")


if __name__ == "__main__":
    main()
