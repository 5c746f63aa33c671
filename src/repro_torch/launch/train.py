"""Training launcher: the train step and the fault-tolerant loop.  The port
of :mod:`repro.launch.train`, on one device.

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

Sharding the step over a mesh (the reference's ``shard_train_fns``) waits
for ROADMAP item 14e: a mesh of more than one rank raises.

Usage (CPU, a reduced model; the card is the default device):
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --reduced --device cpu --steps 4 --batch 2 --seq 16
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import configs as cfglib
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.tokens import synthetic_batches
from repro_torch.models.common import (flat_params, tree_from_host,
                                       tree_map, tree_to_host)
from repro_torch.models.registry import ModelAPI, build
from repro_torch.optim import adamw
from repro_torch.optim.compression import compress_grads


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
        params = flat_params(api.param_tree(model))
        for p in params:
            p.grad = None
        loss = api.loss(model, batch)
        loss.backward()
        grads = [p.grad for p in params]     # None: a leaf loss misses
        if compression != "none":
            grads = compress_grads(grads, compression)
        _, opt_state, info = adamw.update(opt_cfg, grads, opt_state, params)
        for p in params:
            p.grad = None
        metrics = dict(loss=loss.detach(), grad_norm=info["grad_norm"],
                       lr=info["lr"])
        return model, opt_state, metrics

    return step


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


def run(api: ModelAPI, train_cfg: TrainConfig, mesh=None,
        batch_size: int = 8, seq: int = 256, seed: int = 0,
        data_iter=None, verbose: bool = True) -> dict:
    """Fault-tolerant training loop with auto-resume, on ``api.device``."""
    if mesh is not None and mesh.size > 1:
        raise NotImplementedError(
            f"training over a {dict(mesh.shape)} mesh needs the sharded "
            "train step (ROADMAP item 14e); run on one device")
    dev = api.device
    model = api.init(torch.Generator(device=dev).manual_seed(seed))
    opt_state = adamw.init(flat_params(api.param_tree(model)))
    data_iter = data_iter or synthetic_batches(api.cfg, batch_size, seq,
                                               seed=seed)
    first = next(data_iter)
    step_fn = make_train_step(api, train_cfg.opt,
                              train_cfg.grad_compression)

    ckpt = CheckpointManager(train_cfg.ckpt_dir, keep=train_cfg.keep)
    start = 0
    restored = ckpt.restore_latest(checkpoint_template(api, model))
    if restored is not None:
        tree, start = restored
        opt_state = load_checkpoint(api, model, opt_state, tree)
        if verbose:
            print(f"[train] resumed from step {start}")

    dog = StragglerWatchdog(train_cfg.straggler_factor)
    losses, seconds = [], []
    t_step = time.perf_counter()
    batch = _on_device(first, dev)
    for i in range(start, train_cfg.steps):
        model, opt_state, metrics = step_fn(model, opt_state, batch)
        batch = _on_device(next(data_iter), dev)
        loss = float(metrics["loss"])
        losses.append(loss)
        dt = time.perf_counter() - t_step
        t_step = time.perf_counter()
        seconds.append(dt)
        if dog.observe(dt) and verbose:
            print(f"[train] straggler step {i}: {dt * 1e3:.0f} ms")
        if verbose and (i % train_cfg.log_every == 0
                        or i == train_cfg.steps - 1):
            print(f"[train] step {i:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} {dt * 1e3:.0f} ms")
        if train_cfg.ckpt_every and ((i + 1) % train_cfg.ckpt_every == 0
                                     or i == train_cfg.steps - 1):
            ckpt.save(checkpoint_tree(api, model, opt_state), step=i + 1)
    return dict(losses=losses, params=model, opt_state=opt_state,
                straggler_flags=dog.flagged, step_seconds=seconds)


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
