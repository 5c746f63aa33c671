#!/usr/bin/env python3
"""Time AdamW's two kernels on the card at each benchmark cell's leaf list:
the gradient norm (``kernels/adamw/kernel.py::sumsq``) and the update
(``kernel.update``), each by CUDA events over 20 back-to-back calls,
beside its byte bound at 3.35 TB/s (the norm reads each bf16 gradient
once; the update reads the gradient, the weight and both f32 moments and
writes the weight and the moments: 24 B a weight in all).  For context it
times the plain loop the kernels replaced (``kernels/adamw/ref.py``, 3
calls), the whole ``optim/adamw.py::update`` (the schedule's and the
clip's scalars, the norm and the update), and the host's time to issue
one ``adamw.update``.

The leaf lists are read from the benchmark's own description of each cell
(``portbench``'s specs, read only): every part of every weight, in the
configuration's dtype, with f32 moments.

    python3 scripts/adamw_timing.py [--cells train-rwkv6-1.6b ...]

From the root of a checkout, on a machine with a CUDA card.  Prints one
JSON line a cell.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from portbench.harness import load_cell  # noqa: E402
from repro_torch.kernels.adamw import kernel as K  # noqa: E402
from repro_torch.kernels.adamw.ref import (global_norm_ref,  # noqa: E402
                                           update_ref)
from repro_torch.optim import adamw  # noqa: E402

HBM = 3.35e12
CELLS = ("train-rwkv6-1.6b", "train-qwen1.5-moe-a2.7b", "train-internvl2-1b")


def device_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"


def leaves(name: str):
    """The cell's weights as ``(grads, m, v, params)`` on the card: every
    part of every weight in the configuration's dtype, gradients of about
    1e-3, moments 0."""
    cell = load_cell(name)
    dtype = getattr(torch, cell.config["dtype"])
    shapes = [tuple(s) for _, s, n in cell.specs() for _ in range(n)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    new = lambda s, k: torch.empty(s, dtype=dtype, device="cuda").normal_(
        0.0, k, generator=gen)
    params = [new(s, 0.02) for s in shapes]
    grads = [new(s, 1e-3) for s in shapes]
    ms = [torch.zeros(s, device="cuda") for s in shapes]
    vs = [torch.zeros(s, device="cuda") for s in shapes]
    return grads, ms, vs, params


def time_cell(name: str) -> dict:
    grads, ms, vs, params = leaves(name)
    cfg = adamw.AdamWConfig()
    weights = sum(p.numel() for p in params)
    g_bytes = sum(g.numel() * g.element_size() for g in grads)
    p_bytes = sum(p.numel() * p.element_size() for p in params)
    norm_bytes = g_bytes
    update_bytes = g_bytes + 2 * p_bytes + 2 * 2 * 4 * weights
    step = torch.ones((), dtype=torch.int32, device="cuda")
    stepf = step.float()
    lr = adamw.schedule(cfg, step)
    gn = K.sumsq(grads)
    scale = torch.clamp(cfg.clip_norm / (gn + 1e-9), max=1.0)
    bc1, bc2 = 1 - cfg.b1 ** stepf, 1 - cfg.b2 ** stepf
    hyper = dict(b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
                 weight_decay=cfg.weight_decay)

    def update():
        K.update(grads, ms, vs, params, lr, scale, bc1, bc2, **hyper)

    def loop():
        update_ref(grads, ms, vs, params, lr, scale, bc1, bc2, cfg.b1,
                   cfg.b2, cfg.eps, cfg.weight_decay)

    state = adamw.AdamWState(step=step, m=ms, v=vs)
    whole = lambda: adamw.update(cfg, grads, state, params)
    norm_ms = device_ms(lambda: K.sumsq(grads), 20)
    update_ms = device_ms(update, 20)
    whole_ms = device_ms(whole, 20)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    whole()
    host_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    loop_norm_ms = device_ms(lambda: global_norm_ref(grads), 3)
    loop_ms = device_ms(loop, 3)
    bound = lambda b: 1e3 * b / HBM
    out = {
        "cell": name, "leaves": len(params), "weights": weights,
        "norm_ms": round(norm_ms, 4),
        "norm_bound_ms": round(bound(norm_bytes), 4),
        "norm_share": round(bound(norm_bytes) / norm_ms, 4),
        "update_ms": round(update_ms, 4),
        "update_bound_ms": round(bound(update_bytes), 4),
        "update_share": round(bound(update_bytes) / update_ms, 4),
        "both_ms": round(norm_ms + update_ms, 4),
        "both_bound_ms": round(bound(norm_bytes + update_bytes), 4),
        "both_share": round(bound(norm_bytes + update_bytes)
                            / (norm_ms + update_ms), 4),
        "adamw_update_ms": round(whole_ms, 4),
        "adamw_update_host_ms": round(host_ms, 3),
        "plain_norm_ms": round(loop_norm_ms, 3),
        "plain_update_ms": round(loop_ms, 3),
        "peak_gb": round(torch.cuda.max_memory_allocated() / 1e9, 3),
    }
    del grads, ms, vs, params, state
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", nargs="+", default=list(CELLS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("adamw_timing.py needs a CUDA card")
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": card(), "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    for name in args.cells:
        print(json.dumps(time_cell(name)), flush=True)


if __name__ == "__main__":
    main()
