#!/usr/bin/env python3
"""Run one of chip_smoke.py's full-width training cells alone on the card,
at a batch size and a step count of the caller's choosing.

    python scripts/train_cell.py TAG [--batch B] [--seq S] [--steps N]
    python scripts/train_cell.py smollm --sharded [--exact-bf16-sums]

TAG names a cell of ``chip_smoke.TRAIN_CELLS`` (smollm, rwkv6,
recurrentgemma, whisper, internvl); the cell's own batch and sequence
length are the defaults, and 4 steps.  It prints the card's name and
power limit, then runs ``chip_smoke.phase_train`` on the cell:
``launch/train.py::run`` for N steps (each step's seconds, tokens/s over
all but the first, the kernels' launches a step, the peak memory), then
one profiled step (the device's idle share, the top kernels), with the
cell's checkpoint setting.  ``--sharded`` (smollm at its own batch and 4 steps) then runs
``chip_smoke.phase_train_sharded``: train-smollm-135m-sharded's four gloo
ranks, held against that run's losses and grad norms.
``--exact-bf16-sums`` turns off cuBLAS's bf16 reductions of bf16
products' partial sums (``allow_bf16_reduced_precision_reduction``) in
every process: it shows how much of the sharded run's difference from
the single-device one those reductions make.  Imports nothing of JAX.

To compare two checkouts, unpack one into a git-ignored directory and
run each checkout's copy of this script in turns (A B B A) within one
machine's run; each process builds its checkout's kernels.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    import chip_smoke
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("tag", choices=[c[0] for c in chip_smoke.TRAIN_CELLS])
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--sharded", action="store_true",
                    help="then train-smollm-135m-sharded (smollm only)")
    ap.add_argument("--exact-bf16-sums", action="store_true",
                    help="no bf16 reductions of bf16 products' partials")
    args = ap.parse_args(argv)
    if args.sharded and (args.tag != "smollm" or args.batch or args.seq
                         or args.steps != 4):
        ap.error("--sharded runs the smollm cell as chip_smoke does")

    import torch
    if not torch.cuda.is_available():
        print("train_cell: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.configs import get
    from repro_torch.data import tokens as data
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention, flash_attention_bwd)
    from repro_torch.kernels.rwkv_scan.kernel import wkv6, wkv6_bwd
    from repro_torch.launch import train
    from repro_torch.models import registry
    from repro_torch.optim import adamw

    tag, name, b, s, *rest = next(c for c in chip_smoke.TRAIN_CELLS
                                  if c[0] == args.tag)
    cell = (tag, name, args.batch or b, args.seq or s, *rest)
    chip_smoke.TRAIN_OPT = dict(chip_smoke.TRAIN_OPT,
                                total_steps=args.steps)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        not args.exact_bf16_sums
    gpu = chip_smoke.gpu_line()
    chip_smoke.log(gpu + ("; bf16 products' partial sums in f32"
                          if args.exact_bf16_sums else ""))
    _, curve = chip_smoke.phase_train(torch, get, registry, train, adamw,
                                      data, flash_attention,
                                      flash_attention_bwd, wkv6, wkv6_bwd,
                                      cell)
    if args.sharded:
        chip_smoke.phase_train_sharded(torch, curve, gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
