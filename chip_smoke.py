#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card: the Sherman index, the LM
serving paths and the LM training path.

    python3 chip_smoke.py                      # the full check, one GPU
    python3 chip_smoke.py --records 134217728  # a smaller deployment phase

Phases, in order; any failure raises and exits non-zero:

1. device  — require CUDA; print the card's name and power limit;
2. build   — compile the eight kernel sources from ``src/repro_torch/csrc``
   (the three kernels, the two backward kernels, the training loss's
   kernel, the grouped expert product and AdamW's), one ``nvcc`` per
   source, all started together; print ptxas's registers,
   spills and performance notes per kernel (raise on a spill) and the
   count of ``HGMMA`` (wgmma) instructions in the SASS of the flash
   attention library and of its backward's (raise if 0);
3. kernel  — hold each CUDA kernel against its plain version on the card
   (leaf search bit for bit, both entries: gathered rows, and the pool
   with leaf ids; flash attention and WKV6 within the reference kernel
   test's tolerances) at the reference kernel test's shapes, a ragged
   shape and the main paths' shapes (flash attention on both of its
   routes: ``wgmma`` for bf16 at hd 64, 128 and 256 with or without a
   window, ``fma`` for f32 and bf16 at hd 16 and 32; with a sliding
   window at every head dim up to 256, with window edges inside a key
   tile and rows that see no key, whisper-medium's encoder and
   cross-attention shapes, recurrentgemma-2b's local attention), and
   time kernel, plain version and (for attention) PyTorch's SDPA on the
   device and per eager call (WKV6 in the kernel layout and in the model
   layout the forward passes, which must give the same bits; the leaf
   search's ``lookup_leaves`` against the gather composition it replaced
   (gathers, casts and the gathered-row entry), on fresh random rows of a 5.5 GB
   pool, with the CUDA kernels each launches counted by the profiler);
4. parity  — ``run_systems`` for ``sherman`` and ``fg+`` on the quick
   YCSB-A spec on the card and on the CPU: the RunResults must be equal;
   then ``run_cluster_systems`` and ``run_open_loop_systems`` (Poisson,
   0.5 Mops offered) with 32 client threads over the default 8 CSs: equal
   RunResults and merged-trace digests wave for wave, and a recorded run
   equal to the unrecorded one; then the chaos runner on the same fleet
   under ``schedule_for_horizon`` (sherman and fg+): equal fault logs,
   reports, final trees and digests, the card's tree equal to the oracle
   replay of its executed writes, and a CPU snapshot resumed on the card;
5. deploy  — the paper-scale index (1B records, 80% full leaves, height 8)
   under the write-intensive mix: bulkload, run, netsim metrics, kernel
   launches, the probe's batch sizes and launches per probe, peak memory;
   then one more wave timed by layer on the host clock and one under
   ``torch.profiler`` (device busy and idle share, device time by layer);
   then, on the same pool, the cluster phase (the paper's 8-CS fleet,
   1,024 client threads, 65,536 ops in 64 rounds: wall-clock ops/s,
   netsim metrics, conservation, cross-CS conflicts, per-CS hit rates,
   the probes, peak memory, one round split by layer and one profiled)
   and the open-loop phase (a fresh fleet, Poisson arrivals at half the
   cluster phase's netsim Mops, 16,384 ops, a Recorder attached: sojourn
   and queueing, the served waves' Chrome trace written, the recorded
   spans tiling the simulated horizon) and the chaos phase (a fresh fleet
   under ``schedule_for_horizon`` of the cluster phase's horizon: one
   checkpoint of the pool at round 0, MS 0 crashing with its memory lost,
   restored from the checkpoint and the waves since replayed, CS 1
   leaving and rejoining cold, a hot-key storm and its lift: the fault
   log, time-to-recover, the save, restore and replay times,
   conservation and a clean GLT); and every write acknowledged in the
   four phases read back; then the mesh-sharded index: the reference
   test's mesh (2, 4) as 8 gloo ranks on the card and 8 on the CPU
   (routed lookups and pjit waves bit for bit, each wave's gathered pool
   equal to the single-process ``write_phase``), and deploy-1B's pool on
   mesh (1, 4), one rank a memory server (each holding its block and an
   image of every internal level): every acknowledged write and 1,024
   absent keys read through routed lookups, ``SHARDED_WAVES``
   write-intensive waves through the pjit path, everything read back
   again; routed lookups/s, one ``all_reduce``'s ms, each wave's gather,
   write phase and send-back seconds, K1 launches and peak memory per
   rank, and the card's sampled peak;
6. lm-parity — a reduced model of every family in f32 (``LM_PARITY``):
   the same weights on the card (kernels) and on the CPU (plain
   versions) give the same prefill (or decode), decode and forward
   logits;
7. granite — granite-3-8b at full width in bf16: prefill of 4 × 4096
   tokens (its 40 flash launches all on the ``wgmma`` route), 64 decode
   steps, and prefill + decode == forward at 512 tokens;
8. rwkv    — rwkv6-1.6b at full width: forward (the median of 3 after a
   cold one) and loss over 4 × 4096 tokens in bf16; step-by-step decode ==
   forward on the bf16 model's first two layers at 64 tokens, and on the
   whole model in f32 at 256 tokens (see ``RWKV_TOL``);
9. qwen    — qwen2-moe-a2.7b at full width in bf16: prefill of 4 × 4096
   (24 flash launches, ``wgmma``; the share of (token, choice) pairs its
   capacity drops), 64 decode steps; prefill + decode == forward at 512
   tokens with capacity_factor = n_experts / top_k (nothing drops);
10. vlm    — internvl2-1b: forward and loss over 256 patches + 4 × 4096
   tokens (24 launches, ``wgmma``, hd 64, GQA group 7), prefill 4 × 4096
   and 64 decode steps;
11. whisper — whisper-medium: loss over 1,500 frames + 4 × 4096 tokens
   (72 launches: encoder, causal, cross), decode_init (24) and 64 decode
   steps; decode == decode_train on a 64-token prompt;
12. griffin — recurrentgemma-2b: forward and loss over 4 × 4096 tokens
   (8 launches on the ``wgmma`` route, window 2048 at hd 256), 64 decode
   steps on the 2,048-slot rings; decode == forward on the first
   super-block in bf16 and on the whole model in f32.

Each LM cell prints tokens/s, the device idle share of a profiled decode
step, peak memory and K2's launches by route, and raises if the launches
differ from the counts above.

13. lm-parity-train — one ``make_train_step`` (loss, backward, AdamW) of
   a reduced f32 model of every family on the card (K2's and K3's
   backward kernels) == the CPU (the plain versions' autograd): loss,
   grad norm and every parameter and moment after the update within 1e-4;
14. train-smollm-135m — ``launch/train.py::run`` at full width in bf16,
   4 steps (1 warm, 3 timed) at 4 × 4096 tokens, each layer
   rematerialised (as every family's training forward is, the
   reference's ``jax.checkpoint``): a line a step, tokens/s, peak memory,
   K2's forward and backward launches a step (60, twice the 30 backward,
   every one on the ``wgmma`` route);
   a checkpoint (bf16 weights, f32 moments) restored bit for bit; a
   profiled fifth step (the top kernels, the device's idle share); ``run``
   resumed from the checkpoint, whose step gives the fifth step's loss;
15. train-rwkv6-1.6b — the same at 4 × 4096 tokens, K3's launches (48,
   twice the 24 backward, a step);
16. train-recurrentgemma-2b — the same at 1 × 4096 tokens (each
   super-block rematerialised), K2's launches (16 forward, twice the 8
   backward, a step, all on ``wgmma``), without the checkpoint's save,
   restore and resume (the cells above show them bit for bit); then
   train-whisper-medium (4 × 4096 decoder tokens over 4 × 1,500 frames;
   K2 144 forward, twice the 72 backward: encoder, causal decoder and
   cross-attention) and train-internvl2-1b (4 × 4096 tokens behind the
   256-patch prefix; K2 48 and 24), without the checkpoint either;
17. train-smollm-135m-sharded — ``launch/train.py``'s sharded step over a
   (data 2, model 2) mesh of four gloo ranks on the card
   (``start_mesh``): a reduced f32 smollm's sharded step on the card ==
   ``make_train_step`` on the CPU within 1e-4; then smollm-135m at full
   width in bf16, train-smollm-135m's batches (1 × 4096 a rank): ``run``
   on the mesh for 3 steps with a checkpoint at step 3 (rank 0 saves the
   gathered tree and restores it into a single-device model, bit for bit
   against the gathered weights and moments), ``elastic.drop_devices``
   of 2 ranks to (1, 2), ``reshard_params`` of the weights and both
   moments, and a fourth step on the survivors; each step's loss and
   grad norm within ``SHARDED_TRAIN_RTOL`` of train-smollm-135m's (and
   the bf16 embedding gradient's own spread on the batch's tokens), its
   seconds, tokens/s and seconds in the gather and in the gradient
   all-reduce, the reshard's seconds, K2's launches (60 forward and 30
   backward a step on every rank, all on ``wgmma``) and each rank's peak
   memory.

Phase 3 also holds the training loss's kernel (``head_loss``: each row's
f32 nll, the logits' gradient written in place) against its plain version
at the training shapes of internvl2-1b, rwkv6-1.6b, whisper-medium and
recurrentgemma-2b (``HEAD_LOSS_SHAPES``: the nll within 1e-5 relative,
the gradient within one bf16 step, a read-only launch leaving the buffer)
and times it beside its bound and the plain version.  Every training
cell (13.-17.) raises unless that kernel launched once a step, and the
serving cells' eval losses (8., 10.-12.) unless it launched once a loss.

Phase 3 also holds the grouped expert product (``moe_gmm``: the kernels
``moe_gmm_kernel`` and ``moe_gmm_dw_kernel`` of the dropless MoE
dispatch) against its plain version at the train-qwen1.5-moe-a2.7b
cell's shapes (``MOE_GMM_COUNTS``: 65,536 sorted rows, 15 skewed groups
and an empty one, D 2,048 and F 1,408 both ways; forward, the rows' and
the weights' gradients within about one bf16 step, rows past the groups
and an empty group's gradient 0, a rerun bit for bit) and times it beside
its bound; after the training cells, the published Qwen1.5-MoE-A2.7B cut
as that cell (12 layers, expert-parallel rank 0 of 4, 4 × 4096 tokens)
trains a step through ``make_train_step`` and raises unless the two
kernels launched 12 times a layer (144 a step) and no pair was dropped;
its profiled step gives the kernels' device time beside the bound from
its own layers' kept pairs.

Phase 3 also holds AdamW's kernels (``adamw_update_kernel``, and the
gradient norm's ``adamw_sumsq_kernel`` with its finalize) over rwkv6-1.6b's
own 582 leaves at full width against the plain loop they replaced, two
clipped steps bit for bit for every weight and moment, the norm within
1e-6 of an f64 sum and equal in two runs, and times them beside their
byte bound and the plain loop.  Every training cell (13.-17.) raises
unless they launched one step's worth a step: one update launch and two
of the norm (its finalize) up to 640 leaves, every leaf sent to the update
and, off the sharded path, no gradient copied.

Phase 3 also holds K2's and K3's backward kernels against their plain
versions' autograd (f32 and bf16, Sq != Sk, rows that see no key; a rerun
bit for bit; K2's backward on both of its routes: ``wgmma`` for bf16 at
hd 64, 128 and 256, from the forward's log-sum-exp, which is held against
its plain version too, and ``fma`` for f32 and bf16 at hd 16 and 32) and
times them at smollm's and recurrentgemma's attention shapes (the latter
at batch 4 and at its training cell's batch 1), whisper-medium's three
training shapes (encoder, cross-attention, causal decoder), internvl2-1b's
and rwkv6's training shapes, beside their bounds, the plain versions and
SDPA's backward (raising if recurrentgemma's windowed backward is slower than SDPA's with
the mask).

The line before the last is a JSON object with the kernels' numbers; the
last line is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, the float32 rate
#: outside the tensor cores (the leaf search's compares, the WKV6
#: recurrence) and the dense bf16 tensor-core rate (attention).
from repro_torch.launch.mesh import (BF16_TENSOR_OPS_S,  # noqa: E402
                                     HBM_BYTES_S, SCALAR_OPS_S)

KERNEL_SHAPES = [(256, 8), (512, 16), (128, 32), (256, 64),   # kernel test
                 (512, 16), (1024, 16), (1000, 16)]           # main path
MAIN_PATH_SHAPE = (512, 16)     # lookup bucket at batch 1024, 50% reads
# the pool entry's checks (F, B): the kernel test's fanouts, the main
# path's, the cluster phase's (one 64-lane probe a CS a round), the open
# loop's smaller buckets, a ragged batch and one lane, on 4096-row torn
# pools
POOL_SHAPES = [(8, 256), (16, 512), (32, 128), (64, 256), (16, 64),
               (16, 32), (16, 16), (16, 300), (16, 1)]
# its timing: a synthetic pool of 2^25 rows (5.5 GB at F = 16, far beyond
# the 50 MB L2), a CUDA graph of 100 calls, each on fresh random rows
LEAF_POOL_ROWS = 1 << 25
LEAF_REPS, LEAF_SAMPLES = 100, 9

# flash attention (B, H, KV, S, hd, causal, dtype, atol, rtol): the
# reference kernel test's shapes at its tolerances (2e-5 in f32, 3e-2 in
# bf16), two ragged ones, the wgmma route's cases of
# tests/test_torch_cuda.py (bf16 at hd 64 and 128: causal and full, GQA
# groups 1, 3 and 4, ragged S of 77, 300 and 4097) and the dense
# prefill's (smollm-135m, then granite-3-8b, at 4 x 4096 tokens).  At
# S = 4096 a row's output has std ~(e/(row+1))^0.5, ~0.03 over most rows,
# so 3e-2 would pass a kernel that dropped key tiles there: the prefill
# shapes are held in f32 at 2e-5, and in bf16 at 4e-3 absolute plus 1e-2
# relative (one bf16 step is 2^-8 to 2^-7 of a value, so a result that
# rounds to the neighbouring bf16 value passes, and little more).
FLASH_SHAPES = [(2, 4, 2, 256, 64, True, "float32", 2e-5, 2e-5),
                (1, 8, 8, 128, 128, False, "float32", 2e-5, 2e-5),
                (2, 2, 1, 512, 32, True, "float32", 2e-5, 2e-5),
                (1, 4, 4, 256, 64, True, "bfloat16", 3e-2, 3e-2),
                (3, 6, 2, 128, 64, False, "float32", 2e-5, 2e-5),
                (2, 4, 2, 77, 64, True, "float32", 2e-5, 2e-5),
                (1, 6, 3, 130, 16, False, "bfloat16", 3e-2, 3e-2),
                (1, 4, 4, 256, 64, False, "bfloat16", 4e-3, 1e-2),
                (2, 6, 2, 256, 64, True, "bfloat16", 4e-3, 1e-2),
                (2, 8, 2, 256, 128, True, "bfloat16", 4e-3, 1e-2),
                (1, 8, 2, 256, 128, False, "bfloat16", 4e-3, 1e-2),
                (2, 9, 3, 77, 64, True, "bfloat16", 4e-3, 1e-2),
                (1, 4, 1, 300, 128, False, "bfloat16", 4e-3, 1e-2),
                (1, 2, 2, 4097, 128, True, "bfloat16", 4e-3, 1e-2),
                (1, 3, 1, 4097, 64, False, "bfloat16", 4e-3, 1e-2),
                (4, 9, 3, 4096, 64, True, "float32", 2e-5, 2e-5),
                (4, 32, 8, 4096, 128, True, "float32", 2e-5, 2e-5),
                (4, 9, 3, 4096, 64, True, "bfloat16", 4e-3, 1e-2),
                (4, 32, 8, 4096, 128, True, "bfloat16", 4e-3, 1e-2)]
# the prefill shapes timed: both on the wgmma route (granite's is the
# main path's, the kernels line's), and granite's in f32 on the fma route
FLASH_TIMED = [(4, 9, 3, 4096, 64, "bfloat16"),
               (4, 32, 8, 4096, 128, "bfloat16"),
               (4, 32, 8, 4096, 128, "float32")]
# WKV6 (B, H, T, N, dtype): the reference kernel test's shapes, two ragged
# ones, the kernel's chunk boundaries (1, 31, 32, 33 and 67 steps, for
# its chunks of 32) in both dtypes, and rwkv6-1.6b's forward over
# 4 x 4096 tokens (f32 r/k/v/w, the main path's).
WKV_SHAPES = [(2, 3, 256, 32, "float32"), (1, 2, 128, 64, "float32"),
              (2, 1, 512, 16, "float32"), (1, 2, 128, 64, "bfloat16"),
              (2, 3, 77, 32, "float32"), (1, 2, 33, 64, "bfloat16")] + [
              (2, 32, t, 64, dt) for t in (1, 31, 32, 33, 67)
              for dt in ("float32", "bfloat16")] + [
              (4, 32, 4096, 64, "float32")]
WKV_TOL = {"float32": 1e-4, "bfloat16": 0.15}
# Full-width checks of one serving path against another, absolute only.
# granite in bf16: at |logit| 4-8 one bf16 step is 0.03125; the two sides
# round at other points (matmuls at M=1 against M=S, decode's
# probabilities rounded to bf16 against the kernel's f32 ones); earlier
# runs read 0.015625 (prefill) and 0.046875 (decode), so three steps.
# rwkv6 in bf16: its random init amplifies the two paths' rounding with
# depth (0.03125 after 1 and 2 layers, ~4 after 24, the logits' own
# size), so bf16 is held on the first two layers at two steps; the whole
# model is held in f32, where the paths' summation orders left 0.0138.
GRANITE_TOL = 0.094
RWKV_BF16_TOL = 0.0625
RWKV_TOL = 0.05
# The new serving cells' consistency checks, on the same argument: bf16
# logits of the two paths within three bf16 steps at |logit| 4-8 for
# qwen2-moe's prefill + decode == forward with nothing dropped (an
# earlier run read 0.036) and whisper's decode == decode_train (0.031).
# recurrentgemma in bf16: the recurrent blocks' conv and gates round at
# other points in decode (M=1 products, one einsum over the conv taps)
# than in the forward (sequential bf16 adds); on the first super-block
# earlier runs read 0.1328 over 64 tokens at |logit| 5.5, so six steps;
# the whole model in f32 read 1.76e-5 over 256 tokens (summation order
# only), held at 1e-3.
QWEN_TOL = 0.094
WHISPER_TOL = 0.094
GRIFFIN_BF16_TOL = 0.1875
GRIFFIN_TOL = 1e-3
# K2's window, hd 256 and cross shapes (B, H, KV, Sq, Sk, hd, causal,
# window, dtype, atol, rtol), bf16 at hd 64, 128 and 256 on the wgmma
# route and the rest on the fma route: a clipping window at every head
# dim in both dtypes, a window at least S, window 1, Sq > Sk with rows
# that see no key, windowed full attention over Sq < Sk and Sq = Sk;
# window edges inside the wgmma route's 64-key (hd 256) and 128-key
# tiles (window 65 and 129 at Sq = Sk = 200); hd 256 without a window
# on the wgmma route (causal and full, GQA groups 1 and 3, ragged
# Sq != Sk); whisper-medium's encoder (S 1500, ragged against the
# 128-row tiles) and cross-attention (Sq 4096, Sk 1500) at its loss's
# shapes; recurrentgemma-2b's local attention (MQA, hd 256, window 2048)
# at its forward's shape in both dtypes.
_F32, _BF16 = ("float32", 2e-5, 2e-5), ("bfloat16", 4e-3, 1e-2)
FLASH_WINDOWED = [(2, 4, 1, 300, 300, hd, True, 64) + dt
                  for hd in (16, 64, 128, 256) for dt in (_F32, _BF16)] + [
                 (1, 4, 2, 200, 200, 256, True, 512) + _BF16,
                 (2, 2, 1, 77, 77, 64, True, 1) + _F32,
                 (2, 2, 1, 77, 77, 256, True, 1) + _BF16,
                 (1, 4, 2, 356, 100, 128, True, 96) + _BF16,
                 (1, 4, 2, 100, 356, 256, False, 96) + _F32,
                 (1, 2, 2, 130, 130, 32, False, 17) + _BF16,
                 (1, 4, 2, 200, 200, 256, True, 65) + _BF16,
                 (1, 4, 2, 200, 200, 256, True, 129) + _BF16,
                 (1, 4, 2, 200, 200, 128, True, 65) + _BF16,
                 (1, 4, 2, 200, 200, 128, True, 129) + _BF16,
                 (1, 4, 2, 356, 100, 256, True, 96) + _BF16,
                 (1, 4, 4, 300, 300, 256, True, 0) + _BF16,
                 (1, 4, 4, 300, 300, 256, False, 0) + _BF16,
                 (2, 6, 2, 200, 77, 256, True, 0) + _BF16,
                 (2, 6, 2, 77, 200, 256, False, 0) + _BF16,
                 (4, 16, 16, 1500, 1500, 64, False, 0) + _BF16,
                 (4, 16, 16, 4096, 1500, 64, False, 0) + _BF16,
                 (4, 10, 1, 4096, 4096, 256, True, 2048) + _F32,
                 (4, 10, 1, 4096, 4096, 256, True, 2048) + _BF16]
# recurrentgemma-2b's local attention, timed: (B, H, KV, S, hd, window)
GRIFFIN_ATTN = (4, 10, 1, 4096, 256, 2048)


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def kernel_inputs(rng, b: int, f: int):
    """The reference kernel test's generator (tests/test_kernels.py)."""
    keys = np.stack([rng.choice(9_000, f, replace=False)
                     for _ in range(b)]).astype(np.int32)
    vals = rng.integers(0, 1 << 20, (b, f)).astype(np.int32)
    q = np.where(rng.random(b) < 0.5,
                 keys[np.arange(b), rng.integers(0, f, b)],
                 20_000 + np.arange(b)).astype(np.int32)
    fev = rng.integers(0, 4, (b, f)).astype(np.int32)
    rev = fev.copy()
    rev[: b // 8] += 1
    fnv = rng.integers(0, 4, b).astype(np.int32)
    rnv = fnv.copy()
    rnv[b // 8: b // 4] += 1
    free = np.zeros(b, np.int32)
    free[b // 4: b // 4 + 4] = 1
    return [q, keys, vals, fev, rev, fnv, rnv, free]


def _event_ms(torch, fn, reps: int, samples: int) -> float:
    """Median over ``samples`` of ``fn``'s CUDA-event time over ``reps``."""
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def host_ms(torch, fn, reps: int = 100, samples: int = 25) -> float:
    """Time per eager call of ``fn``: ``reps`` back-to-back calls, so the
    host's work per call (checks, allocation, launch) is in the reading."""
    for _ in range(10):
        fn()

    def run():
        for _ in range(reps):
            fn()
    return _event_ms(torch, run, reps, samples)


def device_ms(torch, fn, reps: int = 100, samples: int = 25) -> float:
    """Device time per call of ``fn``: ``reps`` calls captured in one CUDA
    graph and replayed, so no host work sits between the kernels."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):           # warm up off the default stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    for _ in range(3):
        graph.replay()
    return _event_ms(torch, graph.replay, reps, samples)


def _peak(torch) -> str:
    return f"max_memory_allocated {torch.cuda.max_memory_allocated()}"


def _check_close(torch, got, want, atol: float, rtol: float,
                 what: str) -> float:
    """Raise unless ``|got - want| <= atol + rtol * |want|`` everywhere (as
    numpy's assert_allclose); return the max abs error."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if not bool((err <= atol + rtol * want.abs()).all()):
        raise AssertionError(f"{what}: max abs error {float(err.max())} "
                             f"beyond atol {atol} rtol {rtol}")
    return float(err.max())


def phase_build_report(names, libs, logs) -> None:
    """Print ptxas's registers, spills and performance notes for each
    kernel instantiation (raise on a spill) and the count of HGMMA (wgmma)
    instructions in the flash library's SASS (raise if 0)."""
    spills = []
    for name in names:
        if name not in logs:
            log(f"build   {name}: already built, no ptxas log")
        for ln in logs.get(name, "").splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", ln)
            if entry:
                log(f"build   {name}: {entry.group(1)}")
            elif ("registers" in ln or "spill" in ln or "Potential" in ln
                  or "setmaxnreg" in ln):
                log(f"build   {name}:   {ln.strip()}")
            stores = re.search(r"(\d+) bytes spill stores", ln)
            if stores and int(stores.group(1)):
                spills.append(f"{name}: {ln.strip()}")
    if spills:
        raise AssertionError("register spills: " + "; ".join(spills))
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for name in ("flash_attention", "flash_attention_bwd"):
        sass = subprocess.run([cuobjdump, "-sass", str(libs[name])],
                              capture_output=True, text=True, check=True,
                              timeout=120).stdout
        n_hgmma = sum("HGMMA" in ln for ln in sass.splitlines())
        log(f"build   {name}: {n_hgmma} HGMMA instructions in the SASS "
            f"({cuobjdump} -sass)")
        if n_hgmma == 0:
            raise AssertionError(f"the {name} library has no wgmma (HGMMA) "
                                 "instruction")


def leaf_pool(torch, n: int, f: int):
    """A synthetic pool of ``n`` rows whose every field is a function of
    its row and slot, so a query for row r is made without reading the
    pool: keys[r, s] = r·F + s, vals = keys + 1; torn where keys % 97 == 0
    (rev = fev + 1), r % 89 == 0 (rnv = fnv + 1) and r % 101 == 0 (free).
    Returns the pool entry's arrays: keys, vals, fev, rev, fnv, rnv,
    free_bit."""
    i32 = torch.int32
    keys = torch.arange(n * f, dtype=i32, device="cuda").view(n, f)
    fev = (keys & 3).to(torch.uint8)
    rev = fev + (keys % 97 == 0).to(torch.uint8)
    row = torch.arange(n, dtype=i32, device="cuda")
    fnv = (row & 15).to(torch.uint8)
    rnv = fnv + (row % 89 == 0).to(torch.uint8)
    return keys, keys + 1, fev, rev, fnv, rnv, row % 101 == 0


def pool_state(pool):
    """The :class:`TreeState` fields that ``lookup_leaves`` reads, named,
    from a :func:`leaf_pool`."""
    return argparse.Namespace(**dict(zip(
        ("keys", "vals", "fev", "rev", "fnv", "rnv", "free_bit"), pool)))


def fill_leaf_queries(torch, leaf, q, n: int, f: int, gen) -> None:
    """Fresh random leaf ids of a :func:`leaf_pool`, in place, and queries
    that hit a random slot of their row for about half the lanes (else
    -5, in no row)."""
    leaf.random_(0, n, generator=gen)
    slot = torch.randint(0, 2 * f, leaf.shape, generator=gen,
                         device="cuda", dtype=torch.int32)
    torch.where(slot < f, leaf * f + slot, torch.full_like(leaf, -5), out=q)


def fresh_rows_ms(torch, fn, reps: int, samples: int, refill=None) -> float:
    """Device time per call: ``fn(k)`` for k < ``reps`` captured in one
    CUDA graph and replayed; ``refill()`` (fresh leaf ids, so every row is
    a cold DRAM read) runs before each replay, outside the timed span."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for k in range(3):
            fn(k)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for k in range(reps):
            fn(k)
    graph.replay()
    times = []
    for _ in range(samples):
        if refill is not None:
            refill()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def kernels_per_call(torch, fn, calls: int = 10) -> float:
    """CUDA kernels that ``fn`` launches per call, from ``torch.profiler``
    (memory copies and sets not counted)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not e.key.startswith(("Memcpy", "Memset")))
    return n / calls


def gathered_lookup_leaves(torch, leaf_search, pool, leaf, q):
    """The gather composition ``lookup_leaves`` was before the pool entry:
    the pool rows gathered and cast by PyTorch (7 gathers, 3 casts), then
    the gathered-row entry."""
    keys, vals, fev, rev, fnv, rnv, free = pool
    i32 = torch.int32
    return leaf_search(q.to(i32).contiguous(), keys[leaf], vals[leaf],
                       fev[leaf], rev[leaf], fnv[leaf].to(i32),
                       rnv[leaf].to(i32), free[leaf].to(i32))


def _assert_same_bits(torch, got, want, what: str) -> int:
    """Raise unless each output has the plain version's dtype and bits;
    return the max abs difference (0)."""
    err = 0
    for g, w in zip(got, want):
        if g.dtype != w.dtype or not torch.equal(g, w):
            raise AssertionError(f"{what}: kernel != plain version")
        if g.numel():
            diff = (g.to(torch.int64) - w.to(torch.int64)).abs().max()
            err = max(err, int(diff))
    return err


def phase_kernel(torch, leaf_search, leaf_search_ref, leaf_search_pool,
                 leaf_search_pool_ref, lookup_leaves):
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(7)
    dev = torch.device("cuda")
    max_err = 0
    for b, f in KERNEL_SHAPES:
        host = kernel_inputs(rng, b, f)
        for ver in (torch.int32, torch.uint8):
            args = [torch.from_numpy(a).to(dev) for a in host]
            args[3], args[4] = args[3].to(ver), args[4].to(ver)
            got = leaf_search(*args)
            want = leaf_search_ref(*args)
            torch.cuda.synchronize()
            max_err = max(max_err, _assert_same_bits(
                torch, got, want, f"leaf_search B={b} F={f} versions {ver}"))
        log(f"kernel  B={b:5d} F={f:3d}: equal to plain (int32 and uint8 "
            f"versions)")
    # the pool entry, on torn pools: leaf ids in range, negative, past
    # the pool (wrapped, then clamped, as JAX's gather does)
    gen = torch.Generator(device="cuda").manual_seed(7)
    for f, b in POOL_SHAPES:
        n = 4096
        pool = leaf_pool(torch, n, f)
        leaf = torch.empty((b,), dtype=torch.int32, device=dev)
        q = torch.empty_like(leaf)
        fill_leaf_queries(torch, leaf, q, n, f, gen)
        leaf[1::7] -= n + 3
        leaf[2::11] += n
        n0 = leaf_search.launches
        got = leaf_search_pool(q, leaf, *pool)
        want = leaf_search_pool_ref(q, leaf, *pool)
        torch.cuda.synchronize()
        if leaf_search.launches != n0 + 1:
            raise AssertionError("leaf_search_pool launched "
                                 f"{leaf_search.launches - n0} kernels")
        max_err = max(max_err, _assert_same_bits(
            torch, got, want, f"leaf_search_pool F={f} B={b}"))
        log(f"kernel  pool entry F={f:3d} B={b:4d}: equal to plain "
            f"({int(want[1].sum())} found, {int((~want[2]).sum())} "
            f"inconsistent, {int((leaf < 0).sum())} negative and "
            f"{int((leaf >= n).sum())} past-the-pool ids)")
        del pool

    # lookup_leaves at the main path's shape on cold rows of a big pool
    b, f = MAIN_PATH_SHAPE
    n = LEAF_POOL_ROWS
    pool = leaf_pool(torch, n, f)
    pool_bytes = sum(t.numel() * t.element_size() for t in pool)
    st = pool_state(pool)
    reps, samples = LEAF_REPS, LEAF_SAMPLES
    leaf = torch.empty((reps, b), dtype=torch.int32, device=dev)
    q = torch.empty_like(leaf)
    refill = lambda: fill_leaf_queries(torch, leaf, q, n, f, gen)
    refill()
    new = lambda k: lookup_leaves(None, st, leaf[k], q[k])
    old = lambda k: gathered_lookup_leaves(torch, leaf_search, pool,
                                           leaf[k], q[k])
    plain = lambda k: leaf_search_pool_ref(q[k], leaf[k], *pool)
    max_err = max(max_err, _assert_same_bits(
        torch, new(0), plain(0), "lookup_leaves at the main path"))
    _assert_same_bits(torch, old(0), plain(0), "the gather composition")
    ms = fresh_rows_ms(torch, new, reps, samples, refill)
    old_ms = fresh_rows_ms(torch, old, reps, samples, refill)
    plain_ms = fresh_rows_ms(torch, plain, reps, samples, refill)
    warm_ms = fresh_rows_ms(torch, new, reps, samples)
    call_ms = host_ms(torch, lambda: new(0))
    old_call_ms = host_ms(torch, lambda: old(0))
    plain_call_ms = host_ms(torch, lambda: plain(0))
    per_call = kernels_per_call(torch, lambda: new(0))
    old_per_call = kernels_per_call(torch, lambda: old(0))
    if per_call != 1:
        raise AssertionError(f"lookup_leaves launched {per_call} kernels "
                             "a call")
    # What the pool entry must move (uint8 versions): every lane reads its
    # query and leaf id (8 B), its key row (4F B) and its node fields
    # (3 B), and writes value, found and consistent (6 B); a lane whose
    # row holds the query also reads that slot's value and FEV/REV (6 B).
    # This run's rows: q == -5 is no row's key, every other query is in
    # its row (the mean over the graph's calls).
    matched = float((q != -5).sum()) / reps
    n_bytes = b * (8 + 4 * f + 3 + 6) + matched * 6
    n_ops = b * f + 8 * b          # slot compares + the per-lane checks
    bytes_ms = n_bytes / HBM_BYTES_S * 1e3
    ops_ms = n_ops / SCALAR_OPS_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    log(f"kernel  lookup_leaves B={b} F={f} uint8 on fresh random rows of a "
        f"{n}-row pool ({pool_bytes} bytes): device {ms:.6f} ms (CUDA graph "
        f"of {reps} calls, median of {samples}), {warm_ms:.6f} ms on rows "
        f"already in L2; per eager call {call_ms:.6f} ms; "
        f"{per_call:g} CUDA kernels a call (torch.profiler)")
    log(f"kernel  gather composition (7 gathers, 3 casts, gathered-row "
        f"entry) on the same rows: device {old_ms:.6f} ms, per eager call "
        f"{old_call_ms:.6f} ms, {old_per_call:g} CUDA kernels a call; "
        f"lookup_leaves is {old_ms / ms:.2f}x faster on the device and "
        f"{old_call_ms / call_ms:.2f}x per eager call")
    log(f"kernel  plain version (gather + search in PyTorch): device "
        f"{plain_ms:.6f} ms, per eager call {plain_call_ms:.6f} ms; bound "
        f"{bound_ms:.9f} ms by {'bytes' if bytes_ms >= ops_ms else 'ops'} "
        f"({n_bytes:.1f} bytes, {matched:.2f} matched lanes a call); "
        f"{ms / bound_ms:.1f}x the bound; {_peak(torch)}")
    del pool, st
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                host_ms=call_ms, plain_host_ms=plain_call_ms,
                warm_ms=warm_ms, kernels_per_call=per_call,
                gather_composition_ms=old_ms,
                gather_composition_host_ms=old_call_ms,
                gather_composition_kernels_per_call=old_per_call)


#: the cluster phase's ops (64 rounds of 1,024 client threads) and the
#: open-loop phase's, both on deploy-1B's pool
CLUSTER_OPS = 65_536
OPEN_LOOP_OPS = 16_384

#: the layers of one index wave, each a function the wave calls
#: (label, module, attribute); a layer's own time leaves out the layers
#: it calls.  "chase and sync" is cached_lookup's own time: the B-link
#: chase, the leaf checks, the ``sound.all()`` host sync and the probe's
#: result tuple; "probe" is lookup_leaves.
WAVE_LAYERS = [
    ("descent", "repro_torch.core.cache", "descend_image"),
    ("chase and sync", "repro_torch.core.cache", "cached_lookup"),
    ("retraversal", "repro_torch.core.cache", "traverse"),
    ("probe", "repro_torch.kernels.leaf_search.ops", "lookup_leaves"),
    ("write phase", "repro_torch.core.write", "write_phase"),
    ("repair drain", "repro_torch.core.api", "run_repair_drain"),
    ("verb replay", "repro_torch.core.netsim", "price_read_phase"),
    ("verb replay", "repro_torch.core.netsim", "price_write_phase"),
    ("verb replay", "repro_torch.core.netsim", "price_maintenance"),
]
#: device-to-host copies and host syncs: ``Tensor`` methods
HOST_SYNCS = ("cpu", "item", "__bool__", "__int__")
HOST_LABEL = "host copies and syncs"


#: a cluster round's layers: the wave's, plus the scheduler's own names
#: for the repair drain (bound at import), the merged replay and the
#: per-CS trace builders
CLUSTER_LAYERS = WAVE_LAYERS + [
    ("repair drain", "repro_torch.cluster.sched", "run_repair_drain"),
    ("verb replay", "repro_torch.core.netsim", "price_merged_phase"),
    ("trace build", "repro_torch.core.netsim", "transformed_write_trace"),
    ("trace build", "repro_torch.core.netsim", "read_trace_from_stats"),
    ("trace build", "repro_torch.core.verbs", "maintenance_trace"),
    ("cache fill", "repro_torch.core.cache", "fill_image"),
]


class WaveClock:
    """Time the index's layers on the host clock while it is entered, by
    wrapping each function of ``layers`` (default ``WAVE_LAYERS``) and
    the ``HOST_SYNCS`` methods; with ``ranges``, each call also opens a
    ``torch.profiler`` range named by its layer."""

    def __init__(self, torch, ranges: bool = False, layers=None):
        self.torch, self.ranges = torch, ranges
        self.layers = WAVE_LAYERS if layers is None else layers
        self.own: dict[str, float] = {}
        self.calls: dict[str, int] = {}
        self._stack: list[float] = []
        self._undo: list = []

    def _wrap(self, label, fn):
        clock = self
        record = self.torch.profiler.record_function

        def timed(*args, **kw):
            t0 = time.perf_counter()
            clock._stack.append(0.0)
            try:
                if clock.ranges:
                    with record(label):
                        return fn(*args, **kw)
                return fn(*args, **kw)
            finally:
                dt = time.perf_counter() - t0
                inner = clock._stack.pop()
                clock.own[label] = clock.own.get(label, 0.0) + dt - inner
                clock.calls[label] = clock.calls.get(label, 0) + 1
                if clock._stack:
                    clock._stack[-1] += dt
        return timed

    def __enter__(self):
        import importlib
        for label, mod, attr in self.layers:
            m = importlib.import_module(mod)
            orig = getattr(m, attr)
            setattr(m, attr, self._wrap(label, orig))
            self._undo.append((m, attr, orig))
        for attr in HOST_SYNCS:
            tensor = self.torch.Tensor
            setattr(tensor, attr, self._wrap(HOST_LABEL,
                                             getattr(tensor, attr)))
            self._undo.append((tensor, attr, None))   # inherited
        return self

    def __exit__(self, *exc):
        for obj, attr, orig in reversed(self._undo):
            if orig is None:
                delattr(obj, attr)
            else:
                setattr(obj, attr, orig)
        self._undo.clear()


def device_ms_by_layer(prof, labels) -> tuple[float, dict, dict]:
    """The device's busy time (ms: kernels, copies and sets), and device
    time (ms) and kernel count (copies and sets left out) by the innermost
    layer range around the op that launched each; "other" outside every
    layer.  The leaf-search kernel, launched through ctypes with no op
    around it, is found by its name and counted under "probe"."""
    from torch.autograd import DeviceType
    busy = 0.0
    ms: dict[str, float] = {}
    kernels: dict[str, int] = {}

    def add(label, name, dur_ms):
        ms[label] = ms.get(label, 0.0) + dur_ms
        if not name.startswith(("Memcpy", "Memset")):
            kernels[label] = kernels.get(label, 0) + 1
    for e in prof.events():
        if e.device_type == DeviceType.CPU:
            p, label = e, "other"
            while p is not None:
                if p.name in labels:
                    label = p.name
                    break
                p = p.cpu_parent
            for k in e.kernels:
                if "leaf_search_kernel" not in k.name:
                    add(label, k.name, k.duration / 1e3)
        elif not e.is_user_annotation:
            dur = e.time_range.elapsed_us() / 1e3
            busy += dur
            if "leaf_search_kernel" in e.name:
                add("probe", e.name, dur)
    return busy, ms, kernels


def layer_split(torch, tag: str, what: str, run, layers,
                probes: int) -> None:
    """Run ``run(seed)`` twice more: once timed by layer on the host
    clock, once under ``torch.profiler`` (device busy time and idle
    share, device time and kernels by layer).  ``what`` names one run
    ("wave", "round"); the profiled run's probe must launch ``probes``
    kernels, one a lookup_leaves call."""
    from torch.profiler import ProfilerActivity, profile
    labels = [lb for lb, _, _ in layers] + [HOST_LABEL]
    labels = list(dict.fromkeys(labels))
    with WaveClock(torch, layers=layers) as clock:
        t0 = time.perf_counter()
        n_ops = run(2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    parts = {lb: clock.own.get(lb, 0.0) * 1e3 for lb in labels}
    parts["other (keys, padding, glue)"] = wall * 1e3 - sum(parts.values())
    log(f"{tag:<8}{what} split (host clock, {n_ops} ops): wall "
        f"{wall * 1e3:.3f} ms; " + "; ".join(
            f"{lb} {v:.3f} ms ({clock.calls.get(lb, 0)} calls)"
            for lb, v in parts.items()))
    with WaveClock(torch, ranges=True, layers=layers):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            n_ops = run(3)
            torch.cuda.synchronize()
            wall_p = time.perf_counter() - t0
    busy, ms, kernels = device_ms_by_layer(prof, labels)
    log(f"{tag:<8}{what} profile (torch.profiler, {n_ops} ops): wall "
        f"{wall_p * 1e3:.3f} ms, device busy {busy:.3f} ms, idle share "
        f"{1 - busy / (wall_p * 1e3):.3f}; device ms (kernels) by layer: "
        + "; ".join(f"{lb} {ms[lb]:.3f} ({kernels.get(lb, 0)})"
                    for lb in sorted(ms, key=lambda x: -ms[x])))
    if kernels.get("probe") != probes:
        raise AssertionError(f"the profiled {what}'s probes launched "
                             f"{kernels.get('probe')} kernels, not "
                             f"{probes}")


def wave_split(torch, engine, idx, spec, keyspace: int) -> None:
    """Two more waves of ``spec`` on ``idx`` through ``run_workload``,
    split by layer (:func:`layer_split`)."""
    one = dataclasses.replace(spec, ops=spec.batch)

    def run(seed):
        engine.run_workload(idx, one, seed=seed, keyspace=keyspace)
        return one.batch
    layer_split(torch, "deploy", "wave", run, WAVE_LAYERS, probes=1)


class ProbeCount:
    """While entered, count the probe's calls (``lookup_leaves``) by
    (batch size, leaf-search kernel launches a call); ``launches`` and
    ``launches_pool`` are the kernel's counts over the block, from 0."""

    def __init__(self, leaf_search):
        self.leaf_search = leaf_search
        self.probes: dict[tuple[int, int], int] = {}
        self.launches = self.launches_pool = 0

    def __enter__(self):
        from repro_torch.kernels.leaf_search import ops as leaf_ops
        ls, probe, probes = self.leaf_search, leaf_ops.lookup_leaves, \
            self.probes

        def counting_probe(cfg, st, leaf, qkeys):
            n0 = ls.launches
            out = probe(cfg, st, leaf, qkeys)
            key = (int(leaf.shape[0]), ls.launches - n0)
            probes[key] = probes.get(key, 0) + 1
            return out
        self._undo = (leaf_ops, probe)
        leaf_ops.lookup_leaves = counting_probe
        ls.launches = ls.launches_pool = 0
        return self

    def __exit__(self, *exc):
        leaf_ops, probe = self._undo
        leaf_ops.lookup_leaves = probe
        self.launches = self.leaf_search.launches
        self.launches_pool = self.leaf_search.launches_pool

    def line(self) -> str:
        return ", ".join(f"{k}: {v}" for k, v in sorted(self.probes.items()))

    def check(self, what: str) -> None:
        """Raise unless the kernel launched, every launch was the pool
        entry's and every probe launched it once."""
        if self.launches <= 0 or self.launches_pool != self.launches or \
                any(n != 1 for _, n in self.probes):
            raise AssertionError(f"{what}: launches={self.launches} (pool "
                                 f"entry {self.launches_pool}), probes "
                                 f"{self.probes}")


def phase_parity(torch, leaf_search, engine, get_preset):
    spec = get_preset("ycsb-a", load_records=8_000, ops=4_096, batch=1_024,
                      theta=0.99)
    torch.cuda.reset_peak_memory_stats()
    leaf_search.launches = 0
    t0 = time.perf_counter()
    gpu = engine.run_systems(spec, ("sherman", "fg+"), device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = leaf_search.launches
    cpu = engine.run_systems(spec, ("sherman", "fg+"), device="cpu")
    t2 = time.perf_counter()
    for g, c in zip(gpu, cpu):
        dg, dc = g.to_dict(), c.to_dict()
        diff = {k: (dg[k], dc[k]) for k in dg if dg[k] != dc[k]}
        if diff:
            raise AssertionError(f"{g.system}: GPU != CPU RunResult: {diff}")
        log(f"parity  {g.system}: GPU RunResult == CPU RunResult "
            f"(mops {g.mops}, p99 {g.p99_us} us)")
    if launches <= 0:
        raise AssertionError("the GPU run never launched leaf_search")
    log(f"parity  GPU run {t1 - t0:.3f} s, CPU run {t2 - t1:.3f} s, "
        f"leaf_search launches {launches}; {_peak(torch)}")

    # the cluster plane, closed and open loop, over the default 8 CSs
    quick = get_preset("ycsb-a", load_records=8_000, ops=1_024, batch=512)
    poisson = quick.replace(arrival="poisson", offered_mops=0.5)
    for what, fn, sp in (("cluster", engine.run_cluster_systems, quick),
                         ("open-loop", engine.run_open_loop_systems,
                          poisson)):
        leaf_search.launches = 0
        t0 = time.perf_counter()
        gpu, gpu_logs = fleet_runs(fn, sp, "cuda")
        t1 = time.perf_counter()
        launches = leaf_search.launches
        cpu, cpu_logs = fleet_runs(fn, sp, "cpu")
        t2 = time.perf_counter()
        for g, c, lg, lc in zip(gpu, cpu, gpu_logs, cpu_logs):
            dg, dc = g.to_dict(), c.to_dict()
            diff = {k: (dg[k], dc[k]) for k in dg if dg[k] != dc[k]}
            if diff:
                raise AssertionError(f"{what} {g.system}: GPU != CPU "
                                     f"RunResult: {diff}")
            if lg != lc:
                wave = next((i for i, (x, y) in enumerate(zip(lg, lc))
                             if x != y), min(len(lg), len(lc)))
                raise AssertionError(f"{what} {g.system}: trace digests "
                                     f"differ from wave {wave}")
            log(f"parity  {what} {g.system}: GPU RunResult == CPU "
                f"RunResult and {len(lg)} merged-trace digests equal wave "
                f"for wave (mops {g.mops}, p99 {g.p99_us} us, "
                f"{g.rounds} rounds)")
        # recording is a pure observation
        rec, _ = fleet_runs(fn, sp, "cuda", systems=("sherman",),
                            recorders={})
        dg, dr = gpu[0].to_dict(), rec[0].to_dict()
        dg.pop("obs"), dr.pop("obs")
        if dg != dr or not rec[0].obs.get("spans_ok"):
            raise AssertionError(f"{what}: a recorded run differs from "
                                 f"the unrecorded one")
        if launches <= 0:
            raise AssertionError(f"the GPU {what} run never launched "
                                 f"leaf_search")
        log(f"parity  {what}: recorded run == unrecorded run "
            f"({rec[0].obs['segments']} segments); GPU run "
            f"{t1 - t0:.3f} s, CPU run {t2 - t1:.3f} s, leaf_search "
            f"launches {launches}")


def fleet_runs(fn, spec, device: str, systems=("sherman", "fg+"), **kw):
    """``fn`` (``run_cluster_systems`` or ``run_open_loop_systems``) with
    32 client threads on ``device``, every fleet logging its merged-trace
    digests; returns the RunResults and the fleets' digest logs."""
    import repro_torch.cluster as cluster_pkg
    build = cluster_pkg.build_cluster
    fleets = []

    def logging_build(*args, **kwargs):
        fleet = build(*args, **kwargs)
        fleet.record_traces()
        fleets.append(fleet)
        return fleet
    cluster_pkg.build_cluster = logging_build
    try:
        res = fn(spec, systems, n_clients=32, device=device, **kw)
    finally:
        cluster_pkg.build_cluster = build
    return res, [f.trace_log for f in fleets]


def phase_deploy(torch, leaf_search, records: int, nodes_per_ms: int):
    from repro_torch.core import SHERMAN, ShermanIndex, TreeConfig
    from repro_torch.workloads import engine, get_preset

    cfg = TreeConfig(n_ms=4, nodes_per_ms=nodes_per_ms, fanout=16,
                     n_locks_per_ms=131_072, max_height=10, n_cs=8)
    keyspace = 1 << 30
    spec = get_preset("write-intensive", load_records=records, ops=65_536,
                      batch=1_024)
    log(f"deploy  records={records} keyspace=2^30 n_ms=4 "
        f"nodes_per_ms={nodes_per_ms} pool_rows={cfg.n_nodes} "
        f"spec={spec.name} theta={spec.theta} ops={spec.ops} "
        f"batch={spec.batch}")
    torch.cuda.reset_peak_memory_stats()

    t0 = time.perf_counter()
    keys, vals = engine.load_arrays(records, keyspace, seed=0,
                                    device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    # 1M loaded records to read back untouched (unique ranks, seeded)
    ranks = np.unique(np.random.default_rng(12345).integers(
        0, records, 1_000_000 + 50_000))[:1_000_000]
    rk = torch.from_numpy(ranks).cuda()
    probe_keys, probe_vals = keys[rk].cpu().numpy(), vals[rk].cpu().numpy()
    t2 = time.perf_counter()
    idx = ShermanIndex.build(cfg, keys, vals, features=SHERMAN)
    del keys, vals, rk
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    log(f"deploy  load arrays {t1 - t0:.3f} s, bulkload {t3 - t2:.3f} s, "
        f"height {int(idx.state.height)}, live rows "
        f"{int(idx.state.alloc_rr)}")

    # every acknowledged write, in order (None: deleted)
    acked: dict[int, int | None] = {}
    insert = idx.insert

    def recording_insert(k, v):
        insert(k, v)            # returns once the batch is applied
        for kk, vv in zip(np.asarray(k, np.int64).tolist(),
                          np.asarray(v, np.int64).tolist()):
            acked[kk] = vv
    idx.insert = recording_insert

    with ProbeCount(leaf_search) as pc:
        t4 = time.perf_counter()
        res = engine.run_workload(idx, spec, keyspace=keyspace,
                                  system="sherman")
        torch.cuda.synchronize()
        t5 = time.perf_counter()
    launches, pool_launches = pc.launches, pc.launches_pool
    run_s = t5 - t4
    peak = torch.cuda.max_memory_allocated()
    waves = -(-spec.ops // spec.batch)
    log(f"deploy  run {run_s:.3f} s, {res.n_ops / run_s:.1f} ops/s "
        f"wall-clock on the card ({run_s / waves * 1e3:.3f} ms a wave); "
        f"netsim mops {res.mops} p50_us {res.p50_us} p99_us {res.p99_us}; "
        f"leaf_search launches {launches} (pool entry {pool_launches}); "
        f"max_memory_allocated {peak}")
    log("deploy  probes (lookup_leaves calls) by (batch size, kernel "
        "launches a call): " + pc.line())
    for name in ("mops", "p50_us", "p99_us"):
        v = getattr(res, name)
        if not (math.isfinite(v) and v > 0):
            raise AssertionError(f"deploy: {name}={v}")
    if res.n_ops != spec.ops:
        raise AssertionError(f"deploy: n_ops={res.n_ops}")
    pc.check("deploy")
    wave_split(torch, engine, idx, spec, keyspace)
    return dict(cfg=cfg, state=idx.state, spec=spec, keyspace=keyspace,
                acked=acked, probe_keys=probe_keys, probe_vals=probe_vals,
                launches=launches)


def read_back(torch, dep: dict, phases: str) -> None:
    """The guarantee: every write acknowledged on the deployment's pool
    (``dep["acked"]``, by the phases named in ``phases``) reads back from
    ``dep["state"]``, and the untouched loaded records keep their load
    values."""
    from repro_torch.core.ops import lookup_batch
    cfg, state, acked = dep["cfg"], dep["state"], dep["acked"]
    probe_keys, probe_vals = dep["probe_keys"], dep["probe_vals"]
    untouched = ~np.isin(probe_keys, np.fromiter(acked, np.int64))
    want = {**dict(zip(probe_keys[untouched].tolist(),
                       probe_vals[untouched].tolist())), **acked}
    k_all = np.fromiter(want, np.int64).astype(np.int32)
    present = np.fromiter((v is not None for v in want.values()), bool)
    v_all = np.fromiter((-1 if v is None else v for v in want.values()),
                        np.int64).astype(np.int32)
    t6 = time.perf_counter()
    for lo in range(0, k_all.size, 1 << 18):
        sl = slice(lo, lo + (1 << 18))
        r = lookup_batch(cfg, state, torch.from_numpy(k_all[sl]).cuda())
        found = r.found.cpu().numpy()
        got = r.value.cpu().numpy()
        bad = (found != present[sl]) | (found & (got != v_all[sl]))
        if bad.any():
            first = np.nonzero(bad)[0][0]
            raise AssertionError(f"deploy: {int(bad.sum())} keys read back "
                                 f"wrong, first {k_all[lo + first]}")
    t7 = time.perf_counter()
    log(f"deploy  read back {len(acked)} acknowledged writes "
        f"({int((~present).sum())} of them deletes) of the {phases} and "
        f"{int(untouched.sum())} untouched loaded records exactly "
        f"({t7 - t6:.3f} s)")


def ack_wave(acked: dict, keys_by_cs, vals_by_cs=None,
             is_delete: bool = False) -> None:
    """Log one acknowledged cluster write wave into ``acked``, in lane
    order: a stacked wave's lanes follow CS order and its last lane wins,
    so a later CS's value for a key overwrites an earlier one's."""
    for i, k in enumerate(keys_by_cs):
        if k is None or not len(k):
            continue
        k = np.asarray(k, np.int32).astype(np.int64).tolist()
        if is_delete:
            acked.update(dict.fromkeys(k))
            continue
        v = vals_by_cs[i] if vals_by_cs is not None else None
        v = np.zeros(len(k), np.int32) if v is None else \
            np.asarray(v, np.int32)
        acked.update(zip(k, v.astype(np.int64).tolist()))


def record_cluster_writes(cluster, acked: dict) -> None:
    """Log every write ``cluster`` acknowledges into ``acked``
    (:func:`ack_wave`)."""
    write_wave = cluster.write_wave

    def recording(keys_by_cs, vals_by_cs=None, is_delete=False, **kw):
        write_wave(keys_by_cs, vals_by_cs, is_delete, **kw)
        ack_wave(acked, keys_by_cs, vals_by_cs, is_delete)
    cluster.write_wave = recording


def phase_cluster(torch, leaf_search, cfg, state, spec, keyspace: int,
                  acked: dict):
    """The paper's 8-CS fleet over deploy-1B's pool: 1,024 client threads
    (128 lanes a CS a round), ``CLUSTER_OPS`` of the write-intensive mix in
    scheduler rounds, every CS with its own 64 MB cache image."""
    from repro_torch.cluster import Cluster, run_cluster
    from repro_torch.core import SHERMAN
    from repro_torch.workloads import engine
    torch.cuda.reset_peak_memory_stats()
    cl = Cluster(cfg, state, features=SHERMAN, n_clients=1024)
    record_cluster_writes(cl, acked)
    sim_by_kind = sim_time_by_kind(cl)
    ops = CLUSTER_OPS
    cspec = dataclasses.replace(spec, ops=ops)
    rounds = -(-ops // cl.n_clients)
    log(f"cluster {cl.n_cs} CSs x {cl.per_cs} lanes = {cl.n_clients} "
        f"client threads a round; {cspec.name}, {ops} ops, {rounds} "
        f"rounds, keyspace 2^30, on deploy-1B's pool")
    with ProbeCount(leaf_search) as pc:
        t0 = time.perf_counter()
        done, op_counts = run_cluster(cl, cspec, keyspace=keyspace)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    horizon = cl.counters["sim_time_s"]
    res = engine.cluster_result(cl, cspec, done, op_counts,
                                system="sherman")
    log(f"cluster run {run_s:.3f} s, {done / run_s:.1f} ops/s wall-clock "
        f"on the card ({run_s / rounds * 1e3:.3f} ms a round); netsim "
        f"mops {res.mops} p50_us {res.p50_us} p99_us {res.p99_us}; "
        f"conservation_ok {res.conservation_ok}; cross-CS conflicts "
        f"{cl.counters['cross_cs_conflicts']}; stacked write phases "
        f"{cl.counters['stacked_phases']}; leaf_search launches "
        f"{pc.launches} (pool entry {pc.launches_pool}); "
        f"{_peak(torch)}")
    log("cluster per-CS cache hit rates: " + ", ".join(
        f"CS{r['cs']} {r['cache_hit_rate']:.4f}" for r in res.per_cs)
        + "; " + maintenance_line(cl))
    total = sum(sim_by_kind.values())
    log("cluster netsim simulated time by wave kind: " + ", ".join(
        f"{k} {v} s ({v / total:.4f})" for k, v in sim_by_kind.items()))
    log("cluster probes (lookup_leaves calls) by (batch size, kernel "
        "launches a call): " + pc.line())
    if not res.conservation_ok or done != ops or res.n_ops != ops:
        raise AssertionError(f"cluster: conservation_ok "
                             f"{res.conservation_ok}, done {done} of {ops}")
    for name in ("mops", "p50_us", "p99_us"):
        v = getattr(res, name)
        if not (math.isfinite(v) and v > 0):
            raise AssertionError(f"cluster: {name}={v}")
    pc.check("cluster")

    one = dataclasses.replace(spec, ops=cl.n_clients)
    with ProbeCount(leaf_search) as one_round:
        run_cluster(cl, one, seed=4, keyspace=keyspace)   # warm, counted

    def run(seed):
        run_cluster(cl, one, seed=seed, keyspace=keyspace)
        return one.ops
    layer_split(torch, "cluster", "round", run, CLUSTER_LAYERS,
                probes=sum(one_round.probes.values()))
    return cl.state, pc.launches, res.mops, horizon


def sim_time_by_kind(cluster) -> dict:
    """Sum the makespan of the fleet's merged waves by kind (read, write,
    maint) from now on; closed loop, these sum to ``sim_time_s``."""
    by_kind: dict[str, float] = {}
    price = cluster._simulate_merged

    def summing(tagged, kind, arrivals=None):
        sim, kept = price(tagged, kind, arrivals)
        if sim is not None:
            by_kind[kind] = by_kind.get(kind, 0.0) + sim["makespan_s"]
        return sim, kept
    cluster._simulate_merged = summing
    return by_kind


def maintenance_line(cluster) -> str:
    """The fleet's cache maintenance, summed over its CSs: image fills
    and version sweeps, and the reads each costs."""
    total = {k: sum(getattr(n.cache.counters, k) for n in cluster.nodes)
             for k in ("fills", "fill_reads", "sync_sweeps", "sync_reads")}
    return (f"cache maintenance {total['fills']} fills ("
            f"{total['fill_reads']} node reads), {total['sync_sweeps']} "
            f"version sweeps ({total['sync_reads']} version reads)")


def phase_open_loop(torch, leaf_search, cfg, state, spec, keyspace: int,
                    acked: dict, rate_mops: float):
    """A fresh fleet over the same pool, driven open loop: Poisson
    arrivals at ``rate_mops`` offered, a Recorder attached, its spans
    checked against the absolute horizon and the Chrome trace of its
    served waves written.  The trace leaves out the fleet's cache
    maintenance (image fills and round sweeps: ~224k reads a CS each at
    this size, millions of verbs, ~214 bytes of JSON a verb)."""
    import tempfile
    from repro_torch.cluster import Cluster
    from repro_torch.core import SHERMAN
    from repro_torch.obs import Recorder, span_accounting, \
        write_chrome_trace
    from repro_torch.serve import run_open_loop
    from repro_torch.workloads import engine
    cl = Cluster(cfg, state, features=SHERMAN, n_clients=1024)
    rec = Recorder()
    cl.recorder = rec
    record_cluster_writes(cl, acked)
    ops = OPEN_LOOP_OPS
    ospec = dataclasses.replace(spec, ops=ops, arrival="poisson",
                                offered_mops=rate_mops)
    log(f"open    Poisson arrivals at {rate_mops} Mops offered (half the "
        f"cluster phase's netsim mops), {ops} ops, {cl.n_clients} client "
        f"threads, recorder attached")
    with ProbeCount(leaf_search) as pc:
        t0 = time.perf_counter()
        done, op_counts, info = run_open_loop(cl, ospec, keyspace=keyspace)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    res = engine.open_loop_result(cl, ospec, done, op_counts, info,
                                  system="sherman")
    spans = span_accounting(rec)
    served = Recorder()
    served.segments = [sg for sg in rec.segments if sg.label != "maint"]
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = write_chrome_trace(served, os.path.join(tmp, "open.json"))
        size = os.path.getsize(path)
        with open(path) as f:
            events = len(json.load(f)["traceEvents"])
    horizon = cl.counters["sim_time_s"]
    log(f"open    run {run_s:.3f} s, {done / run_s:.1f} ops/s wall-clock "
        f"on the card; {info['waves']} waves; sojourn p50_us {res.p50_us} "
        f"p99_us {res.p99_us}; queue_p99_us {res.queue_p99_us}; "
        f"sustained_frac {res.sustained_frac}; netsim mops {res.mops}; "
        f"conservation_ok {res.conservation_ok}; recorder "
        f"{rec.n_segments} segments, {rec.n_verbs} verbs "
        f"({rec.n_verbs - served.n_verbs} of them cache maintenance); "
        f"chrome trace of the {served.n_segments} served-wave segments "
        f"{events} events, {size} bytes, "
        f"{time.perf_counter() - t1:.3f} s; spans ok {spans['ok']}, horizon "
        f"{spans['horizon_s']} s of {horizon} s simulated; leaf_search "
        f"launches {pc.launches} (pool entry {pc.launches_pool})")
    log("open    probes (lookup_leaves calls) by (batch size, kernel "
        "launches a call): " + pc.line() + "; " + maintenance_line(cl))
    if done != ops or not res.conservation_ok or not spans["ok"] or \
            not math.isclose(spans["horizon_s"], horizon, rel_tol=1e-9) \
            or not all(sg.clocked for sg in rec.segments) or \
            not 0 < res.sustained_frac <= 1:
        raise AssertionError(f"open loop: done {done} of {ops}, "
                             f"conservation_ok {res.conservation_ok}, "
                             f"spans {spans['ok']} horizon "
                             f"{spans['horizon_s']} vs {horizon}, "
                             f"sustained {res.sustained_frac}")
    pc.check("open loop")
    return cl.state, pc.launches


def chaos_runner(system: str, device: str, spec, ckpt=None, every: int = 0):
    """The chaos runner over ``DEFAULT_CFG``'s 8 CSs with 32 client
    threads, on the fleet ``run_cluster_systems`` builds, logging its
    merged-trace digests."""
    from repro_torch.chaos import ChaosRunner
    from repro_torch.cluster import build_cluster
    from repro_torch.workloads import engine
    cl = build_cluster(engine.SYSTEMS[system], engine.DEFAULT_CFG,
                       n_clients=32, records=spec.load_records,
                       device=device)
    cl.record_traces()
    return ChaosRunner(cl, spec, seed=1, ckpt_dir=ckpt, ckpt_every=every)


def same_chaos_run(what: str, a, b) -> None:
    """Raise unless two chaos runs agree: fault logs, samples, reports,
    op counts, merged-trace digests wave for wave and the final trees."""
    from repro_torch.core.tree import state_to_numpy
    for name in ("fault_log", "samples", "op_counts"):
        if getattr(a, name) != getattr(b, name):
            raise AssertionError(f"{what}: {name} differ")
    if a.report() != b.report():
        raise AssertionError(f"{what}: reports differ")
    la, lb = a.cluster.trace_log, b.cluster.trace_log
    if la != lb:
        wave = next((i for i, (x, y) in enumerate(zip(la, lb)) if x != y),
                    min(len(la), len(lb)))
        raise AssertionError(f"{what}: trace digests differ from wave "
                             f"{wave}")
    for name, x, y in zip(a.cluster.state._fields,
                          state_to_numpy(a.cluster.state),
                          state_to_numpy(b.cluster.state)):
        if x.dtype != y.dtype or not np.array_equal(x, y):
            raise AssertionError(f"{what}: final trees differ in {name}")


def phase_chaos_parity(torch, leaf_search, get_preset):
    """The chaos runner on the quick YCSB-A spec, card == CPU, for sherman
    and fg+ under ``schedule_for_horizon`` (a memory-losing MS crash
    restored from its checkpoint and replayed, CS 1 leaving and rejoining
    cold, a hot-key storm and its lift; ``h`` from a fault-free run); the
    card's tree also equals the oracle replay of its executed write log.
    Then a snapshot written by the CPU run resumes on the card with the
    CPU run's digests."""
    import tempfile
    from repro_torch.chaos import (oracle_replay, schedule_for_horizon,
                                   tree_contents)
    from repro_torch.workloads import engine
    quick = get_preset("ycsb-a", load_records=8_000, ops=1_024, batch=512)
    keys, vals = engine.load_arrays(quick.load_records, engine.KEYSPACE,
                                    seed=0, device="cpu")
    loaded = (keys.numpy(), vals.numpy())
    with tempfile.TemporaryDirectory(prefix="chaos_parity_") as tmp:
        specs = {}
        for system in ("sherman", "fg+"):
            h = chaos_runner(system, "cpu", quick).run() \
                .cluster.counters["sim_time_s"]
            spec = specs[system] = quick.replace(
                faults=schedule_for_horizon(h, cs=1))
            runs = {}
            for dev in ("cuda", "cpu"):
                r = chaos_runner(system, dev, spec,
                                 ckpt=f"{tmp}/{system}/{dev}", every=4)
                leaf_search.launches = leaf_search.launches_pool = 0
                t0 = time.perf_counter()
                r.run()
                torch.cuda.synchronize()
                runs[dev] = (r, time.perf_counter() - t0,
                             leaf_search.launches, leaf_search.launches_pool)
            (gpu, gpu_s, launches, pool), (cpu, cpu_s, _, _) = \
                runs["cuda"], runs["cpu"]
            same_chaos_run(f"chaos {system}", gpu, cpu)
            rep = gpu.report()
            oracle_ok = tree_contents(gpu.cluster.state) == \
                dict(oracle_replay(*loaded, gpu.write_log).items())
            crash = gpu.fault_log[0]
            if not (oracle_ok and rep["conservation_ok"] and
                    rep["glt_clean"] and rep["unfired_faults"] == 0 and
                    crash["lose_memory"] and crash["replayed_waves"] >= 1
                    and launches > 0 and pool == launches):
                raise AssertionError(f"chaos {system}: oracle {oracle_ok}, "
                                     f"report {rep}, launches {launches} "
                                     f"(pool entry {pool})")
            log(f"parity  chaos {system}: GPU == CPU fault log "
                f"({len(gpu.fault_log)} faults; crash: "
                f"{crash['abandoned_repairs']} abandoned repairs, "
                f"{crash['replayed_waves']} waves replayed), samples, "
                f"report, final tree and "
                f"{len(gpu.cluster.trace_log)} merged-trace digests wave "
                f"for wave; oracle_ok True; overall mops "
                f"{rep['overall_mops']}; GPU run {gpu_s:.3f} s, CPU run "
                f"{cpu_s:.3f} s, leaf_search launches {launches} (pool "
                f"entry {pool})")
        # a CPU snapshot (round 16) resumes on the card
        whole = chaos_runner("sherman", "cpu", specs["sherman"],
                             ckpt=f"{tmp}/whole", every=4).run()
        part = chaos_runner("sherman", "cpu", specs["sherman"],
                            ckpt=f"{tmp}/resume", every=4)
        part.run(until_round=16)
        n_dig = len(part.cluster.trace_log)
        card = chaos_runner("sherman", "cuda", specs["sherman"],
                            ckpt=f"{tmp}/resume", every=4)
        if card.load_latest() != 16 or \
                card.cluster.state.keys.device.type != "cuda":
            raise AssertionError("chaos resume: not at round 16 on the card")
        card.cluster.record_traces()
        card.run()
        whole.cluster.trace_log = whole.cluster.trace_log[n_dig:]
        same_chaos_run("chaos resume", card, whole)
        log(f"parity  chaos resume: a CPU snapshot at round 16 resumes on "
            f"the card; {len(card.cluster.trace_log)} merged-trace digests, "
            f"report and final tree equal the uninterrupted CPU run's")


def phase_chaos(torch, leaf_search, cfg, state, spec, keyspace: int,
                acked: dict, horizon: float):
    """deploy-1B-chaos: a fresh 8-CS fleet on deploy-1B's pool runs the
    cluster cell's ops under ``schedule_for_horizon(horizon, ms=0, cs=1,
    lose_memory=True)``: one checkpoint at round 0 (the pool and eight
    cache images, in the system temp directory, removed at the end), MS 0
    crashing and losing its memory at 0.2 h (restore, then replay of every
    wave since), CS 1 leaving and rejoining cold, a 16-key hot storm and
    its lift.  Every write the run executed goes into ``acked`` for the
    read-back; the runner's state is returned.  ``oracle_replay`` and
    ``tree_contents`` build Python dicts of every record, so at 1B records
    the read-back is this cell's audit.  The run draws with seed 2: with
    the cluster phase's seed 1 it would write the cluster phase's own
    keys and values again, and a write lost in the crash could still
    read back right."""
    import tempfile
    from repro_torch.chaos import ChaosRunner, schedule_for_horizon
    from repro_torch.cluster import Cluster
    from repro_torch.core import SHERMAN
    cl = Cluster(cfg, state, features=SHERMAN, n_clients=1024)
    del state               # the runner's cluster holds the only pool now
    sched = schedule_for_horizon(horizon, ms=0, cs=1, lose_memory=True)
    cspec = dataclasses.replace(spec, ops=CLUSTER_OPS, faults=sched)
    log(f"chaos   {cl.n_cs} CSs x {cl.per_cs} lanes, {cspec.name}, "
        f"{CLUSTER_OPS} ops, keyspace 2^30, on deploy-1B's pool; faults at "
        f"fractions of the cluster phase's horizon {horizon} s: " + "; ".join(
            f"{e.kind} at {e.at_s} s" for e in sched))
    with tempfile.TemporaryDirectory(prefix="deploy1b_chaos_") as ckpt:
        log(f"chaos   checkpoint directory {ckpt}: "
            f"{shutil.disk_usage(ckpt).free / 1e9:.1f} GB free on its disk")
        runner = ChaosRunner(cl, cspec, seed=2, keyspace=keyspace,
                             ckpt_dir=ckpt, ckpt_every=0, keep=1)
        clock = chaos_clock(torch, runner)
        torch.cuda.reset_peak_memory_stats()
        with ProbeCount(leaf_search) as pc:
            t0 = time.perf_counter()
            runner.run()
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    rep = runner.report()
    for f in runner.fault_log:
        log(f"chaos   fault {json.dumps(f)}")
    for f in rep["faults"]:
        log(f"chaos   {f['kind']} at {f['t_fault_s']} s: ttr_s "
            f"{f['ttr_s']} degraded_mops {f['degraded_mops']}")
    log(f"chaos   netsim baseline_mops {rep['baseline_mops']} overall_mops "
        f"{rep['overall_mops']}; sim_time_s {rep['sim_time_s']}; "
        f"unfired_faults {rep['unfired_faults']}; conservation_ok "
        f"{rep['conservation_ok']}; glt_clean {rep['glt_clean']}")
    gb = clock["save_bytes"] / 1e9
    rounds_s = run_s - clock["save_s"] - clock["disk_s"] - clock["h2d_s"] \
        - clock["replay_s"]
    log(f"chaos   host clock: checkpoint save {clock['save_s']:.3f} s "
        f"({gb:.3f} GB, {gb / clock['save_s']:.3f} GB/s); restore disk to "
        f"host {clock['disk_s']:.3f} s, host to device {clock['h2d_s']:.3f}"
        f" s; replay of {clock['replayed']} waves {clock['replay_s']:.3f} "
        f"s; the rest of the run {rounds_s:.3f} s")
    log(f"chaos   run {run_s:.3f} s, {runner.done / run_s:.1f} ops/s "
        f"wall-clock on the card; leaf_search launches {pc.launches} (pool "
        f"entry {pc.launches_pool}); max_memory_allocated {peak}")
    log("chaos   probes (lookup_leaves calls) by (batch size, kernel "
        "launches a call): " + pc.line())
    fired = [f for f in rep["faults"] if not f.get("skipped")]
    if rep["unfired_faults"] or not rep["conservation_ok"] or \
            not rep["glt_clean"] or runner.done != CLUSTER_OPS or \
            not all(f["ttr_s"] is not None and math.isfinite(f["ttr_s"])
                    for f in fired) or clock["replayed"] < 1:
        raise AssertionError(f"chaos: {rep}")
    pc.check("chaos")
    mine: dict = {}
    for keys_by, vals_by, is_delete in runner.write_log:
        ack_wave(mine, keys_by, vals_by, is_delete)
    fresh = sum(1 for k, v in mine.items() if k not in acked or
                acked[k] != v)
    acked.update(mine)
    log(f"chaos   {len(runner.write_log)} write waves acknowledged "
        f"{len(mine)} keys, {fresh} of them with a value no earlier phase "
        f"acknowledged")
    return runner.cluster.state, pc.launches


def chaos_clock(torch, runner) -> dict:
    """Time the chaos runner's checkpoint save, the crash's restore (disk
    to host, host to device) and its redo replay on the host clock, each
    ending in a device synchronize; the run itself is unchanged."""
    out = dict(save_s=0.0, save_bytes=0, disk_s=0.0, h2d_s=0.0,
               replay_s=0.0, replayed=0)

    def timed(fn, key):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*a, **kw)
            torch.cuda.synchronize()
            out[key] += time.perf_counter() - t0
            return res
        return run

    save, raw = runner.save_checkpoint, runner._raw_by_key
    restore = runner._restore_tree_latest
    write_wave = runner.cluster.write_wave

    def saving():
        timed(save, "save_s")()
        step = os.path.join(runner.mgr.dir, f"step_{runner.round_no:08d}")
        out["save_bytes"] += sum(e.stat().st_size for e in os.scandir(step))

    def restoring():
        disk0 = out["disk_s"]
        t0 = time.perf_counter()
        res = restore()
        torch.cuda.synchronize()
        out["h2d_s"] += time.perf_counter() - t0 - (out["disk_s"] - disk0)
        return res

    def writing(*a, **kw):
        if not runner._replaying:
            return write_wave(*a, **kw)
        out["replayed"] += 1
        return timed(write_wave, "replay_s")(*a, **kw)
    runner.save_checkpoint = saving
    runner._raw_by_key = timed(raw, "disk_s")
    runner._restore_tree_latest = restoring
    runner.cluster.write_wave = writing
    return out


# --------------------------------------------------------------------------
# the mesh-sharded index (repro_torch.core.sharded) on gloo ranks
# --------------------------------------------------------------------------

#: tests/test_distributed_subprocess.py's geometry, for the parity mesh
SHARDED_PARITY_CFG = dict(n_ms=4, nodes_per_ms=256, fanout=8,
                          n_locks_per_ms=512, max_height=6, n_cs=2)
#: lanes of a routed lookup and of a write-intensive wave
SHARDED_BATCH = 1_024
#: write-intensive waves of deploy-1B-sharded through the pjit path: one
#: (each moves three 4.4 GB blocks through gloo twice, ~20 s; four took
#: ~80 s of the script's 1,200 s, which the training cells now need)
SHARDED_WAVES = 1
SHARDED_TIMEOUT = 900.0


def _data_shard(torch, mesh, x):
    """This rank's data shard of a global per-lane numpy array."""
    d, i = mesh.shape["data"], mesh.axis_index("data")
    n = len(x) // d
    return torch.from_numpy(np.ascontiguousarray(x[i * n:(i + 1) * n])
                            ).to(mesh.device)


def _lane_cs(n: int, n_cs: int) -> np.ndarray:
    """Lane -> compute server in contiguous blocks, as ``ShermanIndex``
    assigns them."""
    return ((np.arange(n) // max(1, -(-n // n_cs))) % n_cs).astype(np.int32)


def sharded_parity_rank(mesh, state_np, qkeys, waves):
    """A rank of the parity mesh: the routed lookup of ``qkeys`` at cache
    depth 3, then each wave through the pjit path from the bulkloaded
    state."""
    import torch
    from repro_torch.core import sharded as S
    from repro_torch.core.tree import TreeConfig, state_from_numpy
    cfg = TreeConfig(**SHARDED_PARITY_CFG)
    st = state_from_numpy(state_np, mesh.device)
    look = S.routed_lookup_fn(cfg, mesh, depth=3)(
        S.shard_tree(st, mesh, cfg), S.build_cache(cfg, st, depth=3),
        _data_shard(torch, mesh, qkeys))
    wp = S.pjit_phase_fns(cfg, mesh)
    return dict(lookup=look, waves=[
        wp(S.shard_tree(st, mesh, cfg),
           *(_data_shard(torch, mesh, x) for x in w)) for w in waves])


def _same_host(got, want, what: str) -> None:
    """Raise unless two rank results (numpy leaves) agree bit for bit."""
    if isinstance(want, dict):
        for k in want:
            _same_host(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, (tuple, list)):
        names = getattr(want, "_fields", range(len(want)))
        for k, g, w in zip(names, got, want):
            _same_host(g, w, f"{what}.{k}")
    elif np.asarray(got).dtype != np.asarray(want).dtype or \
            not np.array_equal(got, want):
        raise AssertionError(f"{what}: {got!r} != {want!r}")


def phase_sharded_parity(torch) -> None:
    """Card == CPU on the reference test's mesh (2, 4): 8 gloo ranks on
    the card and 8 on the CPU give the same routed lookups and waves bit
    for bit, and each wave's gathered pool and outputs equal the
    single-process ``write_phase`` on the whole pool and wave."""
    from repro_torch.core.sharded import tree_pspecs
    from repro_torch.core.tree import (TreeConfig, TreeState, bulkload,
                                       state_from_numpy, state_to_numpy)
    from repro_torch.core.write import write_phase
    from repro_torch.launch.mesh import run_mesh, to_host
    cfg = TreeConfig(**SHARDED_PARITY_CFG)
    rng = np.random.default_rng(1)
    keys = rng.choice(50_000, size=400, replace=False)
    vals = rng.integers(0, 1 << 20, size=400)
    b = 64
    i32 = np.int32
    wk, wv = rng.integers(0, 50_000, size=b), rng.integers(0, 100, size=b)
    new = np.random.default_rng(2).choice(
        np.setdiff1d(np.arange(50_000), keys), b, replace=False)
    waves = [(k.astype(i32), v.astype(i32), np.zeros(b, bool),
              np.ones(b, bool), cs) for k, v, cs in (
                  (wk, wv, np.zeros(b, i32)),            # the reference's
                  (new, np.arange(b), _lane_cs(b, cfg.n_cs)))]  # splits
    st = bulkload(cfg, keys, vals, device="cpu")
    state_np = dict(zip(TreeState._fields, state_to_numpy(st)))
    args = (state_np, keys[:b].astype(i32), waves)
    t0 = time.perf_counter()
    card = run_mesh(sharded_parity_rank, 2, 4, backend="gloo", args=args,
                    timeout=SHARDED_TIMEOUT)
    t1 = time.perf_counter()
    cpu = run_mesh(sharded_parity_rank, 2, 4, backend="gloo", device="cpu",
                   args=args, timeout=SHARDED_TIMEOUT)
    t2 = time.perf_counter()
    for rank, (g, c) in enumerate(zip(card, cpu)):
        _same_host(g, c, f"sharded parity rank {rank} card vs CPU")
    rows = (card[:4], card[4:])        # data index 0 and 1, model 0..3
    found = np.concatenate([row[0]["lookup"].found for row in rows])
    value = np.concatenate([row[0]["lookup"].value for row in rows])
    if not found.all() or not np.array_equal(value, vals[:b]):
        raise AssertionError("sharded parity: routed lookups missed")
    specs = tree_pspecs(cfg)
    splits = []
    for wi, w in enumerate(waves):
        want = to_host(write_phase(cfg, state_from_numpy(state_np, "cpu"),
                                   *(torch.from_numpy(x) for x in w)))
        per = [[r["waves"][wi] for r in row] for row in rows]
        for j in range(4):
            _same_host(per[1][j][0], per[0][j][0],
                       f"sharded parity wave {wi}: block {j} across data")
        pool = TreeState(*[np.concatenate([p[0][k] for p in per[0]])
                           if spec else per[0][0][0][k]
                           for k, spec in enumerate(specs)])
        _same_host(pool, want[0], f"sharded parity wave {wi}: the pool")
        for part in (1, 2, 3):        # done, stats, repair queue
            got = per[0][0][part]
            cat = (lambda a, c: np.concatenate([a, c]) if np.ndim(a) else a)
            if isinstance(got, tuple):
                got = type(got)(*[cat(a, c) for a, c in
                                  zip(got, per[1][0][part])])
            else:
                got = cat(got, per[1][0][part])
            _same_host(got, want[part], f"sharded parity wave {wi}.{part}")
        splits.append(int(want[2].n_leaf_splits))
    if not splits[1]:
        raise AssertionError("sharded parity: the split wave split nothing")
    log(f"sharded parity mesh (2, 4), {SHARDED_PARITY_CFG}: 8 gloo ranks "
        f"on the card ({t1 - t0:.3f} s) == 8 on the CPU ({t2 - t1:.3f} s) "
        f"bit for bit: routed lookups of {b} keys at cache depth 3 (all "
        f"found, the loaded values), and {len(waves)} pjit waves of {b} "
        f"lanes ({splits} leaf splits), each gathered pool, done, stats "
        f"and repair queue == the single-process write_phase")


class CardMemory:
    """Sample the card's used memory (every process's) from a thread."""

    def __init__(self, torch, every_s: float = 0.05):
        import threading
        self.torch, self.every_s, self.peak = torch, every_s, 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def used(self) -> int:
        free, total = self.torch.cuda.mem_get_info()
        return total - free

    def _run(self):
        while not self._stop.is_set():
            self.peak = max(self.peak, self.used())
            self._stop.wait(self.every_s)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def deploy_sharded_rank(mesh, cfg, handoff, acked, absent, waves):
    """One memory server of deploy-1B-sharded.  Clone this rank's block
    and the image from the launcher's pool (CUDA IPC), drop the pool and
    tell the launcher; read every acknowledged write back through routed
    lookups (``acked``: key -> value, None deleted), and 1,024 absent
    keys; time one all_reduce of a lookup's rows; apply ``waves`` (their
    reads through routed lookups, their updates through the pjit path)
    and read everything back again."""
    import gc
    import torch
    import torch.distributed as dist
    from repro_torch.core import sharded as S
    from repro_torch.kernels.leaf_search.kernel import leaf_search
    t0 = time.perf_counter()
    state = handoff.pop("state")
    height = int(state.height)
    local = S.shard_tree(state, mesh, cfg)
    cache = {k: v.clone() for k, v in handoff.pop("image").items()}
    del state
    gc.collect()
    torch.cuda.synchronize()
    out = dict(rank=mesh.rank, clone_s=time.perf_counter() - t0,
               block_bytes=sum(x.nbytes for x in local),
               image_bytes=sum(x.nbytes for x in cache.values()))
    mesh.notify_parent("cloned")

    look = S.routed_lookup_fn(cfg, mesh, depth=height - 1)
    wp = S.pjit_phase_fns(cfg, mesh)
    leaf_search.launches = 0

    def lookups(keys):
        found, value = [], []
        for lo in range(0, keys.size, SHARDED_BATCH):
            r = look(local, cache, torch.from_numpy(
                keys[lo:lo + SHARDED_BATCH]).to(mesh.device))
            found.append(r.found.cpu().numpy())
            value.append(r.value.cpu().numpy())
        return np.concatenate(found), np.concatenate(value)

    def read_back(want: dict, what: str) -> float:
        k = np.fromiter(want, np.int64).astype(np.int32)
        present = np.fromiter((v is not None for v in want.values()), bool)
        v = np.fromiter((-1 if v is None else v for v in want.values()),
                        np.int64).astype(np.int32)
        t = time.perf_counter()
        found, got = lookups(k)
        s = time.perf_counter() - t
        bad = (found != present) | (found & (got != v))
        if bad.any():
            raise AssertionError(f"rank {mesh.rank} {what}: "
                                 f"{int(bad.sum())} of {k.size} keys read "
                                 f"back wrong, first {k[bad][0]}")
        return s

    out["readback_s"] = read_back(acked, "read-back")
    out["readback_n"] = len(acked)
    found, _ = lookups(absent)
    if found.any():
        raise AssertionError(f"rank {mesh.rank}: {int(found.sum())} absent "
                             "keys found")

    buf = torch.zeros((SHARDED_BATCH, 4 * cfg.fanout + 4),
                      dtype=torch.int32, device=mesh.device)
    times = []
    for _ in range(23):
        torch.cuda.synchronize()
        t = time.perf_counter()
        dist.all_reduce(buf, group=mesh.mem_group)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    out["allreduce_ms"] = float(np.median(times[3:])) * 1e3

    out["waves"] = []
    for reads, keys, vals in waves:
        # the wave's reads: every drawn key is a loaded record, and one
        # that an earlier phase acknowledged reads its latest value
        exp = [acked.get(k, "loaded") for k in reads.tolist()]
        known = np.array([e is not None and e != "loaded" for e in exp])
        want_v = np.array([e if k else -1 for e, k in zip(exp, known)],
                          np.int64)
        found, got = lookups(reads)
        bad = (found != np.array([e is not None for e in exp])) | \
            (known & (got != want_v))
        if bad.any():
            raise AssertionError(f"rank {mesh.rank}: {int(bad.sum())} of "
                                 f"a wave's {reads.size} reads wrong")
        b = keys.size
        local, done, _, _ = wp(
            local, torch.from_numpy(keys).to(mesh.device),
            torch.from_numpy(vals).to(mesh.device),
            torch.zeros(b, dtype=torch.bool, device=mesh.device),
            torch.ones(b, dtype=torch.bool, device=mesh.device),
            torch.from_numpy(_lane_cs(b, cfg.n_cs)).to(mesh.device))
        if not bool(done.all()):
            raise AssertionError(f"rank {mesh.rank}: a wave left lanes "
                                 "undone")
        acked.update(zip(keys.astype(np.int64).tolist(),
                         vals.astype(np.int64).tolist()))
        out["waves"].append(dict(wp.split))
    out["final_s"] = read_back(acked, "read-back after the waves")
    out["final_n"] = len(acked)
    torch.cuda.synchronize()
    out.update(launches=leaf_search.launches,
               held_bytes=torch.cuda.memory_allocated(),
               peak_bytes=torch.cuda.max_memory_allocated())
    return out


def phase_sharded(torch, dep: dict) -> int:
    """deploy-1B-sharded: deploy-1B's pool, as the earlier phases leave it,
    on mesh (data 1, model 4), one gloo rank a memory server on the one
    card.  Each rank clones its block of the pool and an image of every
    internal level from this process (CUDA IPC), which then drops the
    pool, so only the write path's coordinator ever holds the whole pool,
    during a wave.  The ranks read back every write the earlier phases
    acknowledged and 1,024 absent keys through routed lookups, then apply
    ``SHARDED_WAVES`` write-intensive waves (seed 3) and read everything
    back again.  Returns the leaf-search launches summed over the ranks."""
    from repro_torch.core import sharded as S
    from repro_torch.core.ops import lookup_batch
    from repro_torch.launch.mesh import start_mesh
    from repro_torch.workloads.engine import VAL_MASK
    from repro_torch.workloads.keygen import draw_keys
    cfg, spec, keyspace = dep["cfg"], dep["spec"], dep["keyspace"]
    acked = dep["acked"]
    t0 = time.perf_counter()
    state = dep.pop("state")
    height = int(state.height)
    n_internal = int(((state.level >= 1) & ~state.free_bit).sum())
    image = S.build_cache(cfg, state, depth=height - 1, max_rows=n_internal)
    cached = int(image["valid"].sum())
    if cached != n_internal:
        raise AssertionError(f"sharded: image holds {cached} of "
                             f"{n_internal} internal rows")
    # absent keys: keys of the keyspace the pool does not hold
    rng = np.random.default_rng(5)
    cand = np.unique(rng.integers(0, keyspace, 1 << 16))
    cand = cand[~np.isin(cand, np.fromiter(acked, np.int64))]
    r = lookup_batch(cfg, state, torch.from_numpy(cand.astype(np.int32)
                                                  ).cuda())
    absent = cand[~r.found.cpu().numpy()][:SHARDED_BATCH].astype(np.int32)
    if absent.size != SHARDED_BATCH:
        raise AssertionError(f"sharded: {absent.size} absent keys drawn")
    del r
    rng3 = np.random.default_rng(3)
    counts = spec.batch_counts(SHARDED_BATCH)

    def draw(n):
        return draw_keys(rng3, n, distribution=spec.distribution,
                         theta=spec.theta, nspace=spec.load_records,
                         keyspace=keyspace).astype(np.int32)
    waves = []
    for _ in range(SHARDED_WAVES):
        reads, keys = draw(counts["read"]), draw(counts["update"])
        waves.append((reads, keys, rng3.integers(0, VAL_MASK, keys.size
                                                 ).astype(np.int32)))
    prep_s = time.perf_counter() - t0
    log(f"sharded deploy-1B-sharded: gloo, {cfg.n_ms} ranks (data 1 x "
        f"model {cfg.n_ms}), one card; pool {cfg.n_nodes} rows, height "
        f"{height}; image of {height - 1} internal levels, {cached} rows "
        f"(every internal row, evicted 0); {len(acked)} acknowledged "
        f"writes to read back, {absent.size} absent keys; {len(waves)} "
        f"waves of {SHARDED_BATCH} ops ({counts['read']} reads, "
        f"{counts['update']} updates, seed 3); set-up {prep_s:.3f} s "
        f"(the image, the absent keys, the waves' draws)")
    cloned, parent = set(), {}

    def on_message(rank, _):
        cloned.add(rank)
        if len(cloned) == cfg.n_ms:       # every rank has its own block
            gc.collect()
            torch.cuda.ipc_collect()
            torch.cuda.empty_cache()
            parent.update(held=torch.cuda.memory_allocated(),
                          card=card.used(), at=time.perf_counter() - t0)

    handoff = dict(state=state, image=image)
    torch.cuda.empty_cache()        # the earlier phases' cached blocks
    with CardMemory(torch) as card:
        ranks = start_mesh(deploy_sharded_rank, 1, cfg.n_ms, backend="gloo",
                           args=(cfg, handoff, acked, absent, waves),
                           timeout=SHARDED_TIMEOUT)
        del state, image, handoff
        res = ranks.join(on_message)
    phase_s = time.perf_counter() - t0
    if len(cloned) != cfg.n_ms or parent["held"] > 1 << 30:
        raise AssertionError(f"sharded: the launcher still holds "
                             f"{parent.get('held')} bytes")
    r0 = res[0]
    gb = r0["block_bytes"] / 1e9
    log(f"sharded handoff: each rank cloned its block ({gb:.3f} GB) and "
        f"the image ({r0['image_bytes'] / 1e9:.3f} GB) in "
        f"{max(r['clone_s'] for r in res):.3f} s; then the launcher held "
        f"{parent['held']} bytes and the card {parent['card']} "
        f"({parent['at'] - prep_s:.3f} s after the spawn began)")
    n = r0["readback_n"]
    log(f"sharded read back {n} acknowledged writes of the deploy, cluster,"
        f" open-loop and chaos phases through routed lookups in batches of "
        f"{SHARDED_BATCH}: {r0['readback_s']:.3f} s, "
        f"{n / r0['readback_s']:.1f} routed lookups/s on the host clock; "
        f"{absent.size} absent keys found False")
    log(f"sharded all_reduce of a lookup's rows ([{SHARDED_BATCH}, "
        f"{4 * cfg.fanout + 4}] int32) over the mem row: "
        f"{r0['allreduce_ms']:.3f} ms (median of 20, rank 0)")
    for i, w in enumerate(r0["waves"]):
        blocks = cfg.n_ms - 1
        log(f"sharded wave {i}: coordinator gather {w['gather_s']:.3f} s "
            f"({blocks} blocks of {w['block_bytes'] / 1e9:.3f} GB, "
            f"{w['gather_s'] / blocks * 1e3:.1f} ms a block, "
            f"{blocks * w['block_bytes'] / w['gather_s'] / 1e9:.3f} GB/s), "
            f"write_phase {w['write_phase_s']:.3f} s, send-back "
            f"{w['send_s']:.3f} s ({w['send_s'] / blocks * 1e3:.1f} ms a "
            f"block)")
    log(f"sharded read back {r0['final_n']} writes after the waves: "
        f"{r0['final_s']:.3f} s, {r0['final_n'] / r0['final_s']:.1f} "
        f"routed lookups/s")
    launches = [r["launches"] for r in res]
    held = [r["held_bytes"] for r in res]
    log(f"sharded leaf_search launches per rank {launches}; "
        f"max_memory_allocated per rank {[r['peak_bytes'] for r in res]}; "
        f"memory_allocated outside the wave {held}; card peak used "
        f"{card.peak} (sampled every {card.every_s} s); phase "
        f"{phase_s:.3f} s")
    for r in res:
        if r["launches"] <= 0 or \
                r["held_bytes"] > r["block_bytes"] + r["image_bytes"] + \
                (64 << 20):
            raise AssertionError(f"sharded rank {r['rank']}: {r}")
    return sum(launches)


def phase_flash(torch, flash_attention, attention_ref, route_of):
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(11)
    max_err = 0.0
    torch.cuda.reset_peak_memory_stats()
    timed = {}
    for b, h, kv, s, hd, causal, dt, atol, rtol in FLASH_SHAPES:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn((b, n, s, hd), generator=gen, device="cuda")
                   .to(dtype) for n in (h, kv, kv))
        got = flash_attention(q, k, v, causal=causal)
        want = attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = _check_close(torch, got, want, atol, rtol,
                           f"flash_attention B={b} H={h} KV={kv} S={s} "
                           f"hd={hd} {dt}")
        max_err = max(max_err, err)
        log(f"kernel  flash_attention B={b} H={h} KV={kv} S={s} hd={hd} "
            f"causal={causal} {dt} ({route_of(dtype, hd)} route): max abs "
            f"error {err} (atol {atol} rtol {rtol}; max |out| "
            f"{float(want.float().abs().max())})")
        if (b, h, kv, s, hd, dt) in FLASH_TIMED and causal:
            timed[(b, h, kv, s, hd, dt)] = (q, k, v)
        del got, want
        torch.cuda.empty_cache()
    numbers = None
    for key in FLASH_TIMED:
        b, h, kv, s, hd, dt = key
        q, k, v = timed.pop(key)
        route = route_of(q.dtype, hd)
        reps = 20 if route == "wgmma" else 3
        kernel = lambda: flash_attention(q, k, v, causal=True)
        library = lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)
        ms = device_ms(torch, kernel, reps=reps, samples=5)
        call_ms = host_ms(torch, kernel, reps=reps, samples=5)
        lib_ms = device_ms(torch, library, reps=reps, samples=5)
        # the work: 4·hd flops per unmasked (query, key) pair and head, at
        # the tensor cores' bf16 rate in bf16 and the FMA units' in f32,
        # against q, k, v and o moved once
        pairs = s * (s + 1) // 2
        n_ops = 4 * b * h * pairs * hd
        n_bytes = q.element_size() * (2 * b * s * h * hd + 2 * b * s * kv * hd)
        rate = BF16_TENSOR_OPS_S if dt == "bfloat16" else SCALAR_OPS_S
        ops_ms = n_ops / rate * 1e3
        bytes_ms = n_bytes / HBM_BYTES_S * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        line = (f"kernel  flash_attention B={b} H={h} KV={kv} S={s} hd={hd} "
                f"{dt} causal ({route} route): device {ms:.6f} ms (CUDA "
                f"graph of {reps} calls); per eager call {call_ms:.6f} ms; "
                f"SDPA {lib_ms:.6f} ms (CUDA graph of {reps} calls); bound "
                f"{bound_ms:.6f} ms ({n_ops} flops at {dt} peak "
                f"{ops_ms:.6f} ms, {n_bytes} bytes {bytes_ms:.6f} ms); "
                f"{ms / bound_ms:.3f}x the bound, {ms / lib_ms:.3f}x SDPA")
        if (h, hd, dt) == (32, 128, "bfloat16"):      # the main path's
            plain_ms = host_ms(torch, lambda: attention_ref(
                q, k, v, causal=True), reps=2, samples=3)
            line += f"; plain {plain_ms:.6f} ms per eager call"
            numbers = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                           bound_ms=bound_ms,
                           bound_by=("operations" if ops_ms >= bytes_ms
                                     else "bytes"),
                           host_ms=call_ms, library_ms=lib_ms)
        log(f"{line}; {_peak(torch)}")
        del q, k, v
        torch.cuda.empty_cache()
    return numbers


def phase_flash_window(torch, flash_attention, attention_ref, route_of):
    """K2's sliding window, hd 256 and cross shapes against the plain
    version (``FLASH_WINDOWED``), then recurrentgemma-2b's local attention
    timed against its bound and SDPA with the same boolean mask (raise if
    the kernel is the slower); return its numbers."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(13)
    torch.cuda.reset_peak_memory_stats()
    max_err = 0.0
    for (b, h, kv, sq, sk, hd, causal, window, dt, atol,
         rtol) in FLASH_WINDOWED:
        dtype = getattr(torch, dt)
        q = torch.randn((b, h, sq, hd), generator=gen, device="cuda").to(
            dtype)
        k, v = (torch.randn((b, kv, sk, hd), generator=gen, device="cuda")
                .to(dtype) for _ in range(2))
        kw = dict(causal=causal, window=window)
        got = flash_attention(q, k, v, **kw)
        want = attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        what = (f"flash_attention B={b} H={h} KV={kv} Sq={sq} Sk={sk} "
                f"hd={hd} causal={causal} window={window} {dt}")
        err = _check_close(torch, got, want, atol, rtol, what)
        max_err = max(max_err, err)
        log(f"kernel  {what} ({route_of(dtype, hd, window)} "
            f"route): max abs error {err} (atol {atol} rtol {rtol}; max "
            f"|out| {float(want.float().abs().max())})")
        del q, k, v, got, want
        torch.cuda.empty_cache()
    b, h, kv, s, hd, window = GRIFFIN_ATTN
    q = torch.randn((b, h, s, hd), generator=gen, device="cuda").to(
        torch.bfloat16)
    k, v = (torch.randn((b, kv, s, hd), generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    idx = torch.arange(s, device="cuda")
    mask = ((idx[:, None] >= idx[None, :])
            & (idx[:, None] - idx[None, :] < window))
    route = route_of(q.dtype, hd, window)
    reps = 20 if route == "wgmma" else 5
    kernel = lambda: flash_attention(q, k, v, causal=True, window=window)
    library = lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True)
    # SDPA computes the same function: check it before timing it
    _check_close(torch, library(), kernel(), 4e-3, 1e-2,
                 "SDPA with the window mask vs the kernel")
    ms = device_ms(torch, kernel, reps=reps, samples=5)
    call_ms = host_ms(torch, kernel, reps=reps, samples=5)
    lib_ms = device_ms(torch, library, reps=reps, samples=5)
    plain_ms = host_ms(torch, lambda: attention_ref(
        q, k, v, causal=True, window=window), reps=2, samples=3)
    # the work: 4·hd flops per unmasked (query, key) pair and head at the
    # bf16 tensor rate, against q, k, v and o moved once
    pairs = sum(min(i + 1, window) for i in range(s))
    n_ops = 4 * b * h * pairs * hd
    n_bytes = q.element_size() * (2 * b * s * h * hd + 2 * b * s * kv * hd)
    ops_ms = n_ops / BF16_TENSOR_OPS_S * 1e3
    bytes_ms = n_bytes / HBM_BYTES_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    log(f"kernel  flash_attention B={b} H={h} KV={kv} S={s} hd={hd} "
        f"window={window} bfloat16 causal ({route} route): device "
        f"{ms:.6f} ms (CUDA graph of {reps} calls); per eager call "
        f"{call_ms:.6f} ms; SDPA with the boolean window mask {lib_ms:.6f} "
        f"ms (CUDA graph of {reps} calls); plain {plain_ms:.6f} ms per "
        f"eager call; bound "
        f"{bound_ms:.6f} ms ({pairs} pairs a head, {n_ops} flops at bf16 "
        f"peak {ops_ms:.6f} ms, {n_bytes} bytes {bytes_ms:.6f} ms); "
        f"{ms / bound_ms:.3f}x the bound, {ms / lib_ms:.3f}x SDPA; "
        f"{_peak(torch)}")
    if ms > lib_ms:
        raise AssertionError(f"K2 at recurrentgemma's local attention: "
                             f"{ms:.6f} ms on the {route} route, slower "
                             f"than SDPA with the mask ({lib_ms:.6f} ms)")
    return dict(route=route, shape=dict(B=b, H=h, KV=kv, S=s, hd=hd,
                                        window=window, dtype="bfloat16"),
                max_abs_err=max_err, ms=ms, host_ms=call_ms,
                plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                library_ms=lib_ms)


def phase_wkv(torch, wkv6, wkv6_ref, wkv6_seq):
    gen = torch.Generator(device="cuda").manual_seed(12)
    max_err = 0.0
    torch.cuda.reset_peak_memory_stats()
    for b, h, t, n, dt in WKV_SHAPES:
        dtype = getattr(torch, dt)
        r, k, v = (torch.randn((b, h, t, n), generator=gen, device="cuda")
                   .to(dtype) for _ in range(3))
        w = (torch.rand((b, h, t, n), generator=gen, device="cuda") * 0.5
             + 0.45).to(dtype)
        u = torch.randn((h, n), generator=gen, device="cuda").to(dtype)
        got = wkv6(r, k, v, w, u)
        want = wkv6_ref(r, k, v, w, u)
        torch.cuda.synchronize()
        err = _check_close(torch, got, want, WKV_TOL[dt], WKV_TOL[dt],
                           f"wkv6 B={b} H={h} T={t} N={n} {dt}")
        max_err = max(max_err, err)
        log(f"kernel  wkv6 B={b} H={h} T={t} N={n} {dt}: max abs error "
            f"{err} (tol {WKV_TOL[dt]})")
    # the main path's shape: the model layout [B,T,H,N], which the forward
    # passes to wkv6_seq as transposed views, gives the kernel layout's
    # bits, and so does a second launch
    model = [x.transpose(1, 2).contiguous() for x in (r, k, v, w)]
    got_model = wkv6_seq(*model, u).transpose(1, 2)
    again = wkv6(r, k, v, w, u)
    torch.cuda.synchronize()
    if not (torch.equal(got_model, got) and torch.equal(again, got)):
        raise AssertionError("wkv6: the model layout or a second launch "
                             "changed the bits")
    kernel = lambda: wkv6(r, k, v, w, u)
    ms = device_ms(torch, kernel, reps=20, samples=5)
    ms_model = device_ms(torch, lambda: wkv6_seq(*model, u), reps=20,
                         samples=5)
    call_ms = host_ms(torch, kernel, reps=20, samples=5)
    plain_ms = host_ms(torch, lambda: wkv6_ref(r, k, v, w, u), reps=1,
                       samples=3)
    # the work: r, k, v, w in and the f32 o out once each, and u; about
    # 4·N² flops per token and head (the output pass and the state update
    # over the [N, N] state, a multiply-add each)
    n_bytes = 4 * b * h * t * n * r.element_size() + 4 * b * h * t * n \
        + h * n * u.element_size()
    n_ops = 4 * n * n * b * h * t
    bytes_ms = n_bytes / HBM_BYTES_S * 1e3
    ops_ms = n_ops / SCALAR_OPS_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    log(f"kernel  wkv6 B={b} H={h} T={t} N={n} f32: device {ms:.6f} ms "
        f"kernel layout, {ms_model:.6f} ms model layout (CUDA graph of 20 "
        f"calls; model layout == kernel layout == a second launch, bit for "
        f"bit); per eager call {call_ms:.6f} ms; plain {plain_ms:.6f} ms "
        f"per eager call; bound {bound_ms:.6f} ms ({n_bytes} bytes "
        f"{bytes_ms:.6f} ms, {n_ops} flops at f32 peak {ops_ms:.6f} ms); "
        f"{ms / bound_ms:.3f}x the bound; {_peak(torch)}")
    return dict(max_abs_err=max_err, ms=ms, ms_model_layout=ms_model,
                plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                host_ms=call_ms, library_ms=None)


# the loss kernel at the training cells' shapes: (loss rows B × (S − 1),
# vocabulary, width) of train-internvl2-1b and train-rwkv6-1.6b (the
# benchmark's cells), train-whisper-medium and train-recurrentgemma-2b
# (batch 1); internvl2's and whisper's vocabularies are padded to the next
# multiple of 64, the other two are such multiples.  The nll is held at
# 1e-5 relative (two f32 log-sum-exps in other orders) and the gradient at
# one bf16 step (the f32 values before the one rounding differ in the
# last bits); the plain version runs in row chunks of HEAD_LOSS_CHUNK to
# keep its f32 copies small
HEAD_LOSS_SHAPES = {"internvl_train": (16380, 151655, 896),
                    "rwkv6_train": (16380, 65536, 2048),
                    "whisper_train": (16380, 51865, 1024),
                    "recurrentgemma_train": (4095, 256000, 2560)}
HEAD_LOSS_RTOL = 1e-5
HEAD_LOSS_CHUNK = 1024


def bf16_steps_apart(torch, got, want) -> int:
    """The largest distance in bf16 steps between ``got`` and ``want``
    (0 where they are equal, +0 and -0 included)."""
    off = (got.view(torch.int16).int() - want.view(torch.int16).int()).abs()
    return int(torch.where(got == want, 0, off).max())


def phase_head_loss(torch, loss_rows, loss_rows_ref, pad_vocab):
    """The loss kernel against its plain version at ``HEAD_LOSS_SHAPES``,
    on the buffer the training path makes (h @ the padded head, bf16,
    logits of about unit spread, a label at V − 1): each row's nll within
    ``HEAD_LOSS_RTOL`` relative and the mean too, the gradient written in
    place within one bf16 step, the pad columns 0, one launch a call; a
    read-only launch (an eval loss) leaves the buffer's bits and gives the
    same nll bit for bit.  Timed beside its bound (the buffer read once
    and written once at HBM's rate) and the plain version over the whole
    buffer.  Returns internvl2-1b's numbers, every shape's in
    ``by_shape``."""
    by_shape = {}
    for label, (n, v, d) in HEAD_LOSS_SHAPES.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device="cuda").manual_seed(13)
        h = torch.randn(n, d, generator=gen, device="cuda").bfloat16()
        w = (torch.randn(v, d, generator=gen, device="cuda")
             / d ** 0.5).bfloat16()
        buf = h @ pad_vocab(w).T
        v_pad = buf.shape[1]
        del h, w
        labels = torch.randint(0, v, (n,), generator=gen, device="cuda")
        labels[0] = v - 1
        scale = torch.full((n,), 1.0 / n, device="cuda")
        want_buf, ro_buf = buf.clone(), buf.clone()
        what = f"head_loss {label} N={n} V={v} V_pad={v_pad}"
        n0 = loss_rows.launches
        ro = loss_rows(ro_buf, v, labels, scale, write_grad=False)
        torch.cuda.synchronize()
        if not same_bits(torch, ro_buf, want_buf):
            raise AssertionError(f"{what}: the read-only launch wrote the "
                                 "buffer")
        want = torch.cat([
            loss_rows_ref(want_buf[i:i + HEAD_LOSS_CHUNK], v,
                          labels[i:i + HEAD_LOSS_CHUNK],
                          scale[i:i + HEAD_LOSS_CHUNK])
            for i in range(0, n, HEAD_LOSS_CHUNK)])
        got = loss_rows(buf, v, labels, scale)
        torch.cuda.synchronize()
        if loss_rows.launches != n0 + 2:
            raise AssertionError(f"{what}: {loss_rows.launches - n0} "
                                 "launches for two calls")
        nll_err = float(((got - want).abs() / want.abs()).max())
        mean_err = abs(float(got.mean()) - float(want.mean())) \
            / abs(float(want.mean()))
        if max(nll_err, mean_err) > HEAD_LOSS_RTOL:
            raise AssertionError(f"{what}: nll {nll_err}, mean {mean_err} "
                                 f"relative from the plain version's")
        steps = max(bf16_steps_apart(torch, buf[i:i + HEAD_LOSS_CHUNK],
                                     want_buf[i:i + HEAD_LOSS_CHUNK])
                    for i in range(0, n, HEAD_LOSS_CHUNK))
        if steps > 1:
            raise AssertionError(f"{what}: the gradient {steps} bf16 steps "
                                 "from the plain version's")
        if not bool((buf[:, v:] == 0).all()):
            raise AssertionError(f"{what}: a pad column is not 0")
        del want_buf
        if not same_bits(torch, ro, got):
            raise AssertionError(f"{what}: the read-only launch's nll "
                                 "differs from the writing launch's")
        kernel = lambda: loss_rows(buf, v, labels, scale)
        ms = device_ms(torch, kernel, reps=20, samples=5)
        call_ms = host_ms(torch, kernel, reps=20, samples=5)
        del buf
        torch.cuda.empty_cache()
        plain_ms = once_ms(torch, lambda: loss_rows_ref(ro_buf, v, labels,
                                                        scale), samples=3)
        n_bytes = 2 * n * v_pad * ro_buf.element_size()
        bound_ms = n_bytes / HBM_BYTES_S * 1e3
        log(f"kernel  {what} bf16: nll within {nll_err:.3e} relative of "
            f"the plain version's (mean {mean_err:.3e}), gradient within "
            f"{steps} bf16 step, pad columns 0; the read-only launch left "
            f"the buffer and gave the same nll bit for bit; device "
            f"{ms:.6f} ms (CUDA graph of 20 calls), per eager call "
            f"{call_ms:.6f} ms; plain version {plain_ms:.6f} ms a call "
            f"(the whole buffer); bound "
            f"{bound_ms:.6f} ms ({n_bytes} bytes, the buffer read and "
            f"written once); {bound_ms / ms:.3f} of the bound; "
            f"{_peak(torch)}")
        by_shape[label] = dict(shape=dict(N=n, V=v, V_pad=v_pad, D=d,
                                          dtype="bfloat16"),
                               nll_rel_err=nll_err, grad_bf16_steps=steps,
                               ms=ms, host_ms=call_ms, plain_ms=plain_ms,
                               bound_ms=bound_ms, bound_by="bytes")
        del ro_buf, ro, got, want, labels, scale
        torch.cuda.empty_cache()
    main = dict(by_shape["internvl_train"])
    main["by_shape"] = by_shape
    return main


# the grouped expert product at the train-qwen1.5-moe-a2.7b cell's shape:
# the 16,384 tokens' 65,536 sorted (token, choice) rows, of which the 15
# held experts take a skewed 24,938 (as the cell's Zipf routing skews
# them: 6,354 to 26,937 a layer), one expert none and one a single row
MOE_GMM_COUNTS = [6000, 4000, 3000, 2500, 2000, 1800, 1500, 1200, 1000,
                  800, 600, 400, 137, 0, 1]
MOE_GMM_ROWS = 65_536
MOE_GMM_D, MOE_GMM_F = 2048, 1408
# the kernel rounds its f32 sum to bf16 once: within half a bf16 step
# (2^-8 of the value at most) of the f32 plain version, plus 2^-12 of the
# result's largest magnitude for the f32 sums' other order (~1e-6 of it)
MOE_GMM_RTOL, MOE_GMM_ATOL = 2.0 ** -8, 2.0 ** -12


def moe_gmm_bound_ms(pairs: int, k: int, n: int) -> float:
    """One grouped product over ``pairs`` rows at the tensor cores' bf16
    rate: 2·pairs·k·n operations (the operands' bytes take less time at
    the cell's shape)."""
    return 2.0 * pairs * k * n / BF16_TENSOR_OPS_S * 1e3


def phase_moe_gmm(torch, gmm, gmm_dw, gmm_ref, gmm_dw_ref):
    """Both grouped kernels against their plain version (f32 on the card,
    TF32 off) at ``MOE_GMM_COUNTS``, gate/up (D → F) and down (F → D):
    the forward, the rows' gradient (the same kernel on the transposed
    weights) and the weights' gradient, each element within
    ``MOE_GMM_RTOL`` of its value plus ``MOE_GMM_ATOL`` of the largest;
    the rows past the groups 0, the empty group's weight gradient 0, one
    launch a call, a rerun bit for bit.  Each timed (a CUDA graph of 20
    calls, the output's zero fill included) beside its bound and the
    plain version.  Returns the forward's numbers at gate/up, every
    product's in ``by_product``."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    counts, m = MOE_GMM_COUNTS, MOE_GMM_ROWS
    pairs, empty = sum(counts), counts.index(0)
    ends = torch.tensor(counts, device="cuda").cumsum(0).to(torch.int32)
    by_product = {}
    for label, k, n in (("gate_up", MOE_GMM_D, MOE_GMM_F),
                        ("down", MOE_GMM_F, MOE_GMM_D)):
        a = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
        w = (torch.randn(len(counts), k, n, generator=gen, device="cuda")
             / k ** 0.5).bfloat16()
        d = torch.randn(m, n, generator=gen, device="cuda").bfloat16()
        products = {
            "forward": (gmm, lambda: gmm(a, w, ends),
                        lambda: gmm_ref(a.float(), w.float(), ends)),
            "rows_grad": (gmm, lambda: gmm(d, w.transpose(1, 2), ends),
                          lambda: gmm_ref(d.float(),
                                          w.float().transpose(1, 2), ends)),
            "weights_grad": (gmm_dw, lambda: gmm_dw(a, d, ends),
                             lambda: gmm_dw_ref(a.float(), d.float(),
                                                ends))}
        for kind, (wrapper, kernel, plain) in products.items():
            what = (f"moe_gmm {label}.{kind} M={m} groups={len(counts)} "
                    f"pairs={pairs} K={k} N={n}")
            n0 = wrapper.launches
            got = kernel()
            torch.cuda.synchronize()
            if wrapper.launches != n0 + 1:
                raise AssertionError(f"{what}: {wrapper.launches - n0} "
                                     "launches for one call")
            want = plain()
            top = want.abs().max()
            worst = float(((got.float() - want).abs()
                           / (MOE_GMM_RTOL * want.abs()
                              + MOE_GMM_ATOL * top)).max())
            if worst > 1:
                raise AssertionError(f"{what}: {worst:.3f} of the "
                                     "tolerance from the plain version")
            if kind == "weights_grad":
                if not bool((got[empty] == 0).all()):
                    raise AssertionError(f"{what}: the empty group's "
                                         "gradient is not 0")
            elif not bool((got[pairs:] == 0).all()):
                raise AssertionError(f"{what}: a row past the groups is "
                                     "not 0")
            if not same_bits(torch, kernel(), got):
                raise AssertionError(f"{what}: a rerun gave other bits")
            del want
            ms = device_ms(torch, kernel, reps=20, samples=5)
            plain_ms = once_ms(torch, plain, samples=3)
            bound_ms = moe_gmm_bound_ms(pairs, k, n)
            log(f"kernel  {what} bf16: within {worst:.3f} of the tolerance "
                f"(2^-8 of each value + 2^-12 of the largest, from the f32 "
                f"plain version), rows past the groups and the empty group "
                f"0, a rerun bit for bit; device {ms:.6f} ms (CUDA graph of 20 "
                f"calls); plain version {plain_ms:.6f} ms; bound "
                f"{bound_ms:.6f} ms (2·P·K·N at the bf16 rate); "
                f"{bound_ms / ms:.3f} of the bound; {_peak(torch)}")
            by_product[f"{label}.{kind}"] = dict(
                shape=dict(M=m, groups=len(counts), pairs=pairs, K=k, N=n,
                           dtype="bfloat16"),
                tol_share=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="operations")
            del got
        del a, w, d
        torch.cuda.empty_cache()
    main = dict(by_product["gate_up.forward"])
    main["by_product"] = by_product
    return main


# AdamW's kernels over train-rwkv6-1.6b's own leaves: the model's 582
# tensors (1.60 B bf16 weights, f32 moments), bf16 gradients of about 1e-3
# (a norm of about 40, so the clip's scale is below 1) and a second step's
# fresh gradients; the norm within ADAMW_NORM_RTOL of an f64 sum (the
# kernel sums in f64 in a fixed order, so its one f32 rounding is ~6e-8)
ADAMW_CELL = "rwkv6-1.6b"
ADAMW_STEPS = 2
ADAMW_NORM_RTOL = 1e-6


def reset_adamw(kernel) -> None:
    kernel.update.launches = kernel.update.leaves = kernel.update.copied = 0
    kernel.sumsq.launches = 0


def adamw_launches(kernel) -> dict:
    """The AdamW kernels' launches so far: the update's, and the norm's
    (its finalize included)."""
    return {"update": kernel.update.launches, "sumsq": kernel.sumsq.launches}


def adamw_per_step(numels) -> dict:
    """The AdamW kernels' launches in one step over leaves of ``numels``
    elements: one update launch a table of leaves, the norm's as many and
    its finalize."""
    from repro_torch.kernels.adamw import ops
    n = len(ops.plan(numels))
    return {"update": n, "sumsq": n + 1}


def expect_adamw(kernel, numels, steps: int, what: str) -> dict:
    """Raise unless the AdamW kernels launched ``steps`` steps' worth over
    leaves of ``numels`` elements, every leaf sent to the update kernel
    and no gradient copied; returns the launches."""
    got = adamw_launches(kernel)
    want = {k: steps * n for k, n in adamw_per_step(numels).items()}
    leaves = steps * sum(1 for n in numels if n)
    if got != want or kernel.update.leaves != leaves \
            or kernel.update.copied:
        raise AssertionError(
            f"{what}: AdamW launches {got}, {kernel.update.leaves} leaves, "
            f"{kernel.update.copied} gradients copied; expected {want}, "
            f"{leaves} and 0")
    return got


def phase_adamw(torch, get, registry, flat_params, kernel, ref, adamw):
    """AdamW's kernels (``adamw_update_kernel``, ``adamw_sumsq_kernel`` and
    its finalize) over ``ADAMW_CELL``'s leaves at full width, against the
    plain loop they replaced (``kernels/adamw/ref.py``) on the card: for
    ``ADAMW_STEPS`` steps the same scalars (the schedule's lr, the clip's
    scale from the kernel's norm, the bias corrections) go to both, and
    every weight and moment must come out bit for bit; the norm within
    ``ADAMW_NORM_RTOL`` of an f64 sum and equal in two runs; one update
    launch and two of the norm a step.  Timed over 20 eager calls each
    (CUDA events) beside the byte bound (the norm reads each gradient
    once; the update reads gradient, weight and moments and writes weight
    and moments: 24 B a bf16 weight for both) and the plain loop."""
    cfg = get(ADAMW_CELL)
    api = registry.build(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(21)
    model = init_model(torch, api, gen, "adamw")
    params = [p.detach() for p in flat_params(api.param_tree(model))]
    ms = [torch.zeros(p.shape, device="cuda") for p in params]
    vs = [torch.zeros(p.shape, device="cuda") for p in params]
    twin = [x.clone() for x in params + ms + vs]
    n = len(params)
    p2, m2, v2 = twin[:n], twin[n:2 * n], twin[2 * n:]
    numels = [p.numel() for p in params]
    weights = sum(numels)
    opt = adamw.AdamWConfig(**TRAIN_OPT)
    hyper = dict(b1=opt.b1, b2=opt.b2, eps=opt.eps,
                 weight_decay=opt.weight_decay)
    what = (f"adamw {ADAMW_CELL}'s {n} leaves ({weights} weights, "
            f"{str(cfg.dtype)[6:]})")
    reset_adamw(kernel)
    for t in range(1, ADAMW_STEPS + 1):
        grads = [torch.empty_like(p).normal_(0.0, 1e-3, generator=gen)
                 for p in params]
        step = torch.tensor(t, dtype=torch.int32, device="cuda")
        lr = adamw.schedule(opt, step)
        gn = kernel.sumsq(grads)
        scale = torch.clamp(opt.clip_norm / (gn + 1e-9), max=1.0)
        bc1, bc2 = 1 - opt.b1 ** step.float(), 1 - opt.b2 ** step.float()
        kernel.update(grads, ms, vs, params, lr, scale, bc1, bc2, **hyper)
        ref.update_ref(grads, m2, v2, p2, lr, scale, bc1, bc2, opt.b1,
                       opt.b2, opt.eps, opt.weight_decay)
        torch.cuda.synchronize()
        differ = sum(not same_bits(torch, a, b)
                     for a, b in zip(params + ms + vs, p2 + m2 + v2))
        if differ:
            raise AssertionError(f"{what} step {t}: {differ} of {3 * n} "
                                 "weights and moments differ from the plain "
                                 "loop's bits")
        if float(scale) >= 1:
            raise AssertionError(f"{what} step {t}: norm {float(gn)} did not "
                                 "clip")
    launched = expect_adamw(kernel, numels, ADAMW_STEPS, what)
    del twin, p2, m2, v2
    torch.cuda.empty_cache()
    want = math.sqrt(sum(float(g.double().square().sum()) for g in grads))
    again = kernel.sumsq(grads)
    norm_err = abs(float(gn) - want) / want
    if norm_err > ADAMW_NORM_RTOL or not same_bits(torch, again, gn):
        raise AssertionError(f"{what}: norm {float(gn)!r} and again "
                             f"{float(again)!r}, f64 {want!r}: {norm_err:.3e} "
                             f"relative")
    update = lambda: kernel.update(grads, ms, vs, params, lr, scale, bc1,
                                   bc2, **hyper)
    norm_ms = host_ms(torch, lambda: kernel.sumsq(grads), reps=20, samples=3)
    update_ms = host_ms(torch, update, reps=20, samples=3)
    plain_norm_ms = once_ms(torch, lambda: ref.global_norm_ref(grads))
    plain_update_ms = once_ms(torch, lambda: ref.update_ref(
        grads, ms, vs, params, lr, scale, bc1, bc2, opt.b1, opt.b2, opt.eps,
        opt.weight_decay))
    g_bytes = sum(g.numel() * g.element_size() for g in grads)
    p_bytes = sum(p.numel() * p.element_size() for p in params)
    norm_bound = g_bytes / HBM_BYTES_S * 1e3
    update_bound = (g_bytes + 2 * p_bytes + 16 * weights) / HBM_BYTES_S * 1e3
    log(f"kernel  {what}: {ADAMW_STEPS} steps, clipped, bit for bit the "
        f"plain loop's weights and moments; launches {launched} "
        f"({adamw_per_step(numels)} a step); norm {float(gn)!r} within "
        f"{norm_err:.3e} of the f64 sum, equal in two runs; device (20 "
        f"eager calls, CUDA events): norm {norm_ms:.6f} ms (bound "
        f"{norm_bound:.6f}, {norm_bound / norm_ms:.3f} of it), update "
        f"{update_ms:.6f} ms (bound {update_bound:.6f}, "
        f"{update_bound / update_ms:.3f}), both "
        f"{norm_ms + update_ms:.6f} ms against {norm_bound + update_bound:.6f}"
        f" ({(norm_bound + update_bound) / (norm_ms + update_ms):.3f}); plain "
        f"loop: norm {plain_norm_ms:.6f} ms, update {plain_update_ms:.6f} "
        f"ms; {_peak(torch)}")
    out = dict(shape=dict(config=ADAMW_CELL, leaves=n, weights=weights,
                          dtype=str(cfg.dtype)[6:]),
               norm_rel_err=norm_err, ms=norm_ms + update_ms,
               bound_ms=norm_bound + update_bound, bound_by="bytes",
               norm_ms=norm_ms, norm_bound_ms=norm_bound,
               update_ms=update_ms, update_bound_ms=update_bound,
               plain_norm_ms=plain_norm_ms, plain_update_ms=plain_update_ms)
    del model, params, ms, vs, grads
    gc.collect()
    torch.cuda.empty_cache()
    return out


# the published Qwen1.5-MoE-A2.7B as the train-qwen1.5-moe-a2.7b cell cuts
# it: its registry entry, the overrides, the batch
MOE_TRAIN = ("qwen1.5-moe-a2.7b", dict(n_layers=12, ep_size=4, ep_rank=0),
             4, 4096)


def phase_moe_train(torch, get, registry, train, adamw, flat_params, moe,
                    gmm, gmm_dw):
    """The published MoE cut as its benchmark cell, in bf16: a warm
    ``make_train_step``, then a counted step (``moe.counting``) that must
    launch the grouped kernels 12 times a layer (3 forward, 3 in the
    remat's replay, 3 rows' and 3 weights' gradients: 144 a step), count
    one routing a layer (the replay is not counted), drop no pair and
    launch AdamW's kernels one step's worth over the cell's leaves; then a
    profiled step: the ``moe_gmm`` kernels' device time beside their
    bound, each launch 2·P·D·F at the bf16 rate with P its layer's own
    kept pairs.  Returns the kernels' launches and numbers, and AdamW's
    launches in the counted step."""
    from torch.autograd import DeviceType
    from repro_torch.kernels.adamw import kernel as adamw_kernel
    from torch.profiler import ProfilerActivity, profile
    name, over, b, s = MOE_TRAIN
    cfg = dataclasses.replace(get(name), **over)
    api = registry.build(cfg)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = init_model(torch, api, gen, "moe")
    batch = registry.make_batch(cfg, b, s, gen)
    step = train.make_train_step(api, adamw.AdamWConfig(**TRAIN_OPT))
    state = adamw.init(flat_params(api.param_tree(model)))
    start = gmm.launches + gmm_dw.launches
    model, state, met = step(model, state, batch)
    torch.cuda.synchronize()
    moe.take_counts()
    n0 = gmm.launches + gmm_dw.launches
    reset_adamw(adamw_kernel)
    t0 = time.perf_counter()
    with moe.counting():
        model, state, met = step(model, state, batch)
        torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launched = gmm.launches + gmm_dw.launches - n0
    counts = moe.take_counts()
    per = 12 * cfg.n_layers
    if launched != per:
        raise AssertionError(f"moe train step: the grouped kernels launched "
                             f"{launched} times, expected {per}")
    if len(counts) != cfg.n_layers or any(c[2] for c in counts):
        raise AssertionError(f"moe train step: counts {counts}, expected "
                             f"one a layer and no pair dropped")
    if not math.isfinite(float(met["loss"])):
        raise AssertionError("moe train step: non-finite loss")
    numels = [p.numel() for p in flat_params(api.param_tree(model))]
    opt_step = expect_adamw(adamw_kernel, numels, 1, "moe train step")
    d, f = cfg.d_model, cfg.d_ff
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model, state, met = step(model, state, batch)
        torch.cuda.synchronize()
    profiled = moe.take_counts()
    kernels = [e for e in prof.key_averages()
               if e.device_type != DeviceType.CPU and "moe_gmm_" in e.key]
    gmm_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    n_launch = sum(e.count for e in kernels)
    pairs = [c[0] for c in profiled]
    bound_ms = sum(12 * moe_gmm_bound_ms(p, d, f) for p in pairs)
    if n_launch != per or len(pairs) != cfg.n_layers or gmm_ms <= 0:
        raise AssertionError(f"moe profiled step: {n_launch} grouped "
                             f"launches, {len(pairs)} counts, {gmm_ms} ms")
    expected = b * s * cfg.top_k * (cfg.n_experts // cfg.ep_size) \
        / cfg.n_experts
    log(f"moe     {name} ({cfg.n_layers} layers, {cfg.n_experts // cfg.ep_size}"
        f" of {cfg.n_experts} experts held) train step at {b} x {s}: "
        f"{step_s:.3f} s = {b * s / step_s:.1f} tokens/s, loss "
        f"{float(met['loss']):.4f}; grouped kernels {launched} launches "
        f"a step ({launched // cfg.n_layers} a layer), AdamW {opt_step} "
        f"over {len(numels)} leaves; kept pairs a layer "
        f"{[c[0] for c in counts]} (expected {expected:.0f} on average), "
        f"largest expert {max(c[1] for c in counts)}, dropped 0; profiled "
        f"step: moe_gmm device {gmm_ms:.3f} ms in {n_launch} launches, "
        f"bound {bound_ms:.3f} ms from its layers' own pairs "
        f"{pairs}: {bound_ms / gmm_ms:.3f} of the bound; {_peak(torch)}")
    del model, state, batch
    return dict(launches=gmm.launches + gmm_dw.launches - start, step=dict(
        pairs=pairs, ms=gmm_ms, bound_ms=bound_ms, launches=n_launch),
        adamw=sum(opt_step.values()))


# K2's backward (B, H, KV, Sq, Sk, hd, causal, window, dtype, atol, rtol)
# against the plain version's autograd on the same inputs: f32 at every
# head dim with GQA and MQA, causal and full, windows, Sq != Sk both ways
# and rows that see no key (Sq 300 > Sk 100 + window 40, and at hd 256),
# held at 2e-5 as the forward's f32 cases (the two sum in other orders,
# in f32); bf16 at every head
# dim, held at 4e-2 absolute plus 2e-2 relative: dq, dk and dv are rounded
# to bf16 on both sides (one step is 2^-8 to 2^-7 of a value, 0.03125 at
# |g| 4-8), and the kernel's D = dO.o reads the forward's bf16 o where
# the plain version's autograd keeps o in f32 (the wgmma route also
# rounds P and dS to bf16 for the tensor cores); bf16 at hd 64, 128 and
# 256 takes the wgmma route: causal and full, GQA groups 1 to 4 and 10,
# ragged Sq and Sk both ways, window edges inside a tile and rows that see
# no key (at hd 256 also Sq 200 > Sk 120 + window 64); then the timed
# shapes, smollm-135m's training shape and recurrentgemma-2b's local
# attention at batch 4 and at its training cell's batch 1, which the plain
# version's [S, S] f32 gradient still fits at full size; and the shapes
# the train-whisper-medium and train-internvl2-1b steps give it, at full
# size (``FLASH_BWD_TRAIN``, checked and timed: whisper's encoder
# self-attention over 1,500 frames and its cross-attention from 4,096
# tokens into them, both full, 1,500 no multiple of a key tile; its
# decoder's causal self-attention; internvl2's causal GQA (group 7) over
# the 256-patch prefix and 4,096 tokens).
_BF16_BWD = ("bfloat16", 4e-2, 2e-2)
FLASH_BWD_TRAIN = {
    "whisper_enc": (4, 16, 16, 1500, 1500, 64, False, 0) + _BF16_BWD,
    "whisper_cross": (4, 16, 16, 4096, 1500, 64, False, 0) + _BF16_BWD,
    "whisper_dec": (4, 16, 16, 4096, 4096, 64, True, 0) + _BF16_BWD,
    "internvl": (4, 14, 2, 4352, 4352, 64, True, 0) + _BF16_BWD}
FLASH_BWD_CASES = [(2, 4, 2, 64, 64, 64, True, 0) + _F32,
                   (1, 2, 1, 100, 37, 16, False, 0) + _F32,
                   (1, 4, 1, 300, 100, 128, True, 40) + _F32,
                   (1, 2, 2, 130, 130, 256, True, 17) + _F32,
                   (1, 3, 3, 77, 77, 32, False, 9) + _F32,
                   (2, 4, 2, 77, 200, 64, False, 0) + _F32,
                   (1, 4, 2, 356, 100, 256, True, 96) + _F32,
                   (2, 9, 3, 512, 512, 64, True, 0) + _F32,
                   (2, 4, 2, 256, 256, 64, True, 0) + _BF16_BWD,
                   (1, 2, 1, 200, 120, 256, True, 64) + _BF16_BWD,
                   (1, 2, 1, 50, 80, 128, False, 0) + _BF16_BWD,
                   (1, 6, 3, 130, 130, 16, False, 0) + _BF16_BWD,
                   (1, 4, 2, 100, 100, 32, True, 0) + _BF16_BWD,
                   (1, 3, 3, 77, 77, 64, False, 0) + _BF16_BWD,
                   (2, 9, 3, 300, 300, 64, True, 0) + _BF16_BWD,
                   (1, 8, 2, 190, 333, 128, True, 0) + _BF16_BWD,
                   (1, 4, 1, 333, 190, 128, False, 0) + _BF16_BWD,
                   (1, 6, 2, 260, 260, 64, True, 100) + _BF16_BWD,
                   (1, 2, 1, 150, 200, 64, False, 50) + _BF16_BWD,
                   (1, 4, 1, 300, 100, 64, True, 40) + _BF16_BWD,
                   (1, 4, 4, 300, 100, 128, True, 40) + _BF16_BWD,
                   (1, 4, 2, 190, 333, 256, True, 0) + _BF16_BWD,
                   (1, 3, 1, 333, 190, 256, False, 0) + _BF16_BWD,
                   (2, 10, 1, 300, 300, 256, True, 100) + _BF16_BWD,
                   (1, 6, 2, 130, 130, 256, False, 33) + _BF16_BWD,
                   (1, 4, 4, 300, 100, 256, True, 40) + _BF16_BWD] \
    + list(FLASH_BWD_TRAIN.values())
# the forward's log-sum-exp (the wgmma route's input) against
# attention_lse_ref: f32 sums of ex2.approx terms in another order
LSE_TOL = (1e-4, 1e-5)
# the timed shapes, by the label their numbers take in the kernels line:
# smollm-135m's training shape, recurrentgemma-2b's local attention at
# batch 4 and at its training cell's batch 1
FLASH_BWD_TIMED = {
    "main": (4, 9, 3, 4096, 4096, 64, True, 0) + _BF16_BWD,
    "windowed": (4, 10, 1, 4096, 4096, 256, True, 2048) + _BF16_BWD,
    "windowed_train": (1, 10, 1, 4096, 4096, 256, True, 2048) + _BF16_BWD}
_TIMED_LABEL = {case: label for label, case
                in {**FLASH_BWD_TRAIN, **FLASH_BWD_TIMED}.items()}
# K3's backward (B, H, T, N, small w), f32: its checkpoint chunks of 16
# steps and their 8-step halves (1, 15, 17, 33 and 67 steps), every head
# size past two chunks (N 16 at 40 steps, N 32 at 50), decays in [0, 0.05)
# with exact zeros (small w), and rwkv6-1.6b's training shape (T 4096, the
# train cell's; T 2048 its shape before its layers were rematerialised),
# each gradient held within 1e-4 · max(1, max|g|)
# absolute, the gradient leaves' criterion of
# tests/test_torch_train_grad.py: f32 sums in other orders, and du sums
# B·T terms (8,192 at T 2048, 16,384 at T 4096; runs read 5.4e-3–6.6e-3
# and 8.5e-3–8.8e-3 there against max |du| of 3,494–3,923).
WKV_BWD_CASES = [(2, 3, 1, 16, False), (2, 3, 15, 16, False),
                 (1, 2, 17, 32, False), (2, 2, 40, 64, False),
                 (1, 1, 33, 64, False), (2, 32, 67, 64, False),
                 (2, 3, 40, 16, False), (1, 2, 50, 32, False),
                 (2, 4, 70, 64, True), (4, 32, 2048, 64, False),
                 (4, 32, 4096, 64, False)]
WKV_BWD_TOL = 1e-4


def once_ms(torch, fn, samples: int = 1) -> float:
    """The median over ``samples`` of one call's time (CUDA events), after
    one warm call: for plain versions that take seconds a call."""
    fn()
    return _event_ms(torch, fn, 1, samples)


def attention_bwd_bound(torch, b, h, kv, sq, sk, hd, causal, window,
                        itemsize):
    """(bound ms, bound by, pairs a head, flops, bytes) of K2's backward:
    five products of hd per unmasked (query, key) pair and head (S, dP,
    dV, dK, dQ: 10·hd flops) at the bf16 tensor rate (the f32 FMA rate in
    f32), against q, k, v, o, dO in and dq, dk, dv out once."""
    pairs = sum(max(0, min(i + 1 if causal else sk, sk)
                    - (max(0, i - window + 1) if window else 0))
                for i in range(sq))
    n_ops = 10 * b * h * pairs * hd
    n_bytes = itemsize * hd * (4 * b * h * sq + 4 * b * kv * sk)
    rate = BF16_TENSOR_OPS_S if itemsize == 2 else SCALAR_OPS_S
    ops_ms, bytes_ms = n_ops / rate * 1e3, n_bytes / HBM_BYTES_S * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes", pairs, n_ops,
            n_bytes)


def bwd_routes(flash_attention_bwd) -> dict:
    """K2's backward launches by route (raises unless they add up)."""
    routes = {"wgmma": flash_attention_bwd.launches_wgmma,
              "fma": flash_attention_bwd.launches_fma}
    if sum(routes.values()) != flash_attention_bwd.launches:
        raise AssertionError(f"flash_attention_bwd launches "
                             f"{flash_attention_bwd.launches} != by route "
                             f"{routes}")
    return routes


def phase_flash_bwd(torch, flash_attention, flash_attention_bwd,
                    attention_bwd_ref, attention_lse_ref, bwd_route_of):
    """K2's backward kernels against the plain version's autograd
    (``FLASH_BWD_CASES``, then the timed shapes), bit for bit on a rerun,
    each call counted on its route; on the wgmma route the forward's
    log-sum-exp against its plain version; times: the kernels (a CUDA
    graph of calls, and an eager call), the plain version, and SDPA's
    backward (its forward + backward minus its forward) as the library
    yardstick.  Returns the numbers of the timed shapes."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(14)
    torch.cuda.reset_peak_memory_stats()
    max_err, timed = 0.0, {}
    for case in FLASH_BWD_CASES + list(FLASH_BWD_TIMED.values()):
        b, h, kv, sq, sk, hd, causal, window, dt, atol, rtol = case
        dtype = getattr(torch, dt)
        q, do = (torch.randn((b, h, sq, hd), generator=gen, device="cuda")
                 .to(dtype) for _ in range(2))
        k, v = (torch.randn((b, kv, sk, hd), generator=gen, device="cuda")
                .to(dtype) for _ in range(2))
        kw = dict(causal=causal, window=window)
        route = bwd_route_of(dtype, hd, window)
        lse = None
        if route == "wgmma":
            lse = torch.empty((b, h, sq), dtype=torch.float32,
                              device="cuda")
        o = flash_attention(q, k, v, lse=lse, **kw)
        n0 = bwd_routes(flash_attention_bwd)
        got = flash_attention_bwd(q, k, v, o, do, lse=lse, **kw)
        again = flash_attention_bwd(q, k, v, o, do, lse=lse, **kw)
        want = attention_bwd_ref(q, k, v, do, **kw)
        torch.cuda.synchronize()
        n1 = bwd_routes(flash_attention_bwd)
        if n1 != {r: n0[r] + 2 * (r == route) for r in n0}:
            raise AssertionError(f"flash_attention_bwd launches by route "
                                 f"{n0} -> {n1}, expected two on {route}")
        what = (f"flash_attention_bwd B={b} H={h} KV={kv} Sq={sq} Sk={sk} "
                f"hd={hd} causal={causal} window={window} {dt} ({route} "
                "route)")
        errs = [_check_close(torch, g, w, atol, rtol, f"{what} {n}")
                for n, g, w in zip(("dq", "dk", "dv"), got, want)]
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"{what}: a rerun changed the bits")
        lse_note = ""
        if lse is not None:
            lse_err = _check_close(torch, lse, attention_lse_ref(q, k, **kw),
                                   *LSE_TOL, f"{what} lse")
            lse_note = (f"; the forward's lse within {lse_err} of "
                        f"attention_lse_ref (atol {LSE_TOL[0]} rtol "
                        f"{LSE_TOL[1]})")
        max_err = max(max_err, *errs)
        log(f"kernel  {what}: max abs error dq {errs[0]} dk {errs[1]} dv "
            f"{errs[2]} (atol {atol} rtol {rtol}; max |dq|,|dk|,|dv| "
            + ", ".join(f"{float(w.float().abs().max()):.4g}" for w in want)
            + f"); a rerun gives the same bits{lse_note}")
        del got, again, want
        label = _TIMED_LABEL.get(case)
        if label is None:
            continue
        grads = tuple(torch.empty_like(t) for t in (q, k, v))
        kernel = lambda: flash_attention_bwd(q, k, v, o, do, grads=grads,
                                             lse=lse, **kw)
        ms = device_ms(torch, kernel, reps=5, samples=3)
        call_ms = host_ms(torch, kernel, reps=5, samples=3)
        plain_ms = once_ms(torch, lambda: attention_bwd_ref(q, k, v, do,
                                                            **kw))
        # SDPA's backward: forward + backward minus forward, eager
        mask = None
        if window:
            idx = torch.arange(sq, device="cuda")
            mask = ((idx[:, None] >= idx[None, :])
                    & (idx[:, None] - idx[None, :] < window))
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        sdpa = lambda: F.scaled_dot_product_attention(
            *leaves, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=True)
        # SDPA computes the same function (its backward rounds P and dS to
        # bf16 for the tensor cores): a sanity check at twice the bf16
        # tolerance before timing it
        lib_grads = torch.autograd.grad(sdpa(), leaves, do)
        kernel()
        lib_err = max(_check_close(torch, g, w, 2 * atol, 2 * rtol,
                                   f"SDPA's {n} vs {what}")
                      for n, g, w in zip(("dq", "dk", "dv"), lib_grads,
                                         grads))
        fwd_ms = host_ms(torch, sdpa, reps=5, samples=3)
        both_ms = host_ms(torch, lambda: torch.autograd.grad(
            sdpa(), leaves, do), reps=5, samples=3)
        lib_ms = both_ms - fwd_ms
        bound_ms, bound_by, pairs, n_ops, n_bytes = attention_bwd_bound(
            torch, b, h, kv, sq, sk, hd, causal, window, q.element_size())
        if window and ms >= lib_ms:
            raise AssertionError(f"{what}: {ms:.6f} ms, slower than SDPA's "
                                 f"backward with the mask, {lib_ms:.6f} ms")
        log(f"kernel  {what} timed: device {ms:.6f} ms (CUDA graph of 5 "
            f"calls; three CUDA kernels a call); per eager call "
            f"{call_ms:.6f} ms; plain version (autograd of attention_ref) "
            f"{plain_ms:.6f} ms; SDPA backward {lib_ms:.6f} ms (forward + "
            f"backward {both_ms:.6f} minus forward {fwd_ms:.6f}, eager; its "
            f"gradients within {lib_err} of the kernel's); "
            f"bound {bound_ms:.6f} ms ({pairs} pairs a head, {n_ops} flops, "
            f"{n_bytes} bytes; {bound_by}); {ms / bound_ms:.3f}x the bound, "
            f"{ms / lib_ms:.3f}x SDPA's backward; {_peak(torch)}")
        timed[label] = dict(
            shape=dict(B=b, H=h, KV=kv, S=sq, Sk=sk, hd=hd, causal=causal,
                       window=window, dtype=dt, route=route),
            max_abs_err=max(errs), ms=ms, host_ms=call_ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=lib_ms)
        del q, k, v, o, do, grads, leaves, lib_grads, mask, lse
        torch.cuda.empty_cache()
    main = timed["main"]
    main["max_abs_err"] = max_err
    main["windowed"] = timed["windowed"]
    # the shapes the train-recurrentgemma-2b, train-whisper-medium and
    # train-internvl2-1b steps give the kernel
    main["windowed_train"] = timed["windowed_train"]
    main["whisper_train"] = [timed[k] for k in ("whisper_enc",
                                                "whisper_cross",
                                                "whisper_dec")]
    main["internvl_train"] = timed["internvl"]
    return main


def wkv_bwd_inputs(torch, gen, b, h, t, n, small_w):
    """r, k, v, dO normal, u normal, w in [0.45, 0.95) or, with
    ``small_w``, in [0, 0.05) with a tenth of it exactly 0; f32 on the
    card."""
    r, k, v, do = (torch.randn((b, h, t, n), generator=gen, device="cuda")
                   for _ in range(4))
    w = torch.rand((b, h, t, n), generator=gen, device="cuda")
    if small_w:
        w *= 0.05
        w[torch.rand(w.shape, generator=gen, device="cuda") < 0.1] = 0.0
    else:
        w = w * 0.5 + 0.45
    u = torch.randn((h, n), generator=gen, device="cuda")
    return r, k, v, w, u, do


def phase_wkv_bwd(torch, wkv6_bwd, wkv6_bwd_ref, logs):
    """K3's backward kernel against the plain version's autograd
    (``WKV_BWD_CASES``), bit for bit on a rerun; the training shape timed
    (a CUDA graph of calls, and an eager call) beside the plain version
    and the bound, with its kernels a call, its transient scratch and
    ptxas's registers, spills and shared memory (``logs``: the build's
    ptxas output).  Returns its numbers."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.rwkv_scan.kernel import wkv6_bwd_occupancy
    gen = torch.Generator(device="cuda").manual_seed(15)
    torch.cuda.reset_peak_memory_stats()
    max_err = 0.0
    for b, h, t, n, small_w in WKV_BWD_CASES:
        r, k, v, w, u, do = wkv_bwd_inputs(torch, gen, b, h, t, n, small_w)
        n0 = wkv6_bwd.launches
        got = wkv6_bwd(r, k, v, w, u, do)
        again = wkv6_bwd(r, k, v, w, u, do)
        t0 = time.perf_counter()
        want = wkv6_bwd_ref(r, k, v, w, u, do)
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
        if wkv6_bwd.launches != n0 + 2:
            raise AssertionError("wkv6_bwd did not count its launches")
        what = (f"wkv6_bwd B={b} H={h} T={t} N={n} f32"
                + (" w in [0, 0.05) with zeros" if small_w else ""))
        errs = [_check_close(torch, g, x, WKV_BWD_TOL * max(
            1.0, float(x.abs().max())), 0.0, f"{what} {name}")
                for name, g, x in zip(("dr", "dk", "dv", "dw", "du"), got,
                                      want)]
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"{what}: a rerun changed the bits")
        max_err = max(max_err, *errs)
        log(f"kernel  {what}: max abs error dr/dk/dv/dw/du "
            + " ".join(f"{e:.3g}" for e in errs) + f" (within {WKV_BWD_TOL} "
            "x max(1, max |g|); "
            "max |g| " + " ".join(f"{float(x.abs().max()):.4g}"
                                  for x in want)
            + f"); a rerun gives the same bits; plain version {ref_s:.3f} s")
        del got, again, want
    name = "wkv6_bwd"
    for ln in logs.get("wkv6_bwd", "").splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", ln)
        if entry:
            name = entry.group(1)
        elif "registers" in ln or "spill" in ln:
            log(f"kernel  wkv6_bwd ptxas {name}: {ln.strip()}")
    log("kernel  wkv6_bwd occupancy by head size (dynamic shared memory a "
        "CTA, CTAs an SM): "
        + str({hn: wkv6_bwd_occupancy(hn) for hn in (16, 32, 64)}))
    grads = tuple(torch.empty_like(r) for _ in range(4))
    kernel = lambda: wkv6_bwd(r, k, v, w, u, do, grads=grads)
    kernel()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernel()
    torch.cuda.synchronize()
    scratch = torch.cuda.max_memory_allocated() - base
    # a warm-up step first (a profile without one missed a launch of five);
    # the five active steps' averages are read when they end
    averages = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=torch.profiler.schedule(wait=0, warmup=1, active=5,
                                                  repeat=1),
                 on_trace_ready=lambda p: averages.append(
                     p.key_averages())) as prof:
        for _ in range(6):
            kernel()
            torch.cuda.synchronize()
            prof.step()
    by_name = {e.key: e.count / 5 for e in averages[0]
               if e.device_type == DeviceType.CUDA
               and not e.key.startswith(("Memcpy", "Memset"))}
    names = [key for key in by_name if "wkv6_bwd" in key]
    ours = sum(by_name[key] for key in names)
    if len(names) != 1 or ours > 1:
        raise AssertionError(f"wkv6_bwd launched {ours} CUDA kernels of "
                             f"its own a call, not 1: {by_name}")
    ms = device_ms(torch, kernel, reps=10, samples=3)
    call_ms = host_ms(torch, kernel, reps=10, samples=3)
    plain_ms = ref_s * 1e3      # the last case's, the training shape's
    # the work: r, k, v, w, dO in and dr, dk, dv, dw out once (and u, du);
    # about 12·N² flops a token and head at the f32 FMA rate
    n_bytes = 9 * b * h * t * n * 4 + 2 * h * n * 4
    n_ops = 12 * n * n * b * h * t
    bytes_ms, ops_ms = n_bytes / HBM_BYTES_S * 1e3, n_ops / SCALAR_OPS_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    log(f"kernel  wkv6_bwd B={b} H={h} T={t} N={n} f32 timed: device "
        f"{ms:.6f} ms (CUDA graph of 10 calls; one CUDA kernel a call); "
        f"per eager call {call_ms:.6f} ms; plain version (autograd of "
        f"wkv6_ref) {plain_ms:.6f} ms, one call; bound {bound_ms:.6f} ms "
        f"({n_bytes} bytes {bytes_ms:.6f} ms, {n_ops} flops at f32 peak "
        f"{ops_ms:.6f} ms); {ms / bound_ms:.3f}x the bound; {_peak(torch)}")
    log(f"kernel  wkv6_bwd a call: {ours:g} CUDA kernel of its own "
        f"(torch.profiler; besides it {sum(by_name.values()) - ours:g} "
        f"PyTorch kernels of du's batch sum); transient scratch {scratch} "
        f"bytes (max_memory_allocated over a call, the outputs given)")
    return dict(max_abs_err=max_err, ms=ms, host_ms=call_ms,
                plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                library_ms=None, scratch_bytes=scratch)


# lm-parity's reduced models; recurrentgemma with 5 layers (reduced it has
# 2, so no super-block and no attention): one super-block, two tail blocks
LM_PARITY = {"smollm-135m": {}, "granite-3-8b": {}, "rwkv6-1.6b": {},
             "qwen2-moe-a2.7b": {}, "llama4-scout-17b-a16e": {},
             "internvl2-1b": {}, "whisper-medium": {},
             "recurrentgemma-2b": {"n_layers": 5}}


def phase_lm_parity(torch, get_reduced, registry, kernels):
    """Reduced f32 models of every family: the card (kernels) against the
    CPU (plain versions) on the same weights, within 1e-4."""
    torch.cuda.reset_peak_memory_stats()
    for name, over in LM_PARITY.items():
        cfg = dataclasses.replace(get_reduced(name), **over)
        cpu = registry.build(cfg, device="cpu")
        gpu = registry.build(cfg, device="cuda")
        model = cpu.init(torch.Generator().manual_seed(0))
        model_gpu = copy.deepcopy(model).to("cuda")
        batch = registry.make_batch(cfg, 2, 40,
                                    torch.Generator().manual_seed(1), "cpu")
        batch_gpu = {k: t.cuda() for k, t in batch.items()}
        for kern in kernels:
            kern.launches = 0
        pairs = [("forward", gpu.forward(model_gpu, batch_gpu),
                  cpu.forward(model, batch))]
        steps = batch["tokens"][:, 32:36]
        if cpu.prefill is not None:
            # the reference's prefill takes the tokens alone
            lg, st_g = gpu.prefill(
                model_gpu, {"tokens": batch_gpu["tokens"][:, :32]}, 48)
            lc, st_c = cpu.prefill(model, {"tokens": batch["tokens"][:, :32]},
                                   48)
        else:
            st_g = gpu.decode_init(model_gpu, batch_gpu, 48)
            st_c = cpu.decode_init(model, batch, 48)
            for i in range(32):
                lg, st_g = gpu.decode_step(model_gpu, st_g,
                                           batch_gpu["tokens"][:, i])
                lc, st_c = cpu.decode_step(model, st_c, batch["tokens"][:, i])
        pairs.append(("prefill" if cpu.prefill is not None else
                      "decode to 32", lg, lc))
        for i in range(steps.shape[1]):
            lg, st_g = gpu.decode_step(model_gpu, st_g, steps[:, i].cuda())
            lc, st_c = cpu.decode_step(model, st_c, steps[:, i])
            pairs.append((f"decode {i}", lg, lc))
        torch.cuda.synchronize()
        launches = {k.__name__: k.launches for k in kernels}
        errs = {what: _check_close(torch, g.cpu(), c, 1e-4, 1e-4,
                                   f"lm-parity {name} {what}")
                for what, g, c in pairs}
        if not any(launches.values()):
            raise AssertionError(f"lm-parity {name}: no kernel launched")
        log(f"lm-parity {name} (reduced{', ' if over else ''}"
            f"{', '.join(f'{k} {v}' for k, v in over.items())}, f32): GPU "
            f"== CPU within 1e-4; max abs errors {errs}; kernel launches "
            f"{launches}")
    log(f"lm-parity {_peak(torch)}")


TRAIN_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=4)


def backward_launches(fa_bwd, wkv_bwd) -> dict:
    return {"flash_attention_bwd": fa_bwd.launches,
            "wkv6_bwd": wkv_bwd.launches}


def reset_backward(fa_bwd, wkv_bwd) -> None:
    fa_bwd.launches = fa_bwd.launches_wgmma = fa_bwd.launches_fma = 0
    wkv_bwd.launches = 0


def phase_lm_parity_train(torch, get_reduced, registry, train, adamw,
                          flat_params, fa_bwd, wkv_bwd):
    """One ``make_train_step`` of a reduced f32 model of every family
    (``LM_PARITY``) on the card (the backward kernels) and on the CPU (the
    plain versions' autograd) from the same weights and batch: the loss,
    the grad norm and every parameter after the AdamW update within 1e-4;
    K2's backward launched in every family with attention (f32: its
    ``fma`` route), K3's in rwkv6; the loss kernel once a family on the
    card, and AdamW's kernels one step's worth (the CPU takes the plain
    loop).  Returns the backward launches, K2's backward launches by
    route, the loss kernel's launches and AdamW's."""
    from repro_torch.kernels.adamw import kernel as adamw_kernel
    from repro_torch.kernels.head_loss.kernel import loss_rows
    torch.cuda.reset_peak_memory_stats()
    head0 = loss_rows.launches
    opt_launches = 0
    opt = adamw.AdamWConfig(**TRAIN_OPT)
    reset_backward(fa_bwd, wkv_bwd)
    for name, over in LM_PARITY.items():
        cfg = dataclasses.replace(get_reduced(name), **over)
        cpu = registry.build(cfg, device="cpu")
        gpu = registry.build(cfg, device="cuda")
        model = cpu.init(torch.Generator().manual_seed(0))
        model_gpu = copy.deepcopy(model).to("cuda")
        batch = registry.make_batch(cfg, 2, 40,
                                    torch.Generator().manual_seed(1), "cpu")
        batch_gpu = {k: t.cuda() for k, t in batch.items()}
        before = backward_launches(fa_bwd, wkv_bwd)
        head = loss_rows.launches
        reset_adamw(adamw_kernel)
        out = {}
        for dev, api, m, bt in (("cuda", gpu, model_gpu, batch_gpu),
                                ("cpu", cpu, model, batch)):
            params = flat_params(api.param_tree(m))
            _, st, metrics = train.make_train_step(api, opt)(
                m, adamw.init(params), bt)
            out[dev] = (metrics, params, st)
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in
                    backward_launches(fa_bwd, wkv_bwd).items()}
        want = "wkv6_bwd" if cfg.family == "ssm" else "flash_attention_bwd"
        if not launched[want] or sum(launched.values()) != launched[want]:
            raise AssertionError(f"lm-parity-train {name}: backward "
                                 f"launches {launched}, expected "
                                 f"{want} only")
        launched["head_loss"] = loss_rows.launches - head
        if launched["head_loss"] != 1:
            raise AssertionError(f"lm-parity-train {name}: the loss kernel "
                                 f"launched {launched['head_loss']} times "
                                 "on the card, expected 1")
        (mg, pg, sg), (mc, pc, sc) = out["cuda"], out["cpu"]
        launched["adamw"] = expect_adamw(
            adamw_kernel, [p.numel() for p in pg], 1,
            f"lm-parity-train {name}")
        opt_launches += sum(launched["adamw"].values())
        errs = {k: _check_close(torch, mg[k].cpu(), mc[k], 1e-4, 1e-4,
                                f"lm-parity-train {name} {k}")
                for k in ("loss", "grad_norm", "lr")}
        errs["params"] = max(
            _check_close(torch, g.detach().cpu(), c.detach(), 1e-4, 1e-4,
                         f"lm-parity-train {name} parameter {i}")
            for i, (g, c) in enumerate(zip(pg, pc)))
        errs["moments"] = max(
            _check_close(torch, g.cpu(), c, 1e-4, 1e-4,
                         f"lm-parity-train {name} moment")
            for g, c in zip(sg.m + sg.v, sc.m + sc.v))
        log(f"lm-parity-train {name} (reduced{', ' if over else ''}"
            f"{', '.join(f'{k} {v}' for k, v in over.items())}, f32): one "
            f"make_train_step on the card == the CPU's within 1e-4 (loss "
            f"{float(mc['loss']):.6f}, grad norm "
            f"{float(mc['grad_norm']):.6f}, {len(pc)} parameters and their "
            f"moments after the update); max abs errors {errs}; backward "
            f"launches {launched}")
    log(f"lm-parity-train {_peak(torch)}")
    routes = bwd_routes(fa_bwd)
    if routes["wgmma"]:
        raise AssertionError(f"lm-parity-train (f32): K2's backward "
                             f"launches by route {routes}, expected fma only")
    return (backward_launches(fa_bwd, wkv_bwd), routes,
            loss_rows.launches - head0, opt_launches)


# the training cells at full width: (tag, config, batch, seq, the backward
# kernel of the path, its launches a step, whether the cell saves,
# restores and resumes a checkpoint); 4 x 4096 is the LM cells' train_4k
# reduction (launch/shapes.py:29), which every family's rematerialised
# layers fit (rwkv6 peaked at 72.53 GB at 4 x 2048 before its layers
# were); recurrentgemma at batch 1, the size it was given while its loss
# still made f32 copies of the [8192, 256000] logits (at batch 2 they, its
# 2.7 B weights, their f32 moments and the unrematerialised tail blocks
# peaked near the card's 80 GB: scripts/train_cell.py); the fused loss
# keeps one bf16 buffer of the loss rows' logits instead, and the batch
# stays as the cell was (PERF.md, open questions);
# whisper's batch also carries 1,500 frames a row
# and internvl2's a 256-patch prefix.  The checkpoint's save, restore and
# resume run in the first two cells, which show them bit for bit; not in
# the others (recurrentgemma's bf16 weights and f32 moments are ~27 GB:
# some 3 minutes at the rwkv6 cell's rate)
TRAIN_CELLS = [("smollm", "smollm-135m", 4, 4096, "flash_attention_bwd", 30,
                True),
               ("rwkv6", "rwkv6-1.6b", 4, 4096, "wkv6_bwd", 24, True),
               ("recurrentgemma", "recurrentgemma-2b", 1, 4096,
                "flash_attention_bwd", 8, False),
               ("whisper", "whisper-medium", 4, 4096, "flash_attention_bwd",
                72, False),
               ("internvl", "internvl2-1b", 4, 4096, "flash_attention_bwd",
                24, False)]


def same_bits(torch, a, b) -> bool:
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    view = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    if a.is_floating_point():
        a, b = (x.view(view[x.element_size()]) for x in (a, b))
    return torch.equal(a.to(b.device), b)


def restored_equals_live(torch, api, model, opt_state, restored):
    """Every leaf of a restored checkpoint equals the live weights,
    moments and step bit for bit (a stacked leaf layer by layer); returns
    the leaves compared."""
    from repro_torch.checkpoint.manager import tree_flatten
    from repro_torch.models.common import Layers, flat_params
    tree = api.param_tree(model)
    params = flat_params(tree)
    leaves, _ = tree_flatten(tree)
    params_r, st = restored
    n = 0
    for values, loaded in ((None, params_r), (opt_state.m, st.m),
                           (opt_state.v, st.v)):
        of = None if values is None else dict(zip(map(id, params), values))
        for x, a in zip(leaves, tree_flatten(loaded)[0]):
            parts = x.parts if isinstance(x, Layers) else [x]
            for i, p in enumerate(parts):
                live = (p if of is None else of[id(p)]).detach()
                arr = a[i] if isinstance(x, Layers) else a
                if not same_bits(torch, arr, live.cpu()):
                    raise AssertionError("a restored checkpoint leaf "
                                         "differs from the live state")
            n += 1
    if int(np.asarray(st.step)) != int(opt_state.step):
        raise AssertionError("the restored step differs")
    return n + 1


def profile_train_step(torch, step_fn, model, opt_state, batch, tag: str):
    """One train step under ``torch.profiler``: the device's busy time
    against the host's wall clock, the top kernels by device time; returns
    (model, opt_state, metrics, idle share)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model, opt_state, metrics = step_fn(model, opt_state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type != DeviceType.CPU]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    idle = 1 - busy_ms / wall_ms
    log(f"{tag:<7} train step (profiled): wall {wall_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms, idle share {idle:.3f}; top kernels by device "
        "time: " + "; ".join(
            f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f} ms "
            f"({e.count}x)" for e in top))
    return model, opt_state, metrics, idle


def phase_train(torch, get, registry, train, adamw, data, fa, fa_bwd, wkv,
                wkv_bwd, cell):
    """A training cell at full width: ``launch/train.py::run`` for 4 steps
    (1 warm, 3 timed) with a checkpoint at step 4 (bf16 weights, f32
    moments, in the system temp directory, removed at the end); the
    forward and backward kernels' launches a step (the forward's twice the
    backward's: every family's layers are rematerialised); tokens/s and
    the peak memory; the
    restored checkpoint == the live state bit for bit; a fifth step,
    profiled; then ``run`` resumed from the checkpoint, whose step must
    give the fifth step's loss.  The loss kernel launches once a step, in
    the run and in the profiled step, and AdamW's kernels one step's worth
    a step (``adamw_per_step``: one update launch and two of the norm up
    to 640 leaves).  A cell whose last field is False saves no checkpoint
    and skips the restore and the resume.  Returns the run's kernel
    launches by kernel (``adamw``: the three AdamW kernels', the profiled
    step's included) and its losses and grad norms a step."""
    import tempfile
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.kernels.adamw import kernel as adamw_kernel
    from repro_torch.kernels.head_loss.kernel import loss_rows
    from repro_torch.models.common import flat_params
    tag, name, b, s, bwd_name, per_step, ckpt = cell
    cfg = get(name)
    # each layer (Griffin: each super-block) is rematerialised, as the
    # reference's jax.checkpoint: its forward kernel runs again in the
    # backward
    fwd_per_step = 2 * per_step
    api = registry.build(cfg)
    opt = adamw.AdamWConfig(**TRAIN_OPT)
    steps = TRAIN_OPT["total_steps"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix=f"train_{tag}_") as ckdir:
        tc = train.TrainConfig(steps=steps, log_every=1,
                               ckpt_every=steps if ckpt else 0, keep=2,
                               ckpt_dir=ckdir, opt=opt)
        log(f"{tag:<7} {name}: {cfg.n_layers} layers, d {cfg.d_model}, "
            f"vocab {cfg.vocab}, {str(cfg.dtype)[6:]}; run() over {steps} "
            f"steps at {b} x {s} tokens, AdamW {TRAIN_OPT}; "
            + (f"checkpoint directory {ckdir}: "
               f"{shutil.disk_usage(ckdir).free / 1e9:.1f} GB free on its "
               "disk" if ckpt else "no checkpoint")
            + "; each " + ("super-block" if cfg.family == "hybrid" else
                           "layer") + " rematerialised")
        reset_flash(fa)
        reset_backward(fa_bwd, wkv_bwd)
        wkv.launches = 0
        loss_rows.launches = 0
        reset_adamw(adamw_kernel)
        t0 = time.perf_counter()
        out = train.run(api, tc, batch_size=b, seq=s, seed=0)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = {"flash_attention": fa.launches,
                    "flash_attention_bwd": fa_bwd.launches,
                    "wkv6": wkv.launches, "wkv6_bwd": wkv_bwd.launches,
                    "head_loss": loss_rows.launches}
        fwd_name = bwd_name[:-4]
        # the loss kernel once a step in every family
        want = {k: steps * (fwd_per_step if k == fwd_name else
                            per_step if k == bwd_name else
                            1 if k == "head_loss" else 0)
                for k in launches}
        if launches != want:
            raise AssertionError(f"{tag} train: kernel launches {launches}, "
                                 f"expected {want}")
        numels = [p.numel() for p in flat_params(api.param_tree(
            out["params"]))]
        opt_run = expect_adamw(adamw_kernel, numels, steps, f"{tag} train")
        launches["adamw"] = sum(opt_run.values())
        if fwd_name == "flash_attention":
            expect_routes(fa, {"wgmma": steps * fwd_per_step, "fma": 0},
                          f"{tag} train")
            # every backward launch on the tensor cores
            bwd = bwd_routes(fa_bwd)
            if bwd != {"wgmma": steps * per_step, "fma": 0}:
                raise AssertionError(f"{tag} train: flash_attention_bwd "
                                     f"launches by route {bwd}, expected "
                                     f"{steps * per_step} on wgmma")
        losses, secs = out["losses"], out["step_seconds"]
        curve = dict(losses=losses, grad_norms=out["grad_norms"])
        if len(losses) != steps or not all(map(math.isfinite, losses)):
            raise AssertionError(f"{tag} train: losses {losses}")
        timed_s = sum(secs[1:])
        log(f"{tag:<7} train {steps} steps in {run_s:.3f} s (run()"
            + (", the checkpoint's save included" if ckpt else "")
            + "): steps "
            + ", ".join(f"{x:.3f}" for x in secs) + f" s; "
            f"{b * s * (steps - 1) / timed_s:.1f} tokens/s over the last "
            f"{steps - 1}; losses " + ", ".join(f"{x:.6f}" for x in losses)
            + f"; launches a step {fwd_name} {launches[fwd_name] // steps}, "
            f"{bwd_name} {launches[bwd_name] // steps}, head_loss "
            f"{launches['head_loss'] // steps}, AdamW "
            f"{ {k: v // steps for k, v in opt_run.items()} } over "
            f"{len(numels)} leaves"
            + (f" (by route {bwd_routes(fa_bwd)} in the run)"
               if bwd_name == "flash_attention_bwd" else "")
            + f"; max_memory_allocated {peak}")
        model, opt_state = out["params"], out["opt_state"]
        del out
        if ckpt:
            # the checkpoint at the last step == the live state, bit for
            # bit
            mgr = CheckpointManager(ckdir)
            t0 = time.perf_counter()
            restored = mgr.restore(train.checkpoint_template(api, model),
                                   steps)
            restore_s = time.perf_counter() - t0
            n_leaves = restored_equals_live(torch, api, model, opt_state,
                                            restored)
            step_dir = os.path.join(ckdir, f"step_{steps:08d}")
            ck_bytes = sum(os.path.getsize(os.path.join(step_dir, f))
                           for f in os.listdir(step_dir))
            del restored
            log(f"{tag:<7} checkpoint step {steps}: {ck_bytes} bytes, "
                f"restored to the host in {restore_s:.3f} s; all {n_leaves} "
                "leaves (bf16 weights, f32 moments, the step) equal the live "
                "state bit for bit")
        # the uninterrupted run's next step, profiled
        batch = {k: torch.as_tensor(v).cuda() for k, v in next(
            data.synthetic_batches(cfg, b, s, seed=0, skip=steps)).items()}
        reset_flash(fa)
        reset_backward(fa_bwd, wkv_bwd)
        wkv.launches = 0
        loss_rows.launches = 0
        reset_adamw(adamw_kernel)
        model, opt_state, metrics, idle = profile_train_step(
            torch, train.make_train_step(api, opt), model, opt_state, batch,
            tag)
        next_loss = float(metrics["loss"])
        if loss_rows.launches != 1:
            raise AssertionError(f"{tag} train: the profiled step launched "
                                 f"the loss kernel {loss_rows.launches} "
                                 "times, expected 1")
        launches["adamw"] += sum(expect_adamw(
            adamw_kernel, numels, 1, f"{tag} profiled train step").values())
        del model, opt_state, metrics, batch
        gc.collect()
        torch.cuda.empty_cache()
        if not math.isfinite(next_loss):
            raise AssertionError(f"{tag} train: step {steps + 1} loss "
                                 f"{next_loss}")
        if not ckpt:
            return launches, curve
        # resume from the checkpoint: run() restores it and takes step 5 on
        # the same batch
        out = train.run(api, dataclasses.replace(tc, steps=steps + 1),
                        batch_size=b, seq=s, seed=0,
                        data_iter=data.synthetic_batches(cfg, b, s, seed=0,
                                                         skip=steps))
        resumed = out["losses"]
        del out
        gc.collect()
        torch.cuda.empty_cache()
    if len(resumed) != 1:
        raise AssertionError(f"{tag} resume: ran {len(resumed)} steps")
    diff = abs(resumed[0] - next_loss)
    log(f"{tag:<7} resumed from step {steps}: loss {resumed[0]!r}, the "
        f"uninterrupted run's step {steps + 1} {next_loss!r}: "
        + ("equal" if diff == 0 else
           f"differ by {diff} (the restored state is bit for bit the "
           "saved one, so the forward differs between the two processes' "
           "runs)"))
    return launches, curve


# --------------------------------------------------------------------------
# train-smollm-135m-sharded: the training step over a mesh of gloo ranks
# --------------------------------------------------------------------------

#: the cell's mesh (data 2, model 2: four gloo ranks on the one card),
#: its batch (train-smollm-135m's 4 x 4096), steps before and after the
#: drop of 2 ranks, and the reduced f32 check's batch
SHARDED_TRAIN_MESH = (2, 2)
SHARDED_TRAIN_STEPS = 3
SHARDED_TRAIN_DROP = 2
SHARDED_TRAIN_REDUCED = (4, 64)
#: bf16 tolerances of the sharded steps against train-smollm-135m's, each
#: relative to the single-device value (u = 2^-8, bf16's unit roundoff).
#: The two runs differ only in the order of sums and in where values round
#: to bf16: a weight gradient reduced over 16,384 tokens and rounded once,
#: against four ranks' reductions over 4,096 each rounded once and summed
#: in f32.  The loss (an f32 mean) sees at step 1 the same weights and the
#: forward's sums in another order, u at most, and at the later steps
#: weights that AdamW's normalised update moved by at most 2 lr apart,
#: another u: 2u.  The grad norm also carries the embedding gather's
#: gradient, which PyTorch accumulates a duplicate token at a time in the
#: weight's dtype, rounding to bf16 at every addition: the batch's most
#: frequent token (1,083 of 16,384 at seed 0) carries 1,083 roundings in
#: one run, ~270 a rank in the other, an rms error of about
#: u·sqrt(n/3) of the row (0.074 at n = 1,083), shrinking over the rarer
#: rows; weighted over the gradient, 8u = 2^-5 bounds the norm's share.
#: ``embedding_grad_spread`` measures that accumulation on the card, on
#: this batch's tokens.
SHARDED_TRAIN_RTOL = dict(loss=2.0 ** -7, grad_norm=2.0 ** -5)


def train_sharded_rank(mesh, ckdir, matmul):
    """A rank of train-smollm-135m-sharded.  First a reduced f32 smollm:
    one sharded step on the card against ``make_train_step`` on the CPU
    from the same weights and batch (loss, grad norm and the gathered
    weights after the update, within 1e-4).  Then the cell at full width
    in bf16: ``run`` for ``SHARDED_TRAIN_STEPS`` steps with a checkpoint
    at the last (rank 0 saves the gathered reference tree, then restores
    it into a single-device model and holds it bit for bit against the
    gathered weights and moments), ``drop_devices`` of
    ``SHARDED_TRAIN_DROP`` ranks, the weights and both moments resharded,
    and one step on the survivors.  K2's and the loss kernel's launches
    are counted from just before the full-width run to its end, and so
    are AdamW's kernels' with the leaves of this rank's blocks they took.
    ``matmul``: the launcher's cuBLAS settings, so the ranks compute what
    it computes."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = matmul["tf32"]
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        matmul["bf16_reduced"]
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get, get_reduced
    from repro_torch.data.tokens import synthetic_batches
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention, flash_attention_bwd)
    from repro_torch.kernels.adamw import kernel as adamw_kernel
    from repro_torch.kernels.head_loss.kernel import loss_rows
    from repro_torch.launch import elastic, train
    from repro_torch.launch.mesh import Collectives
    from repro_torch.models import registry
    from repro_torch.models.common import flat_params
    from repro_torch.optim import adamw
    opt = adamw.AdamWConfig(**TRAIN_OPT)
    out = dict(rank=mesh.rank)

    # 1. reduced f32: the sharded step on the card == one CPU device
    cfg = get_reduced("smollm-135m")
    cpu, gpu = registry.build(cfg, device="cpu"), registry.build(cfg)
    model_cpu = cpu.init(torch.Generator().manual_seed(0))
    model_gpu = copy.deepcopy(model_cpu).to(mesh.device)
    b, s = SHARDED_TRAIN_REDUCED
    batch = {k: torch.from_numpy(v) for k, v in next(synthetic_batches(
        cfg, b, s, seed=1)).items()}
    step, _ = train.shard_train_fns(gpu, mesh, model_gpu, None, batch, opt)
    params, state = step.shard_params(), step.shard_opt()
    _, _, m = step(params, state, {k: v.to(mesh.device)
                                   for k, v in batch.items()})
    step.gather_params(params)
    flat = flat_params(cpu.param_tree(model_cpu))
    _, _, want = train.make_train_step(cpu, opt)(
        model_cpu, adamw.init(flat), batch)
    errs = {k: _check_close(torch, m[k].cpu(), want[k], 1e-4, 1e-4,
                            f"sharded reduced rank {mesh.rank} {k}")
            for k in ("loss", "grad_norm")}
    errs["params"] = max(
        _check_close(torch, g.detach().cpu(), c.detach(), 1e-4, 1e-4,
                     f"sharded reduced rank {mesh.rank} weight")
        for g, c in zip(flat_params(gpu.param_tree(model_gpu)), flat))
    out["reduced"] = dict(errs=errs, loss=float(want["loss"]))
    del model_cpu, model_gpu, step, params, state, m

    # 2. the cell at full width
    cfg = get("smollm-135m")
    api = registry.build(cfg)
    bsz, seq = TRAIN_CELLS[0][2], TRAIN_CELLS[0][3]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in (flash_attention, flash_attention_bwd):
        fn.launches = fn.launches_wgmma = fn.launches_fma = 0
    loss_rows.launches = 0
    reset_adamw(adamw_kernel)
    steps = SHARDED_TRAIN_STEPS
    tc = train.TrainConfig(steps=steps, log_every=1, ckpt_every=steps,
                           ckpt_dir=ckdir, keep=1, opt=opt)
    run = train.run(api, tc, mesh=mesh, batch_size=bsz, seq=seq, seed=0)
    torch.cuda.synchronize()
    out.update(losses=run["losses"], grad_norms=run["grad_norms"],
               step_s=run["step_seconds"], coll=run["collective_seconds"])
    model, params, state = run["params"], run["shards"], run["opt_state"]
    del run
    # the update's leaves: this rank's blocks (the same count on the
    # survivors' mesh)
    opt_numels = [x.numel() for x in params.blocks]
    # the checkpoint == the gathered state, bit for bit, in a single-device
    # model (rank 0; every rank gathers the moments)
    comm = Collectives(mesh)
    whole_m, whole_v = train.gather(state.m, comm), train.gather(state.v,
                                                                 comm)
    if mesh.rank == 0:
        t0 = time.perf_counter()
        one = api.init(torch.Generator(device="cuda").manual_seed(1))
        flat_one = flat_params(api.param_tree(one))
        st_one = train.load_checkpoint(
            api, one, adamw.init(flat_one), CheckpointManager(ckdir).restore(
                train.checkpoint_template(api, one), steps))
        live = flat_params(api.param_tree(model))
        pairs = list(zip(flat_one + st_one.m + st_one.v,
                         live + whole_m + whole_v))
        same = sum(same_bits(torch, a.detach(), b.detach().to(a.device))
                   for a, b in pairs)
        if same != len(pairs) or int(st_one.step) != int(state.step):
            raise AssertionError(f"sharded checkpoint: {same} of "
                                 f"{len(pairs)} tensors equal the gathered "
                                 "state")
        out["ckpt"] = dict(tensors=len(pairs), restore_s=time.perf_counter()
                           - t0, bytes=sum(
                               os.path.getsize(os.path.join(dp, f))
                               for dp, _, fs in os.walk(ckdir) for f in fs))
        del one, flat_one, st_one, pairs
    del whole_m, whole_v
    # lose the last ranks; the weights and moments move to the survivors
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new = elastic.drop_devices(mesh, SHARDED_TRAIN_DROP)
    params = elastic.reshard_params(params, new)
    state = state._replace(m=elastic.reshard_params(state.m, new),
                           v=elastic.reshard_params(state.v, new))
    torch.cuda.synchronize()
    out.update(reshard_s=time.perf_counter() - t0, new_shape=dict(new.shape),
               new_coords=new.coords)
    if new.coords is not None:
        batch = {k: torch.as_tensor(v).to(mesh.device) for k, v in next(
            synthetic_batches(cfg, bsz, seq, seed=0, skip=steps)).items()}
        step, _ = train.shard_train_fns(api, new, model, None, batch, opt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        out.update(loss4=float(m["loss"]), grad_norm4=float(m["grad_norm"]),
                   step4_s=time.perf_counter() - t0,
                   coll4=dict(step.comm.seconds), step4=int(state.step))
    torch.cuda.synchronize()
    out.update(fwd=dict(n=flash_attention.launches,
                        wgmma=flash_attention.launches_wgmma,
                        fma=flash_attention.launches_fma),
               bwd=dict(n=flash_attention_bwd.launches,
                        wgmma=flash_attention_bwd.launches_wgmma,
                        fma=flash_attention_bwd.launches_fma),
               head_loss=loss_rows.launches,
               adamw=dict(adamw_launches(adamw_kernel),
                          leaves=adamw_kernel.update.leaves,
                          copied=adamw_kernel.update.copied,
                          per_step=adamw_per_step(opt_numels),
                          block_leaves=sum(1 for n in opt_numels if n)),
               peak=torch.cuda.max_memory_allocated())
    return out


def embedding_grad_spread(torch, bsz: int, seq: int, ranks: int) -> dict:
    """The rounding of the embedding gather's gradient in bf16 on the card:
    ``embed[tokens]``'s gradient over train-smollm-135m's first batch, in
    f32, in bf16 as one pass, and in bf16 a rank's rows at a time summed
    in f32; returns the relative errors of the two against f32 (norms of
    the differences over the f32 gradient's norm), the two norms' relative
    difference, and the most frequent token's count."""
    from repro_torch.configs import get
    from repro_torch.data.tokens import synthetic_batches
    cfg = get("smollm-135m")
    tok = torch.from_numpy(next(synthetic_batches(cfg, bsz, seq, seed=0))[
        "tokens"]).long().cuda()
    up = torch.randn((bsz, seq, cfg.d_model), device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(2)
                     ) * 1e-3

    def grad(rows, dtype):
        e = torch.zeros((cfg.vocab, cfg.d_model), dtype=dtype, device="cuda",
                        requires_grad=True)
        (e[tok[rows]] * up[rows].to(dtype)).sum().backward()
        return e.grad.float()
    whole = slice(0, bsz)
    ref = grad(whole, torch.float32)
    one = grad(whole, torch.bfloat16)
    per = bsz // ranks
    parts = sum(grad(slice(i * per, (i + 1) * per), torch.bfloat16)
                for i in range(ranks))
    norm = lambda x: float(x.norm())
    return dict(one=norm(one - ref) / norm(ref),
                parts=norm(parts - ref) / norm(ref),
                norms=abs(norm(parts) - norm(one)) / norm(one),
                n_max=int(torch.bincount(tok.reshape(-1)).max()))


def f32_first_grad_norm(torch, bsz: int, seq: int) -> float:
    """Step 1's gradient norm in f32: train-smollm-135m's seed-0 bf16
    weights as f32, its first batch a row at a time (each row's loss a
    mean over its tokens, the rows' f32 gradients averaged)."""
    from repro_torch.configs import get
    from repro_torch.data.tokens import synthetic_batches
    from repro_torch.models import registry
    from repro_torch.models.common import flat_params
    from repro_torch.optim import adamw
    cfg = get("smollm-135m")
    model = registry.build(cfg).init(
        torch.Generator(device="cuda").manual_seed(0)).float()
    api = registry.build(dataclasses.replace(cfg, dtype=torch.float32))
    params = flat_params(api.param_tree(model))
    total = [torch.zeros_like(p, dtype=torch.float32) for p in params]
    batch = next(synthetic_batches(cfg, bsz, seq, seed=0))
    for r in range(bsz):
        api.loss(model, {k: torch.from_numpy(v[r:r + 1]).cuda()
                         for k, v in batch.items()}).backward()
        for t, p in zip(total, params):
            if p.grad is not None:
                t += p.grad
            p.grad = None
    return float(adamw.global_norm([t / bsz for t in total]))


def phase_train_sharded(torch, single: dict, gpu: str) -> dict:
    """train-smollm-135m-sharded: four gloo ranks on the card
    (``train_sharded_rank``).  Raises unless the reduced f32 step matched
    the CPU, every step's loss and grad norm are train-smollm-135m's
    (``single``: its run's losses and grad norms) within
    ``SHARDED_TRAIN_RTOL``, the checkpoint restored bit for bit, K2's
    forward launched 60 times a step and its backward 30 on every rank,
    all on ``wgmma``, the loss kernel once a step on every rank, and
    AdamW's kernels one step's worth a step on every rank (the update over
    the rank's blocks, every block sent, the norm over the whole
    gradient).  Returns K2's forward and backward launches, the loss
    kernel's and AdamW's over the ranks."""
    import tempfile
    from repro_torch.launch.mesh import start_mesh
    gc.collect()
    torch.cuda.empty_cache()
    data, model = SHARDED_TRAIN_MESH
    steps = SHARDED_TRAIN_STEPS
    bsz, seq = TRAIN_CELLS[0][2], TRAIN_CELLS[0][3]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="train_sharded_") as ckdir, \
            CardMemory(torch) as card:
        log(f"sharded-train smollm-135m over mesh ({data}, {model}): "
            f"{data * model} gloo ranks on one card, {bsz} x {seq} tokens a "
            f"step ({bsz // (data * model)} x {seq} a rank), AdamW "
            f"{TRAIN_OPT}; {steps} steps with a checkpoint at step {steps} "
            f"in {ckdir}, then {SHARDED_TRAIN_DROP} ranks dropped and one "
            f"step on the survivors ({gpu})")
        matmul = dict(tf32=torch.backends.cuda.matmul.allow_tf32,
                      bf16_reduced=torch.backends.cuda.matmul
                      .allow_bf16_reduced_precision_reduction)
        res = start_mesh(train_sharded_rank, data, model, backend="gloo",
                         args=(ckdir, matmul),
                         timeout=SHARDED_TIMEOUT).join()
    phase_s = time.perf_counter() - t0
    r0 = res[0]
    log(f"sharded-train reduced smollm-135m (f32, {SHARDED_TRAIN_REDUCED[0]}"
        f" x {SHARDED_TRAIN_REDUCED[1]}): one sharded step on {data * model}"
        f" ranks on the card == make_train_step on the CPU within 1e-4 (loss"
        f" {r0['reduced']['loss']:.6f}); max abs errors by rank "
        f"{[r['reduced']['errs'] for r in res]}")
    got = list(zip(r0["losses"], r0["grad_norms"])) + \
        [(r0["loss4"], r0["grad_norm4"])]
    want = list(zip(single["losses"], single["grad_norms"]))[:steps + 1]
    rel = [dict(zip(("loss", "grad_norm"), (abs(g - w) / abs(w)
                                            for g, w in zip(gs, ws))))
           for gs, ws in zip(got, want)]
    tokens = bsz * seq
    for i, ((loss, gn), (wl, wg), r) in enumerate(zip(got, want, rel)):
        if i < steps:
            secs, coll = r0["step_s"][i], r0["coll"][i]
        else:
            secs, coll = r0["step4_s"], r0["coll4"]
        log(f"sharded-train step {i + 1} on mesh "
            f"{SHARDED_TRAIN_MESH if i < steps else tuple(r0['new_shape'].values())}"
            f": loss {loss!r} (train-smollm-135m's {wl!r}), grad norm "
            f"{gn!r} ({wg!r}), relative differences {r['loss']:.3e} and "
            f"{r['grad_norm']:.3e} (tolerances {SHARDED_TRAIN_RTOL['loss']:.3e}"
            f" and {SHARDED_TRAIN_RTOL['grad_norm']:.3e}); {secs:.3f} s, "
            f"{tokens / secs:.1f} tokens/s; gather {coll['gather']:.3f} s, "
            f"gradient all-reduce {coll['all_reduce']:.3f} s (rank 0, host "
            f"clock; {gpu})")
    if any(r[k] > SHARDED_TRAIN_RTOL[k] for r in rel for k in r):
        raise AssertionError(f"sharded-train: relative differences {rel} "
                             f"beyond {SHARDED_TRAIN_RTOL}")
    gn32 = f32_first_grad_norm(torch, bsz, seq)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"sharded-train step 1's grad norm in f32 {gn32!r} (the same "
        f"weights and batch, row by row): train-smollm-135m's is "
        f"{abs(want[0][1] - gn32) / gn32:.3e} from it, the sharded run's "
        f"{abs(got[0][1] - gn32) / gn32:.3e} ({gpu})")
    spread = embedding_grad_spread(torch, bsz, seq, data * model)
    log(f"sharded-train bf16's own spread: the embedding gather's gradient "
        f"over this batch's tokens (its most frequent {spread['n_max']} of "
        f"{tokens}; a random normal upstream gradient of std 1e-3, seed 2) in bf16 "
        f"is {spread['one']:.3e} from f32 as one pass, {spread['parts']:.3e} "
        f"as {data * model} rank partials summed in f32; the two norms "
        f"differ by {spread['norms']:.3e} relative ({gpu})")
    ck = r0["ckpt"]
    log(f"sharded-train checkpoint step {steps}: {ck['bytes']} bytes saved "
        f"by rank 0; restored into a single-device model in "
        f"{ck['restore_s']:.3f} s, all {ck['tensors']} tensors (bf16 "
        f"weights, f32 moments) equal the gathered blocks bit for bit")
    log(f"sharded-train drop {SHARDED_TRAIN_DROP} ranks: mesh "
        f"{SHARDED_TRAIN_MESH} -> {tuple(r0['new_shape'].values())}, "
        f"coordinates {[r['new_coords'] for r in res]}; reshard of the "
        f"weights and both moments {max(r['reshard_s'] for r in res):.3f} s "
        f"(host clock, slowest rank; {gpu})")
    fwd, bwd, head, opt = [], [], [], []
    for r in res:
        n = steps + (r["new_coords"] is not None)
        a = r["adamw"]
        want = {k: n * v for k, v in a["per_step"].items()}
        if {k: a[k] for k in want} != want \
                or a["leaves"] != n * a["block_leaves"]:
            raise AssertionError(f"sharded-train rank {r['rank']}: AdamW "
                                 f"launches {a}, expected {want} and "
                                 f"{n * a['block_leaves']} leaves in {n} "
                                 "steps")
        opt.append(a["update"] + a["sumsq"])
        if r["head_loss"] != n:
            raise AssertionError(f"sharded-train rank {r['rank']}: the loss "
                                 f"kernel launched {r['head_loss']} times "
                                 f"in {n} steps")
        head.append(r["head_loss"])
        # the forward twice a layer: once more in the backward (remat)
        expect = {"n": 30 * n, "wgmma": 30 * n, "fma": 0}
        expect_fwd = {k: 2 * v for k, v in expect.items()}
        if r["fwd"] != expect_fwd or r["bwd"] != expect:
            raise AssertionError(f"sharded-train rank {r['rank']}: K2 "
                                 f"launches {r['fwd']}, backward "
                                 f"{r['bwd']}, expected {expect_fwd} and "
                                 f"{expect}")
        fwd.append(r["fwd"]["n"])
        bwd.append(r["bwd"]["n"])
    log(f"sharded-train K2 launches per rank: forward {fwd}, backward "
        f"{bwd} (60 and 30 a step, every one on wgmma); loss kernel {head} "
        f"(1 a step); AdamW by rank "
        f"{[{k: r['adamw'][k] for k in ('update', 'sumsq', 'copied')} for r in res]}"
        f" ({res[0]['adamw']['per_step']} a step; the copies are the "
        f"gradients of blocks that are not contiguous); max_memory_allocated "
        f"per rank {[r['peak'] for r in res]}; card peak used {card.peak} "
        f"(sampled every {card.every_s} s); phase {phase_s:.3f} s ({gpu})")
    return {"flash_attention": sum(fwd), "flash_attention_bwd": sum(bwd),
            "head_loss": sum(head), "adamw": sum(opt)}


# --------------------------------------------------------------------------
# the LM serving cells at full width
# --------------------------------------------------------------------------

def init_model(torch, api, gen, tag: str):
    """``api.init(gen)`` on the card, with a line for the config and the
    parameter count."""
    cfg = api.cfg
    t0 = time.perf_counter()
    model = api.init(gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"{tag:<7} {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}, {str(cfg.dtype)[6:]}; {n_params} "
        f"parameters ({n_bytes} bytes) initialised on the card in "
        f"{time.perf_counter() - t0:.3f} s")
    return model


def reset_flash(flash_attention) -> None:
    flash_attention.launches = 0
    flash_attention.launches_wgmma = 0
    flash_attention.launches_fma = 0


def flash_routes(flash_attention) -> dict:
    """K2's launches since the last reset, by route (raises unless the
    routes add up)."""
    routes = {"wgmma": flash_attention.launches_wgmma,
              "fma": flash_attention.launches_fma}
    if sum(routes.values()) != flash_attention.launches:
        raise AssertionError(f"flash launches {flash_attention.launches} "
                             f"!= by route {routes}")
    return routes


def expect_routes(flash_attention, want: dict, what: str) -> dict:
    """Raise unless K2 launched exactly ``want`` by route since the last
    reset."""
    routes = flash_routes(flash_attention)
    if routes != want:
        raise AssertionError(f"{what}: flash_attention launches by route "
                             f"{routes}, expected {want}")
    return routes


def eval_loss(torch, api, model, batch) -> float:
    """``api.loss`` without the autograd graph (a serving cell's check):
    the training path's loss kernel, which grad mode off has only read
    the logits; raises unless it launched once."""
    from repro_torch.kernels.head_loss.kernel import loss_rows
    n0 = loss_rows.launches
    with torch.inference_mode():
        loss = float(api.loss(model, batch))
    if loss_rows.launches != n0 + 1:
        raise AssertionError(f"eval loss: {loss_rows.launches - n0} loss "
                             "kernel launches, expected 1")
    return loss


def timed(torch, fn):
    """(fn(), seconds to its end on the device)."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def decode_run(torch, api, model, st, tok, steps: int):
    """``steps`` greedy decode steps from ``tok``: (state, next token,
    seconds); raises on a non-finite logit."""
    finite = torch.ones((), dtype=torch.bool, device="cuda")
    t0 = time.perf_counter()
    for _ in range(steps):
        logits, st = api.decode_step(model, st, tok)
        finite &= torch.isfinite(logits).all()
        tok = logits.argmax(-1)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    if not bool(finite):
        raise AssertionError(f"{api.cfg.name} decode: non-finite logits")
    return st, tok, decode_s


def profile_decode(torch, api, model, st, tok, tag: str, n: int = 4):
    """Where a decode step's time goes: the device's busy time against the
    host's wall clock over ``n`` profiled steps, and the top ops by device
    time; returns the state and the idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(n):
            logits, st = api.decode_step(model, st, tok)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3 / n
    # device busy: the kernels' own time; the top ops: device time
    # attributed to the PyTorch ops that launched it
    events = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in events
                  if e.device_type != DeviceType.CPU) / 1e3 / n
    top = sorted((e for e in events if e.device_type == DeviceType.CPU),
                 key=lambda e: -e.self_device_time_total)[:3]
    idle = 1 - busy_ms / wall_ms
    log(f"{tag:<7} decode step (profiled): wall {wall_ms:.3f} ms, device "
        f"busy {busy_ms:.3f} ms, idle share {idle:.3f}; top device time by "
        "op: " + "; ".join(f"{e.key[:40]} {e.self_device_time_total / (n * 1e3):.3f} ms"
                           for e in top))
    return st, idle


class DropCount:
    """Within the block, count on the device (no host sync) the (token,
    choice) pairs that ``moe_ffn`` routes and those its capacity drops,
    by wrapping ``moe.route``.  ``expect`` raises unless the pairs are the
    given number, so a ``moe_ffn`` that stops routing through
    ``moe.route`` cannot read as no drops."""

    def __init__(self, torch, moe):
        self.moe = moe
        self.dropped = torch.zeros((), dtype=torch.int64, device="cuda")
        self.pairs = 0

    def __enter__(self):
        route = self.route = self.moe.route

        def counted(params, xt, cfg):
            out = route(params, xt, cfg)
            self.dropped += (out[2] >= self.moe.capacity(
                cfg, xt.shape[0])).sum()
            self.pairs += out[2].numel()
            return out
        self.moe.route = counted
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route

    def share(self) -> float:
        return int(self.dropped) / max(self.pairs, 1)

    def expect(self, pairs: int, what: str) -> None:
        if self.pairs != pairs:
            raise AssertionError(f"{what}: counted {self.pairs} (token, "
                                 f"choice) pairs, expected {pairs}")


def serve_transformer(torch, api, model, batch, fa, tag: str, want: dict,
                      s_max: int = 4160, steps: int = 64) -> int:
    """The transformer serving cell: prefill of ``batch``'s tokens (K2 by
    route as ``want``), ``steps`` decode steps, one profiled step; returns
    K2's launches in the prefill by route."""
    b, s = batch["tokens"].shape
    reset_flash(fa)
    (logits, st), prefill_s = timed(torch, lambda: api.prefill(
        model, {"tokens": batch["tokens"]}, s_max))
    routes = expect_routes(fa, want, f"{tag} prefill")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{tag} prefill: non-finite logits")
    st, tok, decode_s = decode_run(torch, api, model, st, logits.argmax(-1),
                                   steps)
    if st.pos != s + steps:
        raise AssertionError(f"{tag} decode: pos {st.pos}")
    st, idle = profile_decode(torch, api, model, st, tok, tag)
    log(f"{tag:<7} prefill {b} x {s} tokens in {prefill_s:.3f} s = "
        f"{b * s / prefill_s:.1f} tokens/s; flash_attention launches "
        f"{sum(routes.values())}, by route {routes}; decode {steps} steps "
        f"at batch {b} (s_max {s_max}) in {decode_s:.3f} s = "
        f"{b * steps / decode_s:.1f} tokens/s; idle share {idle:.3f}; "
        f"logits finite; {_peak(torch)}")
    return routes


def phase_granite(torch, get, registry, flash_attention):
    cfg = get("granite-3-8b")
    api = registry.build(cfg)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = init_model(torch, api, gen, "granite")
    batch = registry.make_batch(cfg, 4, 4096, gen)
    routes = serve_transformer(torch, api, model, batch, flash_attention,
                               "granite", {"wgmma": cfg.n_layers, "fma": 0})
    # prefill + one decode step == forward at the last two positions
    toks = batch["tokens"][:1, :512]
    full = api.forward(model, {"tokens": toks})
    lp, st = api.prefill(model, {"tokens": toks[:, :511]}, 512)
    ld, _ = api.decode_step(model, st, toks[:, 511])
    ep = _check_close(torch, lp, full[:, 510], GRANITE_TOL, 0.0,
                      "granite prefill vs forward")
    ed = _check_close(torch, ld, full[:, 511], GRANITE_TOL, 0.0,
                      "granite decode vs forward")
    log(f"granite 512-token prompt: prefill vs forward max abs error {ep}, "
        f"decode_step vs forward {ed} (atol {GRANITE_TOL}; max |logit| "
        f"{float(full[:, 510:].float().abs().max())})")
    return {"granite_prefill": routes}


def phase_qwen(torch, get, registry, fa, moe):
    """qwen2-moe-a2.7b serving at its published width (bf16, seed 0):
    prefill 4 × 4096 (24 K2 launches, wgmma), 64 decode steps at batch 4;
    the share of (token, choice) pairs the prefill's capacity drops, read
    from a second, untimed prefill of the same tokens; then,
    with capacity_factor = n_experts / top_k (nothing drops), prefill +
    decode == forward over 512 tokens."""
    cfg = get("qwen2-moe-a2.7b")
    api = registry.build(cfg)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = init_model(torch, api, gen, "qwen")
    batch = registry.make_batch(cfg, 4, 4096, gen)
    routes = serve_transformer(torch, api, model, batch, fa, "qwen",
                               {"wgmma": cfg.n_layers, "fma": 0})
    with DropCount(torch, moe) as drops:
        api.prefill(model, {"tokens": batch["tokens"]}, 4096)
    drops.expect(cfg.n_layers * 4 * 4096 * cfg.top_k, "qwen prefill")
    log(f"qwen    the prefill's capacity is {moe.capacity(cfg, 4 * 4096)} "
        f"slots an expert (capacity_factor {cfg.capacity_factor}; 1 at "
        f"decode batch 4): it dropped {drops.share():.6f} of its "
        f"{drops.pairs} (token, choice) pairs")
    nodrop = registry.build(dataclasses.replace(
        cfg, capacity_factor=cfg.n_experts / cfg.top_k))
    toks = batch["tokens"][:1, :512]
    full = nodrop.forward(model, {"tokens": toks})
    lp, st = nodrop.prefill(model, {"tokens": toks[:, :511]}, 512)
    ld, _ = nodrop.decode_step(model, st, toks[:, 511])
    ep = _check_close(torch, lp, full[:, 510], QWEN_TOL, 0.0,
                      "qwen prefill vs forward")
    ed = _check_close(torch, ld, full[:, 511], QWEN_TOL, 0.0,
                      "qwen decode vs forward")
    log(f"qwen    512-token prompt, capacity_factor {cfg.n_experts / cfg.top_k}"
        f" (no drops): prefill vs forward max abs error {ep}, decode_step vs "
        f"forward {ed} (atol {QWEN_TOL}; max |logit| "
        f"{float(full[:, 510:].float().abs().max())})")
    return {"qwen_prefill": routes}


def phase_internvl(torch, get, registry, fa):
    """internvl2-1b at its published width (bf16, seed 0): forward and
    loss over 256 patches + 4096 tokens at batch 4 (K2 on wgmma at hd 64,
    GQA group 7, S 4352), then prefill 4 × 4096 and 64 decode steps."""
    cfg = get("internvl2-1b")
    api = registry.build(cfg)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = init_model(torch, api, gen, "vlm")
    batch = registry.make_batch(cfg, 4, 4096, gen)
    b, s = batch["tokens"].shape
    p = batch["patches"].shape[1]
    want = {"wgmma": cfg.n_layers, "fma": 0}
    reset_flash(fa)
    logits, fwd_s = timed(torch, lambda: api.forward(model, batch))
    fwd_routes = expect_routes(fa, want, "vlm forward")
    if logits.shape != (b, p + s, cfg.vocab) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"vlm forward: logits {tuple(logits.shape)}")
    del logits
    loss, loss_s = timed(torch, lambda: eval_loss(torch, api, model, batch))
    if not math.isfinite(loss):
        raise AssertionError(f"vlm loss {loss}")
    log(f"vlm     forward {b} x ({p} patches + {s} tokens) in {fwd_s:.3f} s "
        f"= {b * (p + s) / fwd_s:.1f} tokens/s; flash_attention launches "
        f"{sum(fwd_routes.values())}, by route {fwd_routes}; loss {loss} in "
        f"{loss_s:.3f} s; {_peak(torch)}")
    return {"internvl_forward": fwd_routes,
            "internvl_prefill": serve_transformer(torch, api, model, batch,
                                                  fa, "vlm", want)}


def phase_whisper(torch, get, registry, fa):
    """whisper-medium at its published width (bf16, seed 0): loss over
    1,500 frames + 4 × 4096 tokens (72 K2 launches: the encoder's, the
    decoder's causal and its cross-attention, all wgmma), decode_init (the
    encoder, 24) and 64 decode steps at batch 4; decode == decode_train
    on a 64-token prompt."""
    cfg = get("whisper-medium")
    api = registry.build(cfg)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = init_model(torch, api, gen, "whisper")
    batch = registry.make_batch(cfg, 4, 4096, gen)
    b, s = batch["tokens"].shape
    t = batch["frames"].shape[1]
    n_enc = cfg.n_enc_layers
    reset_flash(fa)
    loss, loss_s = timed(torch, lambda: eval_loss(torch, api, model, batch))
    loss_routes = expect_routes(fa, {"wgmma": n_enc + 2 * cfg.n_layers,
                                     "fma": 0}, "whisper loss")
    if not math.isfinite(loss):
        raise AssertionError(f"whisper loss {loss}")
    s_max, steps = 4160, 64
    reset_flash(fa)
    st, init_s = timed(torch, lambda: api.decode_init(model, batch, s_max))
    init_routes = expect_routes(fa, {"wgmma": n_enc, "fma": 0},
                                "whisper decode_init")
    st, tok, decode_s = decode_run(torch, api, model, st,
                                   batch["tokens"][:, 0], steps)
    st, idle = profile_decode(torch, api, model, st, tok, "whisper")
    log(f"whisper loss over {b} x ({t} frames + {s} tokens) {loss} in "
        f"{loss_s:.3f} s = {b * (t + s) / loss_s:.1f} tokens/s; "
        f"flash_attention launches {sum(loss_routes.values())}, by route "
        f"{loss_routes}; decode_init (encode {b} x {t} frames, cross K/V) "
        f"in {init_s:.3f} s, launches by route {init_routes}; decode "
        f"{steps} steps at batch {b} (s_max {s_max}) in {decode_s:.3f} s = "
        f"{b * steps / decode_s:.1f} tokens/s; idle share {idle:.3f}; "
        f"logits finite; {_peak(torch)}")
    prompt = {"tokens": batch["tokens"][:1, :64],
              "frames": batch["frames"][:1]}
    err, top = _check_decode(torch, api, model, prompt, WHISPER_TOL,
                             "whisper decode vs decode_train")
    log(f"whisper 64-token prompt: decode_step vs decode_train max abs "
        f"error {err} (atol {WHISPER_TOL}; max |logit| {top})")
    return {"whisper_loss": loss_routes,
            "whisper_decode_init": init_routes}


def phase_griffin(torch, get, registry, fa, rglru):
    """recurrentgemma-2b at its published width (bf16, seed 0): forward
    and loss over 4 × 4096 tokens (8 K2 launches, wgmma: window 2048 at
    hd 256), 64 decode steps at batch 4 on the 2,048-slot rings; decode ==
    forward on the first super-block in bf16 over 64 tokens and on the
    whole model in f32 over 256 tokens (as rwkv6's cell)."""
    cfg = get("recurrentgemma-2b")
    api = registry.build(cfg)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = init_model(torch, api, gen, "griffin")
    batch = registry.make_batch(cfg, 4, 4096, gen)
    b, s = batch["tokens"].shape
    want = {"wgmma": rglru.n_super(cfg), "fma": 0}
    reset_flash(fa)
    logits, fwd_s = timed(torch, lambda: api.forward(model, batch))
    routes = expect_routes(fa, want, "griffin forward")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("griffin forward: non-finite logits")
    del logits
    loss, loss_s = timed(torch, lambda: eval_loss(torch, api, model, batch))
    if not math.isfinite(loss):
        raise AssertionError(f"griffin loss {loss}")
    steps = 64
    st = api.decode_init(model, batch, 0)
    st, tok, decode_s = decode_run(torch, api, model, st,
                                   batch["tokens"][:, 0], steps)
    st, idle = profile_decode(torch, api, model, st, tok, "griffin")
    log(f"griffin forward {b} x {s} tokens in {fwd_s:.3f} s = "
        f"{b * s / fwd_s:.1f} tokens/s; flash_attention launches "
        f"{sum(routes.values())}, by route {routes}; loss {loss} in "
        f"{loss_s:.3f} s; decode {steps} steps at batch {b} (rings of "
        f"{cfg.window}) in {decode_s:.3f} s = {b * steps / decode_s:.1f} "
        f"tokens/s; idle share {idle:.3f}; logits finite; {_peak(torch)}")
    toks = batch["tokens"][:1, :256]
    head = rglru.GriffinParams(model.embed, list(model.supers[:1]),
                               list(model.tail[:1]), model.ln_f)
    sub = registry.build(dataclasses.replace(cfg, n_layers=3))
    err, top = _check_decode(torch, sub, head, {"tokens": toks[:, :64]},
                             GRIFFIN_BF16_TOL,
                             "griffin bf16 decode vs forward")
    log(f"griffin 64-token prompt, bf16 weights, first super-block: "
        f"decode_step vs forward max abs error {err} (atol "
        f"{GRIFFIN_BF16_TOL}; max |logit| {top})")
    del model, head, st
    gc.collect()
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    api = registry.build(cfg32)
    torch.cuda.reset_peak_memory_stats()
    model = api.init(torch.Generator(device="cuda").manual_seed(0))
    err, top = _check_decode(torch, api, model, {"tokens": toks},
                             GRIFFIN_TOL, "griffin f32 decode vs forward")
    log(f"griffin 256-token prompt, f32 weights: decode_step vs forward max "
        f"abs error {err} (atol {GRIFFIN_TOL}; max |logit| {top}); "
        f"{_peak(torch)}")
    return {"recurrentgemma_forward": routes}


def _check_decode(torch, api, model, batch, atol: float, what: str):
    """Feed ``batch["tokens"]`` [1, T] through ``decode_step`` one at a
    time against one ``forward`` of ``batch``; raise unless the logits
    agree within ``atol``."""
    toks = batch["tokens"]
    full = api.forward(model, batch)
    st = api.decode_init(model, batch, toks.shape[1])
    outs = []
    for i in range(toks.shape[1]):
        lg, st = api.decode_step(model, st, toks[:, i])
        outs.append(lg)
    err = _check_close(torch, torch.stack(outs, 1), full, atol, 0.0, what)
    return err, float(full.float().abs().max())


def phase_rwkv(torch, get, registry, wkv6):
    from repro_torch.models import rwkv6
    cfg = get("rwkv6-1.6b")
    api = registry.build(cfg)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    model = api.init(gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"rwkv    {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.d_model // cfg.rwkv_head_dim} heads of {cfg.rwkv_head_dim}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, bf16; {n_params} parameters "
        f"initialised on the card in {time.perf_counter() - t0:.3f} s")
    b, s = 4, 4096
    batch = registry.make_batch(cfg, b, s, gen)
    # one cold forward, then the median of 3; the launches are the first
    # timed forward's
    t0 = time.perf_counter()
    api.forward(model, batch)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    times = []
    wkv6.launches = 0
    for rep in range(3):
        logits = None                   # free the last forward's
        t0 = time.perf_counter()
        logits = api.forward(model, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if rep == 0:
            launches = wkv6.launches
    fwd_s = float(np.median(times))
    total = wkv6.launches
    t0 = time.perf_counter()
    loss = eval_loss(torch, api, model, batch)
    loss_s = time.perf_counter() - t0
    if launches != cfg.n_layers or total != 3 * cfg.n_layers \
            or not bool(torch.isfinite(logits).all()) \
            or not math.isfinite(loss):
        raise AssertionError(f"rwkv forward: launches {launches} (3 "
                             f"forwards: {total}), loss {loss}")
    log(f"rwkv    forward {b} x {s} tokens in {fwd_s:.3f} s (median of 3 "
        f"after a cold one of {cold_s:.3f} s; "
        f"{', '.join(f'{x:.3f}' for x in times)}) = {b * s / fwd_s:.1f} "
        f"tokens/s; wkv6 launches {launches} a forward; loss {loss} in "
        f"{loss_s:.3f} s; logits finite; {_peak(torch)}")
    del logits
    # step-by-step decode == forward in bf16 on the first two layers
    # (see RWKV_TOL)
    toks = batch["tokens"][:1, :256]
    depth = 2
    head = rwkv6.RWKV6LM(list(model.layers[:depth]), **{
        n: getattr(model, n) for n in rwkv6.MODEL_FIELDS})
    sub = registry.build(dataclasses.replace(cfg, n_layers=depth))
    err, top = _check_decode(torch, sub, head, {"tokens": toks[:, :64]},
                             RWKV_BF16_TOL, "rwkv bf16 decode vs forward")
    log(f"rwkv    64-token prompt, bf16 weights, first {depth} layers: "
        f"decode_step vs forward max abs error {err} (atol "
        f"{RWKV_BF16_TOL}; max |logit| {top})")
    del model, head
    gc.collect()
    torch.cuda.empty_cache()
    # step-by-step decode == forward, at full width in f32
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    api = registry.build(cfg32)
    torch.cuda.reset_peak_memory_stats()
    model = api.init(torch.Generator(device="cuda").manual_seed(0))
    err, top = _check_decode(torch, api, model, {"tokens": toks}, RWKV_TOL,
                             "rwkv f32 decode vs forward")
    log(f"rwkv    256-token prompt, f32 weights: decode_step vs forward "
        f"max abs error {err} (atol {RWKV_TOL}; max |logit| {top}); "
        f"{_peak(torch)}")
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--records", type=int, default=1_000_000_000,
                    help="deployment records (default the paper's 1B)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.configs import get, get_reduced
    from repro_torch.kernels import build
    from repro_torch.data import tokens as data
    from repro_torch.kernels.flash_attention.kernel import (
        _bwd_route, _route, flash_attention, flash_attention_bwd)
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                         attention_lse_ref,
                                                         attention_ref)
    from repro_torch.kernels.adamw import kernel as adamw_kernel
    from repro_torch.kernels.adamw import ref as adamw_ref
    from repro_torch.kernels.head_loss.kernel import loss_rows
    from repro_torch.kernels.head_loss.ops import pad_vocab
    from repro_torch.kernels.head_loss.ref import loss_rows_ref
    from repro_torch.kernels.leaf_search.kernel import (leaf_search,
                                                        leaf_search_pool)
    from repro_torch.kernels.moe_gmm.kernel import gmm, gmm_dw
    from repro_torch.kernels.moe_gmm.ref import gmm_dw_ref, gmm_ref
    from repro_torch.kernels.leaf_search.ops import lookup_leaves
    from repro_torch.kernels.leaf_search.ref import (leaf_search_pool_ref,
                                                     leaf_search_ref)
    from repro_torch.kernels.rwkv_scan.kernel import wkv6, wkv6_bwd
    from repro_torch.kernels.rwkv_scan.ops import wkv6_seq
    from repro_torch.kernels.rwkv_scan.ref import wkv6_bwd_ref, wkv6_ref
    from repro_torch.launch import train
    from repro_torch.models import moe, registry, rglru
    from repro_torch.models.common import flat_params
    from repro_torch.optim import adamw
    from repro_torch.workloads import engine, get_preset

    # every float32 matmul in full float32 (the GPU-vs-CPU comparisons)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    line = gpu_line()
    log(f"device  {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    log(line)

    # 2. build, one nvcc per source, all started together
    names = ("leaf_search", "flash_attention", "wkv6", "flash_attention_bwd",
             "wkv6_bwd", "head_loss", "moe_gmm", "adamw")
    t0 = time.perf_counter()
    libs = dict(zip(names, build.build_all(names)))
    log(f"build   {', '.join(n + '.cu' for n in names)} in "
        f"{time.perf_counter() - t0:.3f} s")
    phase_build_report(names, libs, build.BUILD_LOGS)

    # 3. each kernel against its plain version
    numbers = {"leaf_search": phase_kernel(torch, leaf_search,
                                           leaf_search_ref, leaf_search_pool,
                                           leaf_search_pool_ref,
                                           lookup_leaves),
               "flash_attention": phase_flash(torch, flash_attention,
                                              attention_ref, _route),
               "wkv6": phase_wkv(torch, wkv6, wkv6_ref, wkv6_seq)}
    numbers["flash_attention"]["windowed"] = phase_flash_window(
        torch, flash_attention, attention_ref, _route)
    torch.cuda.empty_cache()
    numbers["flash_attention_bwd"] = phase_flash_bwd(
        torch, flash_attention, flash_attention_bwd, attention_bwd_ref,
        attention_lse_ref, _bwd_route)
    numbers["wkv6_bwd"] = phase_wkv_bwd(torch, wkv6_bwd, wkv6_bwd_ref,
                                        build.BUILD_LOGS)
    torch.cuda.empty_cache()
    numbers["head_loss"] = phase_head_loss(torch, loss_rows, loss_rows_ref,
                                           pad_vocab)
    torch.cuda.empty_cache()
    numbers["moe_gmm"] = phase_moe_gmm(torch, gmm, gmm_dw, gmm_ref,
                                       gmm_dw_ref)
    torch.cuda.empty_cache()
    numbers["adamw"] = phase_adamw(torch, get, registry, flat_params,
                                   adamw_kernel, adamw_ref, adamw)

    # 4. the GPU run agrees with the CPU run
    phase_parity(torch, leaf_search, engine, get_preset)
    phase_chaos_parity(torch, leaf_search, get_preset)

    # 5. the deployment phase
    # the pool scales with the records: 25,165,824 rows per MS at 1B
    npm = 25_165_824 * args.records // 1_000_000_000
    dep = phase_deploy(torch, leaf_search, args.records, npm)
    # the cluster, open-loop and chaos phases on the same pool, then the
    # read-back of all four phases' acknowledged writes
    cfg, spec, acked = dep["cfg"], dep["spec"], dep["acked"]
    dep["state"], cluster_launches, mops, horizon = phase_cluster(
        torch, leaf_search, cfg, dep["state"], spec, dep["keyspace"], acked)
    dep["state"], open_launches = phase_open_loop(
        torch, leaf_search, cfg, dep["state"], spec, dep["keyspace"], acked,
        mops / 2)
    gc.collect()        # the earlier phases' fleets hold the pool in cycles
    dep["state"], chaos_launches = phase_chaos(
        torch, leaf_search, cfg, dep.pop("state"), spec, dep["keyspace"],
        acked, horizon)
    read_back(torch, dep, "deploy, cluster, open-loop and chaos phases")
    # the mesh-sharded index: card == CPU on the reference test's mesh,
    # then deploy-1B's pool over four gloo ranks, one a memory server
    gc.collect()
    phase_sharded_parity(torch)
    sharded_launches = phase_sharded(torch, dep)
    leaf_paths = dict(deploy=dep["launches"], cluster=cluster_launches,
                      open_loop=open_launches, chaos=chaos_launches,
                      sharded=sharded_launches)
    launches = {"leaf_search": dep["launches"]}
    del dep, acked
    gc.collect()                # the index's pool, held by a cycle
    torch.cuda.empty_cache()
    log(f"deploy  freed: memory_allocated {torch.cuda.memory_allocated()}")

    # 6.-12. the LM serving paths; the loss kernel's launches on each path
    # that takes an eval loss (read-only, one a loss)
    head_paths = {}
    phase_lm_parity(torch, get_reduced, registry, (flash_attention, wkv6))
    flash_paths = phase_granite(torch, get, registry, flash_attention)
    gc.collect()
    torch.cuda.empty_cache()
    n0 = loss_rows.launches
    launches["wkv6"] = phase_rwkv(torch, get, registry, wkv6)
    head_paths["rwkv_loss"] = loss_rows.launches - n0
    for phase, args in ((phase_qwen, (moe,)), (phase_internvl, ()),
                        (phase_whisper, ()), (phase_griffin, (rglru,))):
        gc.collect()
        torch.cuda.empty_cache()
        n0 = loss_rows.launches
        flash_paths.update(phase(torch, get, registry, flash_attention,
                                 *args))
        if loss_rows.launches > n0:
            head_paths[phase.__name__[len("phase_"):] + "_loss"] = \
                loss_rows.launches - n0
    launches["flash_attention"] = sum(flash_paths["granite_prefill"].values())

    # 13.-16. the training path: reduced models card == CPU, then the five
    # full-width training cells
    gc.collect()
    torch.cuda.empty_cache()
    parity_bwd, parity_routes, head_paths["lm_parity_train"], parity_opt = \
        phase_lm_parity_train(torch, get_reduced, registry, train, adamw,
                              flat_params, flash_attention_bwd, wkv6_bwd)
    # AdamW's launches on each training path (each phase raises unless
    # they are one step's worth a step)
    opt_paths = {"lm_parity_train": parity_opt}
    bwd_paths = {"flash_attention_bwd": {}, "wkv6_bwd": {}}
    # K2's backward by route on each path (the train cell raises unless
    # all its launches took wgmma)
    fa_bwd_routes = {"lm_parity_train": parity_routes}
    wkv_paths = {"rwkv_forward": launches["wkv6"]}
    curves = {}
    for cell in TRAIN_CELLS:
        tag, bwd_name = cell[0], cell[4]
        gc.collect()
        torch.cuda.empty_cache()
        run_launches, curves[tag] = phase_train(
            torch, get, registry, train, adamw, data, flash_attention,
            flash_attention_bwd, wkv6, wkv6_bwd, cell)
        path = f"{tag}_train"
        head_paths[path] = run_launches["head_loss"]
        opt_paths[path] = run_launches["adamw"]
        # a backward kernel's launches: over every training cell it runs in
        bwd_paths[bwd_name][path] = run_launches[bwd_name]
        launches[bwd_name] = launches.get(bwd_name, 0) + \
            run_launches[bwd_name]
        if bwd_name == "flash_attention_bwd":
            flash_paths[path] = {"wgmma": run_launches["flash_attention"],
                                 "fma": 0}
            fa_bwd_routes[path] = {"wgmma": run_launches[bwd_name],
                                   "fma": 0}
        else:
            wkv_paths[path] = run_launches["wkv6"]
    # the published MoE cut as train-qwen1.5-moe-a2.7b: the grouped kernels
    gc.collect()
    torch.cuda.empty_cache()
    moe_run = phase_moe_train(torch, get, registry, train, adamw,
                              flat_params, moe, gmm, gmm_dw)
    launches["moe_gmm"] = moe_run["launches"]
    numbers["moe_gmm"]["train_step"] = moe_run["step"]
    opt_paths["qwen1.5_moe_train"] = moe_run["adamw"]
    # 17. train-smollm-135m-sharded: four gloo ranks, a drop, a reshard
    sharded_k2 = phase_train_sharded(torch, curves["smollm"], line)
    path = "smollm_sharded_train"
    flash_paths[path] = {"wgmma": sharded_k2["flash_attention"], "fma": 0}
    bwd_paths["flash_attention_bwd"][path] = \
        sharded_k2["flash_attention_bwd"]
    fa_bwd_routes[path] = {"wgmma": sharded_k2["flash_attention_bwd"],
                           "fma": 0}
    launches["flash_attention_bwd"] += sharded_k2["flash_attention_bwd"]
    head_paths[path] = sharded_k2["head_loss"]
    launches["head_loss"] = sum(head_paths.values())
    opt_paths[path] = sharded_k2["adamw"]
    launches["adamw"] = sum(opt_paths.values())
    for bwd_name, paths in bwd_paths.items():
        paths["lm_parity_train"] = parity_bwd[bwd_name]

    replaces = {
        "leaf_search": "src/repro/kernels/leaf_search/kernel.py:48",
        "flash_attention": "src/repro/kernels/flash_attention/kernel.py:74",
        "wkv6": "src/repro/kernels/rwkv_scan/kernel.py:46",
        # the backward kernels stand beside the forwards' TPU kernels,
        # which have no backward
        "flash_attention_bwd":
            "src/repro/kernels/flash_attention/kernel.py:74",
        "wkv6_bwd": "src/repro/kernels/rwkv_scan/kernel.py:46",
        # no TPU kernel: it replaces the reference's f32 loss
        # (repro/models/common.py::cross_entropy) on the training path
        "head_loss": None,
        # no TPU kernel: the reference's capacity-bounded expert einsums
        # are XLA's; the dropless dispatch's groups have no library product
        "moe_gmm": None,
        # no TPU kernel: the reference leaves AdamW and its norm to XLA
        # (repro/optim/adamw.py)
        "adamw": None}
    kernels = [dict({"library_ms": None}, name=name, route="cuda",
                    source=f"src/repro_torch/csrc/{name}.cu",
                    replaces=replaces[name], launches=launches[name],
                    **numbers[name])
               for name in names]
    kernels[0]["launches_by_path"] = leaf_paths
    kernels[1]["launches_by_path"] = {
        path: sum(routes.values()) for path, routes in flash_paths.items()}
    kernels[1]["launches_by_route"] = {
        route: sum(r[route] for r in flash_paths.values())
        for route in ("wgmma", "fma")}
    kernels[2]["launches_by_path"] = wkv_paths
    kernels[3]["launches_by_path"] = bwd_paths["flash_attention_bwd"]
    kernels[3]["launches_by_route"] = {
        route: sum(r[route] for r in fa_bwd_routes.values())
        for route in ("wgmma", "fma")}
    kernels[4]["launches_by_path"] = bwd_paths["wkv6_bwd"]
    kernels[5]["launches_by_path"] = head_paths
    kernels[6]["launches_by_path"] = {"qwen1.5_moe_train":
                                      launches["moe_gmm"]}
    kernels[7]["launches_by_path"] = opt_paths
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
