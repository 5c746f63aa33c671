#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card: the Sherman index and the LM
serving paths.

    python3 chip_smoke.py                      # the full check, one GPU
    python3 chip_smoke.py --records 134217728  # a smaller deployment phase

Phases, in order; any failure raises and exits non-zero:

1. device  — require CUDA; print the card's name and power limit;
2. build   — compile the three kernels from ``src/repro_torch/csrc``, one
   ``nvcc`` per source, all started together; print ptxas's registers,
   spills and performance notes per kernel (raise on a spill) and the
   count of ``HGMMA`` (wgmma) instructions in the flash library's SASS
   (raise if 0);
3. kernel  — hold each CUDA kernel against its plain version on the card
   (leaf search bit for bit, both entries: gathered rows, and the pool
   with leaf ids; flash attention and WKV6 within the reference kernel
   test's tolerances) at the reference kernel test's shapes, a ragged
   shape and the main paths' shapes (flash attention on both of its
   routes: ``wgmma`` for bf16 at hd 64 and 128 without a window,
   ``fma`` otherwise; with a sliding window at every head dim up to 256,
   with rows that see no key, whisper-medium's encoder and
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
   (8 launches on the ``fma`` route, window 2048 at hd 256), 64 decode
   steps on the 2,048-slot rings; decode == forward on the first
   super-block in bf16 and on the whole model in f32.

Each LM cell prints tokens/s, the device idle share of a profiled decode
step, peak memory and K2's launches by route, and raises if the launches
differ from the counts above.

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

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, the float32 rate
#: outside the tensor cores (the leaf search's compares, the WKV6
#: recurrence) and the dense bf16 tensor-core rate (attention).
HBM_BYTES_S = 3.35e12
SCALAR_OPS_S = 67e12
BF16_TENSOR_OPS_S = 989e12

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
# K2's window and cross shapes (B, H, KV, Sq, Sk, hd, causal, window,
# dtype, atol, rtol), all but whisper's on the fma route: a clipping
# window at every head dim in both dtypes, a window at least S, window 1,
# Sq > Sk with rows that see no key, windowed full attention over
# Sq < Sk and Sq = Sk;
# whisper-medium's encoder (S 1500, ragged against the 128-row tiles) and
# cross-attention (Sq 4096, Sk 1500) at its loss's shapes on the wgmma
# route; recurrentgemma-2b's local attention (MQA, hd 256, window 2048)
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
    sass = subprocess.run([cuobjdump, "-sass", str(libs["flash_attention"])],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    n_hgmma = sum("HGMMA" in ln for ln in sass.splitlines())
    log(f"build   flash_attention: {n_hgmma} HGMMA instructions in the SASS "
        f"({cuobjdump} -sass)")
    if n_hgmma == 0:
        raise AssertionError("the flash library has no wgmma (HGMMA) "
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
#: write-intensive waves of deploy-1B-sharded through the pjit path
SHARDED_WAVES = 4
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
    """K2's sliding window and cross shapes against the
    plain version (``FLASH_WINDOWED``), then recurrentgemma-2b's local
    attention timed against its bound and SDPA with the same boolean
    mask; return its numbers."""
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
    kernel = lambda: flash_attention(q, k, v, causal=True, window=window)
    library = lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True)
    # SDPA computes the same function: check it before timing it
    _check_close(torch, library(), kernel(), 4e-3, 1e-2,
                 "SDPA with the window mask vs the kernel")
    ms = device_ms(torch, kernel, reps=5, samples=5)
    call_ms = host_ms(torch, kernel, reps=5, samples=5)
    lib_ms = device_ms(torch, library, reps=5, samples=5)
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
        f"window={window} bfloat16 causal (fma route): device {ms:.6f} ms "
        f"(CUDA graph of 5 calls); per eager call {call_ms:.6f} ms; SDPA "
        f"with the boolean window mask {lib_ms:.6f} ms (CUDA graph of 5 "
        f"calls); plain {plain_ms:.6f} ms per eager call; bound "
        f"{bound_ms:.6f} ms ({pairs} pairs a head, {n_ops} flops at bf16 "
        f"peak {ops_ms:.6f} ms, {n_bytes} bytes {bytes_ms:.6f} ms); "
        f"{ms / bound_ms:.3f}x the bound, {ms / lib_ms:.3f}x SDPA; "
        f"{_peak(torch)}")
    return dict(route="fma", shape=dict(B=b, H=h, KV=kv, S=s, hd=hd,
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
    loss, loss_s = timed(torch, lambda: float(api.loss(model, batch)))
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
    loss, loss_s = timed(torch, lambda: float(api.loss(model, batch)))
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
    and loss over 4 × 4096 tokens (8 K2 launches, fma: window 2048 at hd
    256), 64 decode steps at batch 4 on the 2,048-slot rings; decode ==
    forward on the first super-block in bf16 over 64 tokens and on the
    whole model in f32 over 256 tokens (as rwkv6's cell)."""
    cfg = get("recurrentgemma-2b")
    api = registry.build(cfg)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = init_model(torch, api, gen, "griffin")
    batch = registry.make_batch(cfg, 4, 4096, gen)
    b, s = batch["tokens"].shape
    want = {"wgmma": 0, "fma": rglru.n_super(cfg)}
    reset_flash(fa)
    logits, fwd_s = timed(torch, lambda: api.forward(model, batch))
    routes = expect_routes(fa, want, "griffin forward")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("griffin forward: non-finite logits")
    del logits
    loss, loss_s = timed(torch, lambda: float(api.loss(model, batch)))
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
    loss = float(api.loss(model, batch))
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
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get, get_reduced
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.kernel import (_route,
                                                            flash_attention)
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.leaf_search.kernel import (leaf_search,
                                                        leaf_search_pool)
    from repro_torch.kernels.leaf_search.ops import lookup_leaves
    from repro_torch.kernels.leaf_search.ref import (leaf_search_pool_ref,
                                                     leaf_search_ref)
    from repro_torch.kernels.rwkv_scan.kernel import wkv6
    from repro_torch.kernels.rwkv_scan.ops import wkv6_seq
    from repro_torch.kernels.rwkv_scan.ref import wkv6_ref
    from repro_torch.models import moe, registry, rglru
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
    names = ("leaf_search", "flash_attention", "wkv6")
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

    # 6.-12. the LM serving paths
    phase_lm_parity(torch, get_reduced, registry, (flash_attention, wkv6))
    flash_paths = phase_granite(torch, get, registry, flash_attention)
    gc.collect()
    torch.cuda.empty_cache()
    launches["wkv6"] = phase_rwkv(torch, get, registry, wkv6)
    for phase, args in ((phase_qwen, (moe,)), (phase_internvl, ()),
                        (phase_whisper, ()), (phase_griffin, (rglru,))):
        gc.collect()
        torch.cuda.empty_cache()
        flash_paths.update(phase(torch, get, registry, flash_attention,
                                 *args))
    launches["flash_attention"] = sum(flash_paths["granite_prefill"].values())

    replaces = {
        "leaf_search": "src/repro/kernels/leaf_search/kernel.py:48",
        "flash_attention": "src/repro/kernels/flash_attention/kernel.py:74",
        "wkv6": "src/repro/kernels/rwkv_scan/kernel.py:46"}
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
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
