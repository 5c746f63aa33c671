#!/usr/bin/env python3
"""Drive the PyTorch port of the Sherman index on one CUDA card.

    python3 chip_smoke.py                      # the full check, one GPU
    python3 chip_smoke.py --records 134217728  # a smaller deployment phase

Phases, in order; any failure raises and exits non-zero:

1. device  — require CUDA; print the card's name and power limit;
2. build   — compile the leaf-search kernel from ``src/repro_torch/csrc``;
3. kernel  — hold the CUDA kernel against its plain version on the card,
   bit for bit, at the reference kernel test's shapes and the main path's,
   and time both on the device (a replayed CUDA graph) and per eager call;
4. parity  — ``run_systems`` for ``sherman`` and ``fg+`` on the quick
   YCSB-A spec on the card and on the CPU: the RunResults must be equal;
5. deploy  — the paper-scale index (1B records, 80% full leaves, height 8)
   under the write-intensive mix: bulkload, run, netsim metrics, kernel
   launches, peak memory, and every acknowledged write read back.

The line before the last is a JSON object with the kernel's numbers; the
last line is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and the float32 rate
#: outside the tensor cores, which bounds the kernel's scalar compares.
HBM_BYTES_S = 3.35e12
SCALAR_OPS_S = 67e12

KERNEL_SHAPES = [(256, 8), (512, 16), (128, 32), (256, 64),   # kernel test
                 (512, 16), (1024, 16), (1000, 16)]           # main path
MAIN_PATH_SHAPE = (512, 16)     # lookup bucket at batch 1024, 50% reads


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


def phase_kernel(torch, leaf_search, leaf_search_ref):
    rng = np.random.default_rng(7)
    dev = torch.device("cuda")
    max_err = 0
    timed = timed_host = None
    for b, f in KERNEL_SHAPES:
        host = kernel_inputs(rng, b, f)
        for ver in (torch.int32, torch.uint8):
            args = [torch.from_numpy(a).to(dev) for a in host]
            args[3], args[4] = args[3].to(ver), args[4].to(ver)
            got = leaf_search(*args)
            want = leaf_search_ref(*args)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                if g.dtype != w.dtype or not torch.equal(g, w):
                    raise AssertionError(f"leaf_search != plain at B={b} "
                                         f"F={f} versions {ver}")
                err = (g.to(torch.int64) - w.to(torch.int64)).abs().max()
                max_err = max(max_err, int(err))
            if (b, f) == MAIN_PATH_SHAPE and ver == torch.uint8:
                timed, timed_host = args, host
        log(f"kernel  B={b:5d} F={f:3d}: equal to plain (int32 and uint8 "
            f"versions)")
    b, f = MAIN_PATH_SHAPE
    ms = device_ms(torch, lambda: leaf_search(*timed))
    plain_ms = device_ms(torch, lambda: leaf_search_ref(*timed))
    call_ms = host_ms(torch, lambda: leaf_search(*timed))
    plain_call_ms = host_ms(torch, lambda: leaf_search_ref(*timed))
    # What the function must move (uint8 versions): every lane reads its
    # query, fnv, rnv and free (16 B) and its whole key row (4F B), and
    # writes value, found and consistent (6 B); a lane whose row holds the
    # query also reads that slot's value and FEV/REV bytes (6 B).
    q, keys = timed_host[0], timed_host[1]
    matched = int((keys == q[:, None]).any(axis=1).sum())
    n_bytes = b * (4 * f + 16 + 6) + matched * 6
    n_ops = b * f + 8 * b          # slot compares + the per-lane checks
    bytes_ms = n_bytes / HBM_BYTES_S * 1e3
    ops_ms = n_ops / SCALAR_OPS_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    log(f"kernel  B={b} F={f} uint8: device {ms:.6f} ms, plain device "
        f"{plain_ms:.6f} ms (CUDA graph of 100 calls); per eager call "
        f"{call_ms:.6f} ms, plain {plain_call_ms:.6f} ms; bound "
        f"{bound_ms:.9f} ms ({n_bytes} bytes, {matched} matched lanes)")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                host_ms=call_ms, plain_host_ms=plain_call_ms)


def phase_parity(torch, leaf_search, engine, get_preset):
    spec = get_preset("ycsb-a", load_records=8_000, ops=4_096, batch=1_024,
                      theta=0.99)
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
        f"leaf_search launches {launches}")


def phase_deploy(torch, leaf_search, records: int, nodes_per_ms: int):
    from repro_torch.core import SHERMAN, ShermanIndex, TreeConfig
    from repro_torch.core.ops import lookup_batch
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

    acked: dict[int, int] = {}
    insert = idx.insert

    def recording_insert(k, v):
        insert(k, v)            # returns once the batch is applied
        for kk, vv in zip(np.asarray(k, np.int64).tolist(),
                          np.asarray(v, np.int64).tolist()):
            acked[kk] = vv
    idx.insert = recording_insert

    leaf_search.launches = 0
    t4 = time.perf_counter()
    res = engine.run_workload(idx, spec, keyspace=keyspace,
                              system="sherman")
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    launches = leaf_search.launches
    run_s = t5 - t4
    peak = torch.cuda.max_memory_allocated()
    log(f"deploy  run {run_s:.3f} s, {res.n_ops / run_s:.1f} ops/s "
        f"wall-clock on the card; netsim mops {res.mops} p50_us "
        f"{res.p50_us} p99_us {res.p99_us}; leaf_search launches "
        f"{launches}; max_memory_allocated {peak}")
    for name in ("mops", "p50_us", "p99_us"):
        v = getattr(res, name)
        if not (math.isfinite(v) and v > 0):
            raise AssertionError(f"deploy: {name}={v}")
    if res.n_ops != spec.ops or launches <= 0:
        raise AssertionError(f"deploy: n_ops={res.n_ops} "
                             f"launches={launches}")

    # -- the guarantee: every acknowledged write reads back, and the
    # untouched loaded records keep their load values --
    untouched = ~np.isin(probe_keys, np.fromiter(acked, np.int64))
    want = {**dict(zip(probe_keys[untouched].tolist(),
                       probe_vals[untouched].tolist())), **acked}
    k_all = np.fromiter(want, np.int64).astype(np.int32)
    v_all = np.fromiter(want.values(), np.int64).astype(np.int32)
    t6 = time.perf_counter()
    for lo in range(0, k_all.size, 1 << 18):
        q = torch.from_numpy(k_all[lo:lo + (1 << 18)]).cuda()
        r = lookup_batch(cfg, idx.state, q)
        found = r.found.cpu().numpy()
        got = r.value.cpu().numpy()
        if not found.all() or not (got == v_all[lo:lo + q.numel()]).all():
            bad = np.nonzero(~found | (got != v_all[lo:lo + q.numel()]))[0]
            raise AssertionError(f"deploy: {bad.size} keys read back wrong, "
                                 f"first {k_all[lo + bad[0]]}")
    t7 = time.perf_counter()
    log(f"deploy  read back {len(acked)} acknowledged writes and "
        f"{int(untouched.sum())} untouched loaded records exactly "
        f"({t7 - t6:.3f} s)")
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
    from repro_torch.kernels import build
    from repro_torch.kernels.leaf_search.kernel import leaf_search
    from repro_torch.kernels.leaf_search.ref import leaf_search_ref
    from repro_torch.workloads import engine, get_preset

    # 1. device
    line = gpu_line()
    log(f"device  {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    log(line)

    # 2. build
    t0 = time.perf_counter()
    build.load("leaf_search")
    log(f"build   leaf_search.cu in {time.perf_counter() - t0:.3f} s")
    for ln in build.BUILD_LOGS.get("leaf_search", "").splitlines():
        if "registers" in ln or "spill" in ln:
            log(f"build   {ln.strip()}")

    # 3. kernel against its plain version
    numbers = phase_kernel(torch, leaf_search, leaf_search_ref)

    # 4. the GPU run agrees with the CPU run
    phase_parity(torch, leaf_search, engine, get_preset)

    # 5. the deployment phase
    # the pool scales with the records: 25,165,824 rows per MS at 1B
    npm = 25_165_824 * args.records // 1_000_000_000
    launches = phase_deploy(torch, leaf_search, args.records, npm)

    kernels = [dict(
        name="leaf_search", route="cuda",
        source="src/repro_torch/csrc/leaf_search.cu",
        replaces="src/repro/kernels/leaf_search/kernel.py:48",
        launches=launches, library_ms=None, **numbers)]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
