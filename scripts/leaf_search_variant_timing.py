#!/usr/bin/env python3
"""Build design variants of the leaf-search kernel and time them on the
card, at the main path's shape against a pool far larger than L2.

    python scripts/leaf_search_variant_timing.py [--rows N] [--turns 2]

A variant is an edited copy of ``src/repro_torch/csrc/leaf_search.cu``:
``VARIANTS`` below gives each one's text edits (each must match the
source exactly once, so an edit that no longer applies raises).  The
copies are written to ``build/leaf_variants/<n>/`` and built there, one
``nvcc`` per variant, all started together; ptxas's registers and spills
are printed for each.  Every variant is then held bit for bit against the
plain versions (the pool entry on torn rows at F = 8, 16, 32, 64, a
ragged batch and out-of-range leaf ids; the gathered-row entry at F = 16
and 13) and timed at B = 512, F = 16 (the deploy-1B probe's bucket) on a
synthetic pool of ``--rows`` rows (default 2^25, 5.5 GB): a CUDA graph of
100 ``lookup_leaves`` calls, each with its own fresh random leaf ids (so
every row is a cold DRAM read), replayed for 15 samples, the median; the
same with one fixed set of ids (rows in L2 after the first call), and
with one lane a call (the launch's floor).  Beside each variant, the
gather composition (the pool rows gathered and cast by PyTorch, then the
variant's gathered-row entry) on the same ids.  Variants run in turns,
forwards then backwards (A B ... B A), in one process.  Imports nothing
of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.leaf_search.kernel import (  # noqa: E402
    leaf_search, leaf_search_pool)
from repro_torch.kernels.leaf_search.ops import lookup_leaves  # noqa: E402
from repro_torch.kernels.leaf_search.ref import (  # noqa: E402
    leaf_search_pool_ref, leaf_search_ref)

# the dependent select: only the key loads with the row; the matching
# thread loads its value and FEV/REV after the ballot (a second round trip)
_DEPENDENT = [
    ("""      v = __ldg(vals + at);
      fe = __ldg(fev + at);
      re = __ldg(rev + at);
""", ""),
    ("""      value = v;
      entry_ok = fe == re;
""", """      if (owner) {
        value = __ldg(vals + at);
        entry_ok = static_cast<int32_t>(__ldg(fev + at)) ==
                   static_cast<int32_t>(__ldg(rev + at));
      }
""")]
# a warp per lane whatever F (the first port's scheme, at F = 16 half idle)
_WARP = [("  int lg = 0;\n", "  int lg = 5;\n")]


def _block(n: int):
    return [("constexpr int kThreads = 128;",
             f"constexpr int kThreads = {n};")]


#: name -> text edits (old, new) of leaf_search.cu; the first is the source
#: as it is
VARIANTS = {
    "design: F threads a lane, one slot each, speculative, 128/block": [],
    "dependent select (vals/fev/rev after the match)": _DEPENDENT,
    "warp per lane, dependent (the first port's scheme), 256/block":
        _WARP + _DEPENDENT + _block(256),
    "warp per lane, speculative, 256/block": _WARP + _block(256),
    "64 threads a block": _block(64),
    "256 threads a block": _block(256),
    "512 threads a block": _block(512),
}
B, F = 512, 16
REPS, SAMPLES = 100, 15
I32 = torch.int32


def edited(src: str, edits) -> str:
    """``src`` with each (old, new) edit made; raise unless ``old`` occurs
    exactly once."""
    for old, new in edits:
        if src.count(old) != 1:
            raise ValueError(f"edit does not match leaf_search.cu once: "
                             f"{old!r}")
        src = src.replace(old, new)
    return src


def build_variants(out_dir: Path) -> dict[str, Path]:
    """One edited copy of the source and one nvcc per variant, all
    started together; raise on a failure."""
    src = (build.CSRC / "leaf_search.cu").read_text()
    jobs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        d = out_dir / str(i)
        d.mkdir(parents=True, exist_ok=True)
        (d / "leaf_search.cu").write_text(edited(src, edits))
        out = d / "leaf_search.so"
        jobs[name] = (out, subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(out),
             str(d / "leaf_search.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{log}")
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"[{name}] {ln.strip()}")
        libs[name] = out
    return libs


def use(path: Path) -> None:
    """Route the port's wrappers to this variant's library."""
    build._LOADED["leaf_search"] = ctypes.CDLL(str(path))


def main_path_calls(st, leaf, q):
    """The calls timed, each call k on row k of ``leaf``/``q``:
    lookup_leaves and the gather composition."""
    pool = (st.keys, st.vals, st.fev, st.rev, st.fnv, st.rnv, st.free_bit)
    return (lambda k: lookup_leaves(None, st, leaf[k], q[k]),
            lambda k: cs.gathered_lookup_leaves(torch, leaf_search, pool,
                                            leaf[k], q[k]))


def check(name: str, gen: torch.Generator) -> None:
    """Bit for bit against the plain versions; raise on a difference."""
    for f, b in ((8, 256), (16, 512), (16, 300), (32, 128), (64, 256)):
        n = 4096
        pool = cs.leaf_pool(torch, n, f)
        leaf = torch.empty((b,), dtype=I32, device="cuda")
        q = torch.empty_like(leaf)
        cs.fill_leaf_queries(torch, leaf, q, n, f, gen)
        leaf[::7] -= n + 3                  # negative and below the pool
        leaf[1::11] += n                     # past the pool
        args = (q, leaf, *pool)
        got, want = leaf_search_pool(*args), leaf_search_pool_ref(*args)
        gathered = [x[:b] for x in pool[:4]]
        node = [x[:b].to(I32) for x in pool[4:]]
        got_g = leaf_search(q, *gathered, *node)
        want_g = leaf_search_ref(q, *gathered, *node)
        for g, w in [*zip(got, want), *zip(got_g, want_g)]:
            if g.dtype != w.dtype or not torch.equal(g, w):
                raise AssertionError(f"[{name}] != plain at F={f} B={b}")
    odd = [torch.randint(0, 50, (64, 13), generator=gen, device="cuda",
                         dtype=I32) for _ in range(4)]
    q = odd[0][:, 5].contiguous()
    node = [torch.zeros(64, dtype=I32, device="cuda")] * 3
    for g, w in zip(leaf_search(q, *odd, *node), leaf_search_ref(q, *odd,
                                                                  *node)):
        if not torch.equal(g, w):
            raise AssertionError(f"[{name}] != plain at F=13")
    print(f"[{name}] equal to the plain versions (pool and gathered-row "
          "entries)", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1 << 25)
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args()
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {out}; torch {torch.__version__}", flush=True)
    libs = build_variants(ROOT / "build" / "leaf_variants")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, path in libs.items():
        use(path)
        check(name, gen)

    n = args.rows
    pool = cs.leaf_pool(torch, n, F)
    st = cs.pool_state(pool)
    pool_bytes = sum(t.numel() * t.element_size() for t in pool)
    print(f"pool: {n} rows of F={F}, {pool_bytes} bytes; B={B}; "
          f"{REPS} calls a graph, median of {SAMPLES}", flush=True)
    leaf = torch.empty((REPS, B), dtype=I32, device="cuda")
    q = torch.empty_like(leaf)
    refill = lambda: cs.fill_leaf_queries(torch, leaf, q, n, F, gen)
    refill()
    new, old = main_path_calls(st, leaf, q)
    lone = lambda k: lookup_leaves(None, st, leaf[k, :1], q[k, :1])
    order = list(libs)
    for turn in range(args.turns):
        for name in (order if turn % 2 == 0 else order[::-1]):
            use(libs[name])
            cold = cs.fresh_rows_ms(torch, new, REPS, SAMPLES, refill)
            warm = cs.fresh_rows_ms(torch, new, REPS, SAMPLES)
            one = cs.fresh_rows_ms(torch, lone, REPS, SAMPLES)
            comp = cs.fresh_rows_ms(torch, old, REPS, SAMPLES, refill)
            print(f"[{name}] turn {turn}: lookup_leaves cold {cold:.6f} ms, "
                  f"warm {warm:.6f} ms, one warm lane {one:.6f} ms; gather "
                  f"composition cold {comp:.6f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
