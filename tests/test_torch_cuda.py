"""PyTorch port on the card: each CUDA kernel against its plain version, and
the reduced models on the card (kernels) against the CPU (plain versions).

Imports neither JAX nor the JAX package, so a GPU host without JAX
collects it:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a card every test skips.  Tolerances: leaf search exact (both
entries: gathered rows, and the pool with leaf ids); flash
attention 2e-5 in f32 and 3e-2 in bf16 at the reference kernel test's
shapes (tests/test_kernels.py), 4e-3 absolute plus 1e-2 relative in bf16
at the models' widths and on the wgmma route's own cases; WKV6 1e-4 in
f32 and 0.15 in bf16; the reduced models (every family) 1e-4 in f32."""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs as TC
from repro_torch.core import tree as TT
from repro_torch.core.api import ShermanIndex
from repro_torch.kernels.flash_attention.kernel import (_route,
                                                        flash_attention)
from repro_torch.kernels.flash_attention.ops import flash_sdpa
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.leaf_search.kernel import (leaf_search,
                                                    leaf_search_pool)
from repro_torch.kernels.leaf_search.ops import lookup_leaves
from repro_torch.kernels.leaf_search.ref import (leaf_search_pool_ref,
                                                 leaf_search_ref)
from repro_torch.kernels.rwkv_scan.kernel import CHUNK, wkv6
from repro_torch.kernels.rwkv_scan.ops import wkv6_seq
from repro_torch.kernels.rwkv_scan.ref import wkv6_ref
from repro_torch.models import registry as TREG

pytestmark = [pytest.mark.cuda,
              pytest.mark.skipif(not torch.cuda.is_available(),
                                 reason="needs a CUDA device")]


def close(got, want, atol, rtol):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=atol,
                               rtol=rtol)


# --------------------------------------------------------------------------
# leaf search: bit for bit
# --------------------------------------------------------------------------

def leaf_inputs(seed, b, f):
    """The reference kernel test's generator (tests/test_kernels.py)."""
    rng = np.random.default_rng(seed)
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


@pytest.mark.parametrize("b,f", [(256, 8), (512, 16), (1000, 16), (1, 16),
                                 (256, 64)])
def test_leaf_search_kernel_matches_plain_version(b, f):
    args = [torch.from_numpy(a).cuda() for a in leaf_inputs(b, b, f)]
    n0 = leaf_search.launches
    got = leaf_search(*args)
    want = leaf_search_ref(*args)
    torch.cuda.synchronize()
    assert leaf_search.launches == n0 + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def assert_same_bits(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.device == w.device
        assert torch.equal(g, w)


@pytest.mark.parametrize("b,f,offset", [(300, 6, 0), (64, 13, 0),
                                        (256, 16, 1), (100, 32, 2)])
def test_leaf_search_kernel_unaligned_rows(b, f, offset):
    """Odd fanouts (F not a power of two, so a lane's group of threads
    has idle slots) and row arrays whose base lies off a 16-byte
    boundary give the plain version's bits."""
    host = leaf_inputs(b + f, b, f)
    args = [torch.from_numpy(a).cuda() for a in host]
    for i in (1, 2, 3, 4):                       # keys, vals, fev, rev
        buf = torch.empty(b * f + offset, dtype=args[i].dtype, device="cuda")
        args[i] = buf[offset:].view(b, f).copy_(args[i])
    n0 = leaf_search.launches
    got = leaf_search(*args)
    torch.cuda.synchronize()
    assert leaf_search.launches == n0 + 1
    assert_same_bits(got, leaf_search_ref(*args))


def torn_pool(fanout, lanes, seed):
    """A bulkloaded pool (built on the CPU, moved to the card) with torn
    versions: fnv != rnv on some leaves, free_bit on others, fev != rev in
    every entry of some leaves and in half the entries of others; and
    ``lanes`` int32 queries: leaf ids of torn and clean leaves and of other
    rows (internal, unallocated, negative, past the pool), with keys of the
    row's slots or absent."""
    cfg = TT.TreeConfig(n_ms=2, nodes_per_ms=1024, fanout=fanout,
                        n_locks_per_ms=1024, max_height=8, n_cs=2)
    rng = np.random.default_rng(seed)
    keys = rng.choice(1 << 20, size=30 * fanout, replace=False)
    st = ShermanIndex.build(cfg, keys.astype(np.int32),
                            (keys * 3).astype(np.int32), device="cpu").state
    leaves = rng.permutation(np.nonzero(st.level.numpy() == 0)[0])
    st.fnv[leaves[:3]] += 1
    st.free_bit[leaves[3:5]] = True
    st.fev[leaves[5:8]] += 1
    st.rev[leaves[8:11], ::2] += 1
    n = cfg.n_nodes
    kind = rng.integers(0, 10, lanes)
    row = np.where(kind < 3, rng.choice(leaves[:11], lanes),
          np.where(kind < 6, rng.choice(leaves, lanes),
          np.where(kind < 8, rng.integers(0, n, lanes),
          np.where(kind < 9, rng.integers(-n - 3, 0, lanes),
                   rng.integers(n, n + 5, lanes)))))
    at = np.clip(np.where(row < 0, row + n, row), 0, n - 1)
    slot_key = st.keys.numpy()[at, rng.integers(0, fanout, lanes)]
    q = np.where(rng.random(lanes) < 0.7, slot_key,
                 (1 << 22) + np.arange(lanes))
    st = TT.TreeState(*[x.cuda() for x in st])
    return (cfg, st, torch.from_numpy(row.astype(np.int32)).cuda(),
            torch.from_numpy(q.astype(np.int32)).cuda())


def pool_args(st, leaf, q):
    return (q, leaf, st.keys, st.vals, st.fev, st.rev, st.fnv, st.rnv,
            st.free_bit)


@pytest.mark.parametrize("f", [8, 16, 32, 64])
@pytest.mark.parametrize("b", [512, 300, 64, 32, 16, 1])
def test_leaf_search_pool_kernel_matches_plain_version(b, f):
    """One launch per lookup_leaves, bit for bit with the plain version
    (gather + search) on the same card tensors, and with itself."""
    cfg, st, leaf, q = torn_pool(f, b, b * f)
    n0, p0 = leaf_search.launches, leaf_search.launches_pool
    got = lookup_leaves(cfg, st, leaf, q)
    torch.cuda.synchronize()
    assert (leaf_search.launches, leaf_search.launches_pool) == (n0 + 1,
                                                                 p0 + 1)
    want = leaf_search_pool_ref(*pool_args(st, leaf, q))
    assert_same_bits(got, want)
    if b >= 300:
        found, cons = want[1], want[2]
        assert bool(found.any() and (~cons).any() and (cons & ~found).any())
    again = leaf_search_pool(*pool_args(st, leaf, q))
    torch.cuda.synchronize()
    assert leaf_search.launches == n0 + 2
    assert_same_bits(again, got)


def test_leaf_search_pool_empty_batch_launches_nothing():
    cfg, st, leaf, q = torn_pool(16, 0, 5)
    n0 = leaf_search.launches
    got = lookup_leaves(cfg, st, leaf, q)
    assert leaf_search.launches == n0
    assert [t.shape for t in got] == [(0,)] * 3


@pytest.mark.parametrize("break_arg", ["leaf_int64", "qkeys_int64",
                                       "leaf_on_cpu", "pool_on_cpu"])
def test_leaf_search_pool_raises_without_launching(break_arg):
    cfg, st, leaf, q = torn_pool(16, 64, 9)
    args = list(pool_args(st, leaf, q))
    if break_arg == "leaf_int64":
        args[1] = leaf.long()
    elif break_arg == "qkeys_int64":
        args[0] = q.long()
    elif break_arg == "leaf_on_cpu":
        args[1] = leaf.cpu()
    else:
        args[2] = st.keys.cpu()
    n0 = leaf_search.launches
    with pytest.raises((TypeError, ValueError)):
        leaf_search_pool(*args)
    assert leaf_search.launches == n0


# --------------------------------------------------------------------------
# flash attention
# --------------------------------------------------------------------------

# (B, H, KV, S, hd, causal, dtype, atol, rtol): the reference kernel
# test's shapes, two ragged ones, the models' widths, then the wgmma
# route's (bf16 at hd 64 and 128): causal and full, GQA groups 1, 3 and 4,
# ragged S (77, 300, 4097) and granite-3-8b's full prefill
FLASH_CASES = [(2, 4, 2, 256, 64, True, "float32", 2e-5, 2e-5),
               (1, 8, 8, 128, 128, False, "float32", 2e-5, 2e-5),
               (2, 2, 1, 512, 32, True, "float32", 2e-5, 2e-5),
               (1, 4, 4, 256, 64, True, "bfloat16", 3e-2, 3e-2),
               (3, 6, 2, 128, 64, False, "float32", 2e-5, 2e-5),
               (2, 4, 2, 77, 64, True, "float32", 2e-5, 2e-5),
               (1, 6, 3, 130, 16, False, "bfloat16", 3e-2, 3e-2),
               (1, 32, 8, 512, 128, True, "float32", 2e-5, 2e-5),
               (1, 32, 8, 512, 128, True, "bfloat16", 4e-3, 1e-2),
               (1, 9, 3, 300, 64, True, "float32", 2e-5, 2e-5),
               (1, 9, 3, 300, 64, True, "bfloat16", 4e-3, 1e-2),
               (1, 4, 4, 256, 64, False, "bfloat16", 4e-3, 1e-2),
               (2, 6, 2, 256, 64, True, "bfloat16", 4e-3, 1e-2),
               (2, 8, 2, 256, 128, True, "bfloat16", 4e-3, 1e-2),
               (1, 8, 2, 256, 128, False, "bfloat16", 4e-3, 1e-2),
               (2, 9, 3, 77, 64, True, "bfloat16", 4e-3, 1e-2),
               (1, 4, 1, 300, 128, False, "bfloat16", 4e-3, 1e-2),
               (1, 2, 2, 4097, 128, True, "bfloat16", 4e-3, 1e-2),
               (1, 3, 1, 4097, 64, False, "bfloat16", 4e-3, 1e-2),
               (4, 32, 8, 4096, 128, True, "bfloat16", 4e-3, 1e-2)]


def route_counts():
    return (flash_attention.launches, flash_attention.launches_wgmma,
            flash_attention.launches_fma)


def assert_launched(before, n, route):
    """The total and ``route``'s count moved by ``n``, the other not."""
    total, wgmma, fma = route_counts()
    assert total == before[0] + n
    assert wgmma == before[1] + (n if route == "wgmma" else 0)
    assert fma == before[2] + (n if route == "fma" else 0)


@pytest.mark.parametrize("b,h,kv,s,hd,causal,dtype,atol,rtol", FLASH_CASES)
def test_flash_attention_kernel_matches_plain_version(b, h, kv, s, hd, causal,
                                                      dtype, atol, rtol):
    rng = np.random.default_rng(b * s + hd)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(getattr(torch, dtype)).cuda()
               for shape in ((b, h, s, hd), (b, kv, s, hd), (b, kv, s, hd)))
    route = _route(q.dtype, hd)
    n0 = route_counts()
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert_launched(n0, 1, route)
    want = attention_ref(q, k, v, causal=causal)
    assert got.dtype == q.dtype
    close(got, want, atol, rtol)
    del want
    # the model layout, through strides
    qm, km, vm = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    got_m = flash_sdpa(qm, km, vm, causal=causal)
    assert_launched(n0, 2, route)
    assert torch.equal(got_m.transpose(1, 2), got)


@pytest.mark.parametrize("sq,sk,causal", [(128, 300, False),
                                          (300, 77, False),
                                          (77, 4097, False),
                                          (300, 130, True)])
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_attention_wgmma_route_sq_ne_sk(sq, sk, causal, hd):
    """Queries and keys of different lengths on the wgmma route (causal
    aligned as the reference's mask: row i sees keys j <= i)."""
    rng = np.random.default_rng(sq * sk + hd)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(torch.bfloat16).cuda()
               for shape in ((2, 6, sq, hd), (2, 2, sk, hd), (2, 2, sk, hd)))
    n0 = route_counts()
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert_launched(n0, 1, "wgmma")
    close(got, attention_ref(q, k, v, causal=causal), 4e-3, 1e-2)


# (B, H, KV, Sq, Sk, hd, causal, window): the sliding window on the FMA
# route, at every head dim in both dtypes (a window that clips, one at
# least S, window 1, Sq > Sk with rows that see no key, windowed full
# attention over Sq < Sk and Sq = Sk), and recurrentgemma's local
# attention (B 1 of 4, H 10, MQA, S 4096, hd 256, window 2048)
WINDOWED_CASES = [(2, 4, 1, 300, 300, hd, True, 64)
                  for hd in (16, 64, 128, 256)] + [
                 (1, 4, 2, 200, 200, 256, True, 512),
                 (2, 2, 1, 77, 77, 64, True, 1),
                 (1, 4, 2, 356, 100, 128, True, 96),
                 (1, 4, 2, 100, 356, 256, False, 96),
                 (1, 2, 2, 130, 130, 32, False, 17),
                 (1, 10, 1, 4096, 4096, 256, True, 2048)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kv,sq,sk,hd,causal,window", WINDOWED_CASES)
def test_flash_attention_window_matches_plain_version(
        b, h, kv, sq, sk, hd, causal, window, dtype):
    rng = np.random.default_rng(sq * sk + hd + window)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(getattr(torch, dtype)).cuda()
               for shape in ((b, h, sq, hd), (b, kv, sk, hd),
                             (b, kv, sk, hd)))
    kw = dict(causal=causal, window=window)
    assert _route(q.dtype, hd, window) == "fma"
    n0 = route_counts()
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert_launched(n0, 1, "fma")
    atol, rtol = (2e-5, 2e-5) if dtype == "float32" else (4e-3, 1e-2)
    close(got, attention_ref(q, k, v, **kw), atol, rtol)


@pytest.mark.parametrize("sq,sk,causal", [(1500, 1500, False),
                                          (4096, 1500, False)])
def test_flash_attention_whisper_shapes_on_the_wgmma_route(sq, sk, causal):
    rng = np.random.default_rng(sq + sk)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(torch.bfloat16).cuda()
               for shape in ((1, 16, sq, 64), (1, 16, sk, 64),
                             (1, 16, sk, 64)))
    n0 = route_counts()
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert_launched(n0, 1, "wgmma")
    close(got, attention_ref(q, k, v, causal=causal), 4e-3, 1e-2)


# --------------------------------------------------------------------------
# WKV6
# --------------------------------------------------------------------------

WKV_TOL = {"float32": 1e-4, "bfloat16": 0.15}
# the kernel's chunk boundaries: one step, a chunk less one, a chunk, a
# chunk and one, two chunks and a ragged tail
CHUNK_LENGTHS = (1, CHUNK - 1, CHUNK, CHUNK + 1, 2 * CHUNK + 3)


def wkv_inputs(seed, b, h, t, n, dtype):
    """r/k/v normal, w in [0.45, 0.95), u normal: the reference kernel
    test's generator, [B,H,T,N] on the card."""
    rng = np.random.default_rng(seed)
    host = [rng.standard_normal((b, h, t, n)) for _ in range(3)]
    host.append(rng.random((b, h, t, n)) * 0.5 + 0.45)
    host.append(rng.standard_normal((h, n)))
    return [torch.from_numpy(a.astype(np.float32)).to(getattr(torch, dtype))
            .cuda() for a in host]


@pytest.mark.parametrize("b,h,t,n,dtype", [
    (2, 3, 256, 32, "float32"), (1, 2, 128, 64, "float32"),
    (2, 1, 512, 16, "float32"), (1, 2, 128, 64, "bfloat16"),
    (2, 3, 77, 32, "float32"), (1, 2, 33, 64, "bfloat16"),
    (1, 32, 300, 64, "float32")]                   # rwkv6-1.6b widths
    + [(1, 6, t, 64, dtype) for t in CHUNK_LENGTHS
       for dtype in ("float32", "bfloat16")])
def test_wkv6_kernel_matches_plain_version(b, h, t, n, dtype):
    args = wkv_inputs(b * t + n, b, h, t, n, dtype)
    n0 = wkv6.launches
    got = wkv6(*args)
    want = wkv6_ref(*args)
    torch.cuda.synchronize()
    assert wkv6.launches == n0 + 1
    assert got.dtype == torch.float32
    close(got, want, WKV_TOL[dtype], WKV_TOL[dtype])
    # the model layout, through strides
    got_m = wkv6_seq(*(x.transpose(1, 2).contiguous() for x in args[:4]),
                     args[4])
    assert wkv6.launches == n0 + 2
    assert torch.equal(got_m.transpose(1, 2), got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_model_layout_views(dtype):
    """rwkv6-1.6b's width in the model layout: [B,T,H,N] tensors passed as
    transposed views (time stride H*N), as the forward does, against the
    plain version, and the same bits as the kernel layout."""
    b, t, h, n = 2, 2 * CHUNK + 5, 32, 64
    # [B,T,H,N] buffers (the generator's second and third dims swapped),
    # and u [H,N]
    r, k, v, w, u = wkv_inputs(t, b, t, h, n, dtype)
    u = u[:h]
    views = [x.transpose(1, 2) for x in (r, k, v, w)]
    assert views[0].stride(2) == h * n and not views[0].is_contiguous()
    n0 = wkv6.launches
    got = wkv6(*views, u)
    got_seq = wkv6_seq(r, k, v, w, u)
    torch.cuda.synchronize()
    assert wkv6.launches == n0 + 2
    close(got, wkv6_ref(*views, u), WKV_TOL[dtype], WKV_TOL[dtype])
    assert torch.equal(got_seq.transpose(1, 2), got)
    assert torch.equal(wkv6(*(x.contiguous() for x in views), u), got)


def test_wkv6_two_launches_give_the_same_bits():
    """The row groups' shares are summed in a fixed order, with no
    atomics."""
    args = wkv_inputs(3, 2, 32, 4 * CHUNK + 7, 64, "float32")
    first = wkv6(*args)
    second = wkv6(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# --------------------------------------------------------------------------
# the reduced models: card against CPU
# --------------------------------------------------------------------------

# the reduced models; recurrentgemma with 5 layers (reduced it has 2, so
# no super-block and no attention): one super-block and two tail blocks
MODEL_CASES = {"smollm_135m": {}, "granite_3_8b": {}, "rwkv6_1_6b": {},
               "qwen2_moe_a2_7b": {}, "llama4_scout_17b_a16e": {},
               "internvl2_1b": {}, "whisper_medium": {},
               "recurrentgemma_2b": {"n_layers": 5}}


def kernel_launches_a_forward(cfg):
    """(kernel, launches) of one forward: flash attention once a layer
    (Whisper: the encoder's, the decoder's causal and its cross
    attention; Griffin: once a super-block), WKV6 once a layer."""
    if cfg.family == "ssm":
        return wkv6, cfg.n_layers
    if cfg.family == "audio":
        return flash_attention, cfg.n_enc_layers + 2 * cfg.n_layers
    if cfg.family == "hybrid":
        return flash_attention, cfg.n_layers // 3
    return flash_attention, cfg.n_layers


@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_model_on_the_card_matches_cpu(name):
    """The same weights on the card (kernels) and on the CPU (plain
    versions) give the same logits within 1e-4 in f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(TC.get_reduced(name), **MODEL_CASES[name])
    cpu = TREG.build(cfg, device="cpu")
    model = cpu.init(torch.Generator().manual_seed(0))
    gpu = TREG.build(cfg, device="cuda")
    model_gpu = copy.deepcopy(model).to("cuda")
    batch = TREG.make_batch(cfg, 2, 40, torch.Generator().manual_seed(1),
                            "cpu")
    kernel, n = kernel_launches_a_forward(cfg)
    n0 = kernel.launches
    got = gpu.forward(model_gpu, {k: t.cuda() for k, t in batch.items()})
    assert kernel.launches == n0 + n
    close(got, cpu.forward(model, batch), 1e-4, 1e-4)


# --------------------------------------------------------------------------
# the cluster plane: card against CPU
# --------------------------------------------------------------------------

@pytest.mark.parametrize("system", ["sherman", "fg+"])
def test_cluster_run_on_the_card_matches_cpu(system):
    """One cluster run (8 CSs, private caches, stacked write waves) on the
    card, through the pool entry of the leaf search, equals the same run
    on the CPU: digests wave for wave, counters and the final tree."""
    from repro_torch.cluster import build_cluster, run_cluster
    from repro_torch.workloads import SYSTEMS, get_preset
    cfg = TT.TreeConfig(n_ms=4, nodes_per_ms=1024, fanout=16,
                        n_locks_per_ms=1024, max_height=7, n_cs=8)
    spec = get_preset("ycsb-a", load_records=4_000, ops=1_024, batch=256)
    runs = {}
    for dev in ("cuda", "cpu"):
        cl = build_cluster(SYSTEMS[system], cfg, n_clients=32,
                           records=spec.load_records, device=dev)
        cl.record_traces()
        n0 = leaf_search.launches_pool
        out = run_cluster(cl, spec, seed=1)
        runs[dev] = (cl, out, leaf_search.launches_pool - n0)
    (gpu, out_g, launches), (cpu, out_c, none) = runs["cuda"], runs["cpu"]
    assert launches > 0 and none == 0
    assert out_g == out_c
    assert gpu.trace_log == cpu.trace_log
    assert gpu.combined_counters() == cpu.combined_counters()
    assert gpu.conservation_ok()
    for a, b in zip(TT.state_to_numpy(gpu.state),
                    TT.state_to_numpy(cpu.state)):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# the chaos plane on the card == on the CPU
# --------------------------------------------------------------------------

CHAOS_CFG = dict(n_ms=2, nodes_per_ms=1024, fanout=8, n_locks_per_ms=512,
                 max_height=6, n_cs=4)


def chaos_runner(system, device, faults=(), ckpt=None, every=0):
    """tests/test_chaos.py's recipe (2,000 records, the 640-op chaos-mix
    spec) with 32 client threads, on ``device``."""
    from repro_torch.chaos import ChaosRunner
    from repro_torch.cluster import build_cluster
    from repro_torch.workloads import SYSTEMS
    from repro_torch.workloads.spec import WorkloadSpec
    spec = WorkloadSpec(name="chaos-mix", read=0.3, update=0.3, insert=0.2,
                        delete=0.1, rmw=0.1, load_records=2_000, ops=640,
                        batch=128, faults=tuple(faults))
    cl = build_cluster(SYSTEMS[system], TT.TreeConfig(**CHAOS_CFG),
                       n_clients=32, records=2_000, cache_bytes=4 << 20,
                       sync_rounds=2, device=device)
    cl.record_traces()
    return ChaosRunner(cl, spec, seed=1, ckpt_dir=ckpt, ckpt_every=every)


def assert_same_chaos_run(a, b):
    assert a.fault_log == b.fault_log
    assert a.samples == b.samples
    assert a.report() == b.report()
    assert a.op_counts == b.op_counts
    assert a.cluster.trace_log == b.cluster.trace_log
    assert a.cluster.combined_counters() == b.cluster.combined_counters()
    for x, y in zip(TT.state_to_numpy(a.cluster.state),
                    TT.state_to_numpy(b.cluster.state)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("system", ["sherman", "fg+"])
def test_chaos_run_on_the_card_matches_cpu(system, tmp_path):
    """A schedule of every kind (a memory-losing MS crash restored from
    its checkpoint and replayed, CS leave and cold rejoin, a hot-key storm
    and its lift) on the card equals the same run on the CPU: fault log,
    samples, report, digests wave for wave, counters and the final tree;
    the card's restored tree and repair queue stay on the card."""
    from repro_torch.chaos import schedule_for_horizon
    h = chaos_runner(system, "cpu").run().cluster.counters["sim_time_s"]
    sched = schedule_for_horizon(h, cs=1)
    runs = {}
    for dev in ("cuda", "cpu"):
        r = chaos_runner(system, dev, sched, ckpt=str(tmp_path / dev),
                         every=4)
        n0, p0 = leaf_search.launches, leaf_search.launches_pool
        r.run()
        runs[dev] = (r, leaf_search.launches - n0,
                     leaf_search.launches_pool - p0)
    (gpu, launches, pool), (cpu, none, _) = runs["cuda"], runs["cpu"]
    assert launches > 0 and pool == launches and none == 0
    assert_same_chaos_run(gpu, cpu)
    rep = gpu.report()
    assert rep["unfired_faults"] == 0 and rep["conservation_ok"]
    assert rep["glt_clean"]
    crash = [f for f in gpu.fault_log if f["kind"] == "ms_crash"]
    assert crash[0]["lose_memory"] and crash[0]["replayed_waves"] >= 1
    assert all(x.device.type == "cuda" for x in gpu.cluster.state)
    assert all(x.device.type == "cuda" for x in gpu.cluster.repair)


def test_chaos_cpu_snapshot_resumes_on_the_card(tmp_path):
    """A round-3 snapshot written by a CPU run resumes in a fresh runner
    on the card with the CPU run's digests, counters and final tree."""
    whole = chaos_runner("sherman", "cpu").run()
    part = chaos_runner("sherman", "cpu", ckpt=str(tmp_path), every=3)
    part.run(until_round=3)
    n_dig = len(part.cluster.trace_log)
    card = chaos_runner("sherman", "cuda", ckpt=str(tmp_path))
    assert card.load_latest() == 3
    assert all(x.device.type == "cuda" for x in card.cluster.state)
    card.cluster.record_traces()
    card.run()
    assert card.cluster.trace_log == whole.cluster.trace_log[n_dig:]
    assert card.cluster.counters == whole.cluster.counters
    assert card.report() == whole.report()
    for x, y in zip(TT.state_to_numpy(card.cluster.state),
                    TT.state_to_numpy(whole.cluster.state)):
        np.testing.assert_array_equal(x, y)


# --------------------------------------------------------------------------
# the mesh-sharded index: gloo ranks on the card == the same ranks on CPU
# --------------------------------------------------------------------------

def _same_rank_result(got, want, what):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), what
        for k in want:
            _same_rank_result(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _same_rank_result(g, w, f"{what}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype, what
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        assert got == want, what


def test_sharded_mesh_on_the_card_matches_cpu():
    """Mesh (2, 4): 8 gloo ranks on the card (each lookup's probe through
    the leaf-search kernel) give what the same 8 ranks give on the CPU:
    every lookup case and every pjit wave of tests/test_torch_sharded.py,
    rank by rank, bit for bit."""
    import torch_sharded_common as C
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import run_mesh
    build.build_all(["leaf_search"])    # once here, not in every rank
    cfg = TT.TreeConfig(**C.CFG_KW)
    keys, vals, wk, wv = C.draw_records()
    st = TT.bulkload(cfg, keys, vals, device="cpu")
    base = dict(zip(TT.TreeState._fields, TT.state_to_numpy(st)))
    states, lookups, waves = C.make_cases(base, keys, vals, wk, wv)
    args = (states, lookups, waves, (), False)
    card = run_mesh(C.sharded_rank, 2, 4, backend="gloo", args=args,
                    timeout=600)
    cpu = run_mesh(C.sharded_rank, 2, 4, backend="gloo", device="cpu",
                   args=args, timeout=600)
    for rank, (g, c) in enumerate(zip(card, cpu)):
        assert g["launches"] == len(lookups) and c["launches"] == 0
        for part in ("lookup", "wave", "coords"):
            _same_rank_result(g[part], c[part], f"rank {rank} {part}")
