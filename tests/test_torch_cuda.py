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
f32 and 0.15 in bf16; the reduced models (every family) 1e-4 in f32.
The backward kernels: attention's 2e-5 in f32 and 4e-2 absolute plus
2e-2 relative in bf16, WKV6's each gradient within 1e-4 · max(1,
max|g|); one train step of every reduced family 1e-4 in f32.  AdamW's
update kernel bit for bit the plain loop's for the same norm; its norm
within 1e-6 relative of an f64 sum."""
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
    np.testing.assert_allclose(got.detach().float().cpu().numpy(),
                               want.detach().float().cpu().numpy(),
                               atol=atol, rtol=rtol)


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
# route's (bf16 at hd 64, 128 and 256): causal and full, GQA groups 1, 3
# and 4, ragged S (77, 300, 4097) and granite-3-8b's full prefill
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
               (1, 4, 4, 300, 256, True, "bfloat16", 4e-3, 1e-2),
               (1, 4, 4, 300, 256, False, "bfloat16", 4e-3, 1e-2),
               (2, 6, 2, 256, 256, True, "bfloat16", 4e-3, 1e-2),
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
@pytest.mark.parametrize("hd", [64, 128, 256])
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


# (B, H, KV, Sq, Sk, hd, causal, window): the sliding window at every
# head dim in both dtypes (bf16 at hd 64, 128 and 256 on the wgmma route,
# the rest on the FMA route): a window that clips, one at least S, window
# 1, Sq > Sk with rows that see no key, windowed full attention over
# Sq < Sk and Sq = Sk, window edges inside the wgmma route's 64-key (hd
# 256) and 128-key tiles, and recurrentgemma's local attention (B 1 of 4,
# H 10, MQA, S 4096, hd 256, window 2048)
WINDOWED_CASES = [(2, 4, 1, 300, 300, hd, True, 64)
                  for hd in (16, 64, 128, 256)] + [
                 (1, 4, 2, 200, 200, 256, True, 512),
                 (2, 2, 1, 77, 77, 64, True, 1),
                 (1, 4, 2, 356, 100, 128, True, 96),
                 (1, 4, 2, 356, 100, 256, True, 96),
                 (1, 4, 2, 100, 356, 256, False, 96),
                 (1, 2, 2, 130, 130, 32, False, 17),
                 (1, 4, 2, 200, 200, 256, True, 65),
                 (1, 4, 2, 200, 200, 128, True, 129),
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
    route = _route(q.dtype, hd, window)
    assert route == ("wgmma" if dtype == "bfloat16" and hd >= 64 else "fma")
    n0 = route_counts()
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert_launched(n0, 1, route)
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


# --------------------------------------------------------------------------
# the backward kernels and the training step: card against CPU
# --------------------------------------------------------------------------

# (B, H, KV, Sq, Sk, hd, causal, window, dtype): f32 at 2e-5, bf16 at 4e-2
# absolute plus 2e-2 relative (both sides round dq, dk, dv to bf16; the
# kernel's D = dO.o reads the forward's bf16 o, and the wgmma route rounds
# P and dS to bf16 for the tensor cores).  bf16 at hd 64, 128 and 256
# takes the wgmma route: causal and full, GQA groups 1, 2, 3, 4 and 10,
# ragged Sq and Sk with Sq != Sk both ways, window edges inside a tile, and
# rows that see no key (Sq 300 > Sk 100 + window 40; at hd 256 also Sq 200
# > Sk 120 + window 64, the seventh case)
BWD_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (4e-2, 2e-2)}
FLASH_BWD_CASES = [(2, 4, 2, 64, 64, 64, True, 0, "float32"),
                   (1, 2, 1, 100, 37, 16, False, 0, "float32"),
                   (1, 4, 1, 300, 100, 128, True, 40, "float32"),
                   (1, 2, 2, 130, 130, 256, True, 17, "float32"),
                   (2, 4, 2, 77, 200, 32, False, 0, "float32"),
                   (2, 4, 2, 256, 256, 64, True, 0, "bfloat16"),
                   (1, 2, 1, 200, 120, 256, True, 64, "bfloat16"),
                   (1, 6, 3, 130, 130, 16, False, 0, "bfloat16"),
                   (1, 3, 3, 77, 77, 64, False, 0, "bfloat16"),
                   (2, 9, 3, 300, 300, 64, True, 0, "bfloat16"),
                   (1, 8, 2, 190, 333, 128, True, 0, "bfloat16"),
                   (1, 4, 1, 333, 190, 128, False, 0, "bfloat16"),
                   (1, 6, 2, 260, 260, 64, True, 100, "bfloat16"),
                   (1, 2, 1, 150, 200, 64, False, 50, "bfloat16"),
                   (1, 4, 1, 300, 100, 64, True, 40, "bfloat16"),
                   (1, 4, 4, 300, 100, 128, True, 40, "bfloat16"),
                   (1, 4, 2, 190, 333, 256, True, 0, "bfloat16"),
                   (1, 3, 1, 333, 190, 256, False, 0, "bfloat16"),
                   (2, 10, 1, 300, 300, 256, True, 100, "bfloat16"),
                   (1, 6, 2, 130, 130, 256, False, 33, "bfloat16"),
                   (1, 4, 4, 300, 100, 256, True, 40, "bfloat16")]


def bwd_route_counts(flash_attention_bwd):
    return (flash_attention_bwd.launches, flash_attention_bwd.launches_wgmma,
            flash_attention_bwd.launches_fma)


@pytest.mark.parametrize("b,h,kv,sq,sk,hd,causal,window,dtype",
                         FLASH_BWD_CASES)
def test_flash_attention_bwd_kernel_matches_plain_version(
        b, h, kv, sq, sk, hd, causal, window, dtype):
    """Each route's kernels against the plain version's autograd, the
    same bits on a rerun, the call counted on its route; on the wgmma
    route the forward's lse against attention_lse_ref (1e-4 absolute plus
    1e-5 relative: f32 sums of ex2.approx terms in another order)."""
    from repro_torch.kernels.flash_attention.kernel import (
        _bwd_route, flash_attention_bwd)
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                         attention_lse_ref)
    rng = np.random.default_rng(sq * 31 + sk + hd)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(getattr(torch, dtype)).cuda()
        for s in ((b, h, sq, hd), (b, kv, sk, hd), (b, kv, sk, hd),
                  (b, h, sq, hd)))
    kw = dict(causal=causal, window=window)
    route = _bwd_route(q.dtype, hd, window)
    lse = None
    if route == "wgmma":
        lse = torch.empty((b, h, sq), dtype=torch.float32, device="cuda")
    o = flash_attention(q, k, v, lse=lse, **kw)
    n0 = bwd_route_counts(flash_attention_bwd)
    got = flash_attention_bwd(q, k, v, o, do, lse=lse, **kw)
    again = flash_attention_bwd(q, k, v, o, do, lse=lse, **kw)
    want = attention_bwd_ref(q, k, v, do, **kw)
    torch.cuda.synchronize()
    assert bwd_route_counts(flash_attention_bwd) == (
        n0[0] + 2, n0[1] + 2 * (route == "wgmma"),
        n0[2] + 2 * (route == "fma"))
    assert route == ("wgmma" if dtype == "bfloat16"
                     and hd in (64, 128, 256) else "fma")
    for g, a, w in zip(got, again, want):
        assert g.dtype == q.dtype
        assert torch.equal(g, a)                  # no atomics
        close(g, w, *BWD_TOL[dtype])
    if lse is not None:
        close(lse, attention_lse_ref(q, k, **kw), 1e-4, 1e-5)


def test_flash_attention_autograd_runs_the_backward_kernel():
    """Through the model layout's autograd Function: one forward and one
    backward launch, the plain version's gradients on the CPU."""
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_bwd
    rng = np.random.default_rng(4)
    host = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((2, 50, 6, 64), (2, 50, 2, 64), (2, 50, 2, 64),
                      (2, 50, 6, 64))]
    grads = {}
    for dev in ("cpu", "cuda"):
        leaves = [x.detach().clone().to(dev).requires_grad_(True)
                  for x in host[:3]]
        n0 = (flash_attention.launches, flash_attention_bwd.launches)
        out = flash_sdpa(*leaves, causal=True)
        (out * host[3].to(dev)).sum().backward()
        n1 = (flash_attention.launches, flash_attention_bwd.launches)
        assert n1 == ((n0[0] + 1, n0[1] + 1) if dev == "cuda" else n0)
        grads[dev] = [x.grad.cpu() for x in leaves]
    for g, w in zip(grads["cuda"], grads["cpu"]):
        close(g, w, 2e-5, 2e-5)


def test_flash_attention_autograd_runs_the_wgmma_backward_kernels():
    """bf16 at hd 64 through the model layout's autograd Function: one
    forward launch (writing the lse) and one backward launch on the wgmma
    route, against the plain version's autograd on the CPU in f32 at the
    bf16 tolerance."""
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_bwd
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    rng = np.random.default_rng(5)
    host = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(torch.bfloat16)
            for s in ((2, 150, 6, 64), (2, 150, 2, 64), (2, 150, 2, 64),
                      (2, 150, 6, 64))]
    leaves = [x.cuda().requires_grad_(True) for x in host[:3]]
    n0 = (route_counts(), bwd_route_counts(flash_attention_bwd))
    out = flash_sdpa(*leaves, causal=True)
    (out.float() * host[3].cuda().float()).sum().backward()
    torch.cuda.synchronize()
    f0, b0 = n0
    assert route_counts() == (f0[0] + 1, f0[1] + 1, f0[2])
    assert bwd_route_counts(flash_attention_bwd) == (b0[0] + 1, b0[1] + 1,
                                                     b0[2])
    t = lambda x: x.transpose(1, 2)
    want = attention_bwd_ref(*(t(x.float()) for x in host[:3]),
                             t(host[3].float()), causal=True)
    for x, w in zip(leaves, want):
        assert x.grad.dtype == torch.bfloat16
        close(t(x.grad), w, *BWD_TOL["bfloat16"])


@pytest.mark.parametrize("b,h,t,n,small_w", [
    (2, 3, 1, 16, False), (2, 3, 15, 16, False), (1, 2, 17, 32, False),
    (2, 2, 40, 64, False), (1, 32, 67, 64, False),
    # every head size past two 16-step checkpoints, and decays in
    # [0, 0.05) with exact zeros
    (2, 3, 40, 16, False), (1, 2, 50, 32, False), (2, 4, 70, 64, True)])
def test_wkv6_bwd_kernel_matches_plain_version(b, h, t, n, small_w):
    """Each gradient within 1e-4 · max(1, max|g|) (f32 sums in other
    orders); a rerun gives the same bits."""
    from repro_torch.kernels.rwkv_scan.kernel import wkv6_bwd
    from repro_torch.kernels.rwkv_scan.ref import wkv6_bwd_ref
    args = wkv_inputs(b * t + n, b, h, t, n, "float32")
    if small_w:
        rng = np.random.default_rng(t)
        w = rng.random((b, h, t, n)) * 0.05
        w[rng.random(w.shape) < 0.1] = 0.0
        args[3] = torch.from_numpy(w.astype(np.float32)).cuda()
    do = torch.from_numpy(np.random.default_rng(t).standard_normal(
        (b, h, t, n)).astype(np.float32)).cuda()
    n0 = wkv6_bwd.launches
    got = wkv6_bwd(*args, do)
    again = wkv6_bwd(*args, do)
    want = wkv6_bwd_ref(*args, do)
    torch.cuda.synchronize()
    assert wkv6_bwd.launches == n0 + 2
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        close(g, w, 1e-4 * max(1.0, float(w.abs().max())), 0.0)


def test_wkv6_backward_copies_an_expanded_gradient():
    """``sum().backward()`` gives the model-layout WKV6 an expanded dO (stride
    0), which TMA cannot read: the backward copies it and still launches
    the kernel, matching the plain version on an all-ones dO."""
    from repro_torch.kernels.rwkv_scan.kernel import wkv6_bwd
    from repro_torch.kernels.rwkv_scan.ops import wkv6_seq
    from repro_torch.kernels.rwkv_scan.ref import wkv6_bwd_ref
    args = wkv_inputs(11, 2, 3, 40, 64, "float32")
    leaves = [x.transpose(1, 2).contiguous().requires_grad_(True)
              for x in args[:4]]
    leaves.append(args[4].clone().requires_grad_(True))
    n0 = wkv6_bwd.launches
    wkv6_seq(*leaves).sum().backward()
    torch.cuda.synchronize()
    assert wkv6_bwd.launches == n0 + 1
    want = wkv6_bwd_ref(*args, torch.ones_like(args[0]))
    got = [x.grad.transpose(1, 2) for x in leaves[:4]] + [leaves[4].grad]
    for g, w in zip(got, want):
        close(g, w, 1e-4 * max(1.0, float(w.abs().max())), 0.0)


def test_wkv6_bwd_takes_only_f32():
    from repro_torch.kernels.rwkv_scan.kernel import wkv6_bwd
    args = wkv_inputs(1, 1, 2, 8, 16, "bfloat16")
    with pytest.raises(TypeError, match="float32"):
        wkv6_bwd(*args, args[0].float())


@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_train_step_on_the_card_matches_cpu(name):
    """One ``make_train_step`` (loss, backward through the kernels' backward
    kernels, AdamW) on the card == the CPU's within 1e-4 in f32: the
    metrics and every parameter after the update."""
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.common import flat_params
    from repro_torch.optim import adamw
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(TC.get_reduced(name), **MODEL_CASES[name])
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    cpu = TREG.build(cfg, device="cpu")
    model = cpu.init(torch.Generator().manual_seed(0))
    gpu = TREG.build(cfg, device="cuda")
    model_gpu = copy.deepcopy(model).to("cuda")
    batch = TREG.make_batch(cfg, 2, 24, torch.Generator().manual_seed(1),
                            "cpu")
    out = {}
    for dev, api, m in (("cuda", gpu, model_gpu), ("cpu", cpu, model)):
        params = flat_params(api.param_tree(m))
        _, _, metrics = make_train_step(api, opt)(
            m, adamw.init(params), {k: t.to(dev) for k, t in batch.items()})
        out[dev] = (metrics, params)
    for k in ("loss", "grad_norm", "lr"):
        close(out["cuda"][0][k], out["cpu"][0][k], 1e-4, 1e-4)
    for g, c in zip(out["cuda"][1], out["cpu"][1]):
        close(g.detach(), c.detach(), 1e-4, 1e-4)


# --------------------------------------------------------------------------
# the head and its f32 loss: the kernel against its plain version
# --------------------------------------------------------------------------

# (loss rows, vocab, width, dtype): internvl2-1b's and rwkv6-1.6b's
# training shapes (4 × 4,095 loss rows), and small odd vocabularies
HEAD_LOSS_CASES = [(16380, 151655, 896, "bfloat16"),
                   (16380, 65536, 2048, "bfloat16"),
                   (300, 509, 64, "bfloat16"), (300, 509, 64, "float32")]


def head_buffer(n, v, d, dtype, seed=0):
    """The logits buffer the training path makes (h @ the padded head),
    logits of about unit spread, with a label at V − 1."""
    from repro_torch.kernels.head_loss.ops import pad_vocab
    g = torch.Generator(device="cuda").manual_seed(seed)
    h = torch.randn(n, d, generator=g, device="cuda").to(dtype)
    w = (torch.randn(v, d, generator=g, device="cuda") / d ** 0.5).to(dtype)
    buf = h @ pad_vocab(w).T
    labels = torch.randint(0, v, (n,), generator=g, device="cuda")
    labels[0] = v - 1
    scale = torch.full((n,), 1.0 / n, device="cuda")
    return buf, labels, scale


def within_one_ulp(got, want):
    """bf16: the same bits or the next value either way; f32: 1e-5
    relative to the largest entry."""
    if got.dtype == torch.float32:
        close(got, want, 1e-5 * float(want.abs().max()), 0)
        return
    off = (got.view(torch.int16).int() - want.view(torch.int16).int()).abs()
    assert bool(((off <= 1) | (got == want)).all()), int(off.max())


@pytest.mark.parametrize("n,v,d,dtype", HEAD_LOSS_CASES)
def test_head_loss_kernel_matches_plain_version(n, v, d, dtype):
    """One launch: each row's nll within 1e-5 relative of the plain
    version's, the mean too, and the logits' gradient written in place
    within one bf16 ulp, the pad columns 0."""
    from repro_torch.kernels.head_loss.kernel import loss_rows
    from repro_torch.kernels.head_loss.ref import loss_rows_ref
    buf, labels, scale = head_buffer(n, v, d, getattr(torch, dtype))
    want_buf = buf.clone()
    chunk = 1024
    want = torch.cat([loss_rows_ref(want_buf[i:i + chunk], v,
                                    labels[i:i + chunk], scale[i:i + chunk])
                      for i in range(0, n, chunk)])
    n0 = loss_rows.launches
    got = loss_rows(buf, v, labels, scale)
    torch.cuda.synchronize()
    assert loss_rows.launches == n0 + 1
    close(got, want, 0, 1e-5)
    assert abs(got.mean().item() - want.mean().item()) <= \
        1e-5 * abs(want.mean().item())
    for i in range(0, n, chunk):
        within_one_ulp(buf[i:i + chunk], want_buf[i:i + chunk])
    assert bool((buf[:, v:] == 0).all())


def test_head_loss_kernel_without_a_gradient_only_reads():
    from repro_torch.kernels.head_loss.kernel import loss_rows
    from repro_torch.kernels.head_loss.ref import loss_rows_ref
    buf, labels, scale = head_buffer(300, 509, 64, torch.bfloat16)
    before = buf.clone()
    got = loss_rows(buf, 509, labels, scale, write_grad=False)
    want = loss_rows_ref(before.clone(), 509, labels, scale)
    torch.cuda.synchronize()
    assert torch.equal(buf, before)
    close(got, want, 0, 1e-5)


@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_head_loss_one_launch_a_training_step(name):
    """One ``make_train_step`` of every reduced family in bf16, at an odd
    vocabulary, launches the loss kernel exactly once."""
    from repro_torch.kernels.head_loss.kernel import loss_rows
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.common import flat_params
    from repro_torch.optim import adamw
    cfg = dataclasses.replace(TC.get_reduced(name), **MODEL_CASES[name],
                              dtype=torch.bfloat16, vocab=509)
    api = TREG.build(cfg, device="cuda")
    model = api.init(torch.Generator(device="cuda").manual_seed(0))
    batch = TREG.make_batch(cfg, 2, 24, torch.Generator().manual_seed(1),
                            "cuda")
    step = make_train_step(api, adamw.AdamWConfig())
    state = adamw.init(flat_params(api.param_tree(model)))
    n0 = loss_rows.launches
    _, _, metrics = step(model, state, batch)
    assert loss_rows.launches == n0 + 1
    assert torch.isfinite(metrics["loss"])


def test_head_loss_makes_no_f32_logits():
    """At a shape where an f32 [N, V] tensor would set the peak (3.28 GB
    against the 1.64 GB bf16 buffer), the fused forward and backward stay
    under three quarters of it above what their inputs hold."""
    from repro_torch.kernels.head_loss.ops import head_loss
    n, v, d = 8192, 100_003, 256
    g = torch.Generator(device="cuda").manual_seed(0)
    h = torch.randn(n, d, generator=g, device="cuda").to(
        torch.bfloat16).requires_grad_()
    w = (torch.randn(v, d, generator=g, device="cuda") / 16).to(
        torch.bfloat16).requires_grad_()
    labels = torch.randint(0, v, (n,), generator=g, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    head_loss(h, w, labels).backward()
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    f32_logits = 4 * n * v
    assert 2 * n * v <= extra < 0.75 * f32_logits, extra


# --------------------------------------------------------------------------
# the grouped expert product (kernels/moe_gmm): bf16 within 1e-2 of each
# result's largest magnitude (one bf16 rounding of an f32 sum, whose terms
# the kernel and the f32 plain version add in another order); 0 exactly
# past the groups and for an empty group; the same bits on every call
# --------------------------------------------------------------------------

def gmm_inputs(counts, k, n, seed=0, extra=7):
    """Rows sorted by group (``counts`` each, then ``extra`` rows past the
    groups), a [M, K] and w [G, K, N] in bf16, the groups' ends."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    m = sum(counts) + extra
    a = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
    w = (torch.randn(len(counts), k, n, generator=g, device="cuda")
         / k ** 0.5).to(torch.bfloat16)
    ends = torch.tensor(counts, device="cuda").cumsum(0).to(torch.int32)
    return a, w, ends


GMM_CASES = {
    "uneven": ([300, 5, 1, 129, 128, 700], 256, 192),
    "empty": ([0, 64, 0, 0, 200, 0], 128, 128),
    "odd_widths": ([17, 250, 3], 136, 88),
    "cell": ([1092] * 15, 2048, 1408),
}


def rel_close(got, want, rtol=1e-2):
    scale = want.abs().max().clamp(min=1e-30)
    assert float((got.float() - want.float()).abs().max() / scale) <= rtol


@pytest.mark.parametrize("case", list(GMM_CASES))
def test_moe_gmm_kernel_matches_plain_version(case):
    from repro_torch.kernels.moe_gmm.kernel import gmm, gmm_dw
    from repro_torch.kernels.moe_gmm.ref import gmm_dw_ref, gmm_ref
    counts, k, n = GMM_CASES[case]
    a, w, ends = gmm_inputs(counts, k, n)
    n0 = gmm.launches
    got = gmm(a, w, ends)
    want = gmm_ref(a.float(), w.float(), ends)
    assert gmm.launches == n0 + 1 and got.dtype == torch.bfloat16
    rel_close(got, want)
    assert bool((got[int(ends[-1]):] == 0).all())
    # the rows' gradient: the same kernel on the transposed weights
    d = torch.randn(a.shape[0], n, device="cuda").to(torch.bfloat16)
    got_dx = gmm(d, w.transpose(1, 2), ends)
    rel_close(got_dx, gmm_ref(d.float(), w.float().transpose(1, 2), ends))
    got_dw = gmm_dw(a, d, ends)
    want_dw = gmm_dw_ref(a.float(), d.float(), ends)
    rel_close(got_dw, want_dw)
    for i, c in enumerate(counts):
        if c == 0:
            assert bool((got_dw[i] == 0).all())
    torch.cuda.synchronize()
    assert torch.equal(gmm(a, w, ends), got)
    assert torch.equal(gmm_dw(a, d, ends), got_dw)


def test_moe_gmm_autograd_matches_the_plain_version():
    from repro_torch.kernels.moe_gmm.ops import grouped_mm
    counts, k, n = GMM_CASES["uneven"]
    a, w, ends = gmm_inputs(counts, k, n, seed=3)
    d = torch.randn(a.shape[0], n, device="cuda").to(torch.bfloat16)
    a1, w1 = a.clone().requires_grad_(), w.clone().requires_grad_()
    (grouped_mm(a1, w1, ends) * d).sum().backward()
    a2 = a.float().cpu().requires_grad_()
    w2 = w.float().cpu().requires_grad_()
    (grouped_mm(a2, w2, ends.cpu())
     * d.float().cpu()).sum().backward()
    rel_close(a1.grad.cpu(), a2.grad)
    rel_close(w1.grad.cpu(), w2.grad)
    assert bool((a1.grad[int(ends[-1]):] == 0).all())


def test_moe_gmm_takes_only_bf16_on_the_card():
    from repro_torch.kernels.moe_gmm.kernel import gmm
    a, w, ends = gmm_inputs([4, 4], 64, 64)
    with pytest.raises(ValueError):
        gmm(a.float(), w.float(), ends)
    with pytest.raises(ValueError):
        gmm(a, w, ends.long())


def published_moe_small(**over):
    return dataclasses.replace(
        TC.get("qwen1.5-moe-a2.7b"), n_layers=2, d_model=256, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=509, n_experts=16, top_k=4,
        shared_expert_ff=256, ep_size=4, ep_rank=0, **over)


def test_moe_dropless_layer_never_syncs_with_the_host():
    """A dropless layer's forward and backward on the card under
    ``torch.cuda.set_sync_debug_mode("error")``: no ``.item()``, no host
    read of a size; 3 grouped products forward and 6 backward."""
    from repro_torch.kernels.moe_gmm.kernel import gmm, gmm_dw
    from repro_torch.models import moe as M
    cfg = published_moe_small()
    api = TREG.build(cfg, device="cuda")
    model = api.init(torch.Generator(device="cuda").manual_seed(0))
    x = torch.randn(2, 64, cfg.d_model, device="cuda").to(
        torch.bfloat16).requires_grad_()
    moe = model.layers[0].moe
    n0, d0 = gmm.launches, gmm_dw.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with M.counting():
            out = M.moe_ffn(moe, x, cfg)
        out.float().square().sum().backward()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (gmm.launches - n0, gmm_dw.launches - d0) == (6, 3)
    assert torch.isfinite(x.grad.float()).all()
    c = M.read_counters([moe])[0]
    assert c["dropped"] == 0 and 0 < c["largest"] <= c["kept"] <= 2 * 64 * 4


def test_moe_published_train_step_on_the_card_matches_cpu():
    """One bf16 step of the small published model on the card against the
    same step on the CPU (the plain grouped product there): the loss
    within 2e-2 (bf16 activations, routed alike but for near ties), and
    the grouped kernels launched 12 times a layer (3 forward, 3 in the
    remat's replay, 6 backward)."""
    from repro_torch.kernels.moe_gmm.kernel import gmm, gmm_dw
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.common import flat_params
    from repro_torch.optim import adamw
    cfg = published_moe_small()
    losses = {}
    for dev in ("cpu", "cuda"):
        api = TREG.build(cfg, device=dev)
        model = api.init(torch.Generator().manual_seed(0))
        batch = TREG.make_batch(cfg, 2, 64, torch.Generator().manual_seed(1),
                                dev)
        step = make_train_step(api, adamw.AdamWConfig())
        state = adamw.init(flat_params(api.param_tree(model)))
        n0 = gmm.launches + gmm_dw.launches
        _, _, met = step(model, state, batch)
        losses[dev] = float(met["loss"])
        if dev == "cuda":
            assert gmm.launches + gmm_dw.launches - n0 == 12 * cfg.n_layers
    assert abs(losses["cuda"] - losses["cpu"]) <= 2e-2 * abs(losses["cpu"])


# --------------------------------------------------------------------------
# AdamW and its gradient norm (kernels/adamw): the update's weights and
# moments bit for bit the plain loop's for the same norm (the kernel's f32
# arithmetic is the loop's, op for op, with no contraction); the norm
# within 1e-6 relative of an f64 sum (the kernel sums in f64, then rounds
# once to f32) and the same bits on every call
# --------------------------------------------------------------------------

#: (shape, weight dtype, gradient: "same" | "f32" | None | "strided",
#:  weight and moments laid out: "plain" | "unaligned")
ADAMW_LEAVES = [((), "bfloat16", "same", "plain"),
                ((7,), "bfloat16", "same", "plain"),
                ((3, 5), "float32", "same", "plain"),
                ((1000,), "bfloat16", None, "plain"),
                ((65536,), "bfloat16", "same", "plain"),
                ((65537,), "float32", "same", "plain"),
                ((2048, 33), "bfloat16", "strided", "plain"),
                ((4099,), "bfloat16", "same", "unaligned"),
                ((129,), "float32", "f32", "unaligned"),
                ((64, 40), "bfloat16", "strided", "plain"),
                ((96, 130), "float32", "strided", "plain"),
                ((2 ** 28 + 3,), "bfloat16", "same", "plain")]


def _laid_out(x, layout):
    """``x`` as a tensor of its values laid out as asked: itself; a view
    one element past a 16-byte boundary; a transposed slice of a wider
    tensor."""
    if layout == "plain":
        return x
    if layout == "unaligned":
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        out = buf[1:].view(x.shape)
        out.copy_(x)
        return out
    wide = torch.zeros((x.shape[1], x.shape[0] + 3), dtype=x.dtype,
                       device=x.device)
    out = wide[:, 1:1 + x.shape[0]].T
    out.copy_(x)
    assert not out.is_contiguous()
    return out


def adamw_leaves(seed, grad_scale=1.0, cases=ADAMW_LEAVES):
    """``(grads, ms, vs, params)`` on the card: random weights and
    gradients, m of both signs, v > 0, laid out as ``cases`` say."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    grads, ms, vs, params = [], [], [], []
    for shape, dtype, grad, layout in cases:
        rnd = lambda: torch.randn(shape, generator=g, device="cuda")
        p = rnd().to(getattr(torch, dtype))
        m, v = rnd() * 1e-3, rnd().square() * 1e-5
        params.append(_laid_out(p, layout))
        ms.append(_laid_out(m, layout))
        vs.append(_laid_out(v, layout))
        if grad is None:
            grads.append(None)
            continue
        x = (rnd() * grad_scale).to(
            torch.float32 if grad == "f32" else p.dtype)
        grads.append(_laid_out(x, "strided" if grad == "strided"
                               else "plain"))
    return grads, ms, vs, params


def adamw_scalars(cfg, step0, gn):
    """lr, the clip factor and the bias corrections as ``_update`` makes
    them, at step ``step0 + 1``."""
    from repro_torch.optim import adamw
    step = torch.tensor(step0 + 1, dtype=torch.int32, device="cuda")
    stepf = step.float()
    return (adamw.schedule(cfg, step),
            torch.clamp(cfg.clip_norm / (gn + 1e-9), max=1.0),
            1 - cfg.b1 ** stepf, 1 - cfg.b2 ** stepf)


def same_bits(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    a = got.contiguous().view(ints[got.dtype])
    b = want.contiguous().view(ints[want.dtype])
    assert torch.equal(a, b), int((a != b).sum())


@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("step0", [0, 6])          # steps 1 and 7
def test_adamw_update_kernel_matches_the_loop_bit_for_bit(step0, clip):
    """The whole leaf list in one update launch (the 0-d leaf, odd
    lengths, chunk edges, unaligned views, non-contiguous gradients, None
    gradients, bf16 and f32 weights, one leaf of over 2^28
    elements) against ``update_ref`` on the same tensors' copies, with the
    same scalars: every weight, m and v the same bits."""
    from repro_torch.kernels.adamw import kernel as K
    from repro_torch.kernels.adamw.ref import update_ref
    from repro_torch.optim import adamw
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=3, total_steps=20,
                            clip_norm=1.0 if clip else 1e30)
    grads, ms, vs, params = adamw_leaves(step0 + 10 * clip, 4.0)
    copy = lambda xs: [None if x is None else x.clone() for x in xs]
    want = [copy(xs) for xs in (grads, ms, vs, params)]
    gn = K.sumsq(grads)
    lr, scale, bc1, bc2 = adamw_scalars(cfg, step0, gn)
    assert (float(scale) < 1.0) == clip
    n0, c0 = K.update.launches, K.update.copied
    K.update(grads, ms, vs, params, lr, scale, bc1, bc2, b1=cfg.b1,
             b2=cfg.b2, eps=cfg.eps, weight_decay=cfg.weight_decay)
    update_ref(*want, lr, scale, bc1, bc2, cfg.b1, cfg.b2, cfg.eps,
               cfg.weight_decay)
    torch.cuda.synchronize()
    assert K.update.launches == n0 + 1
    # the three strided gradients
    assert K.update.copied == c0 + 3
    for got, ref in zip(ms + vs + params, want[1] + want[2] + want[3]):
        same_bits(got, ref)


def test_adamw_update_kernel_over_the_table_splits():
    """1,500 leaves (more than two tables of 640): three update launches,
    the same bits as the loop's."""
    from repro_torch.kernels.adamw import kernel as K
    from repro_torch.kernels.adamw.ref import update_ref
    from repro_torch.optim import adamw
    rng = np.random.default_rng(0)
    cases = [((int(n),), "bfloat16", "same", "plain")
             for n in rng.integers(1, 3000, 1500)]
    cfg = adamw.AdamWConfig()
    grads, ms, vs, params = adamw_leaves(1, 1.0, cases)
    want = [[x.clone() for x in xs] for xs in (grads, ms, vs, params)]
    lr, scale, bc1, bc2 = adamw_scalars(cfg, 2, K.sumsq(grads))
    n0 = K.update.launches
    K.update(grads, ms, vs, params, lr, scale, bc1, bc2, b1=cfg.b1,
             b2=cfg.b2, eps=cfg.eps, weight_decay=cfg.weight_decay)
    update_ref(*want, lr, scale, bc1, bc2, cfg.b1, cfg.b2, cfg.eps,
               cfg.weight_decay)
    torch.cuda.synchronize()
    assert K.update.launches == n0 + 3
    for got, ref in zip(ms + vs + params, want[1] + want[2] + want[3]):
        same_bits(got, ref)


@pytest.mark.parametrize("n_leaves", [len(ADAMW_LEAVES), 1500])
def test_adamw_norm_kernel_against_an_f64_sum(n_leaves):
    """``global_norm`` on the card within 1e-6 relative of the f64 sum of
    squares, the same bits in two runs; one launch a table and the
    finalize."""
    from repro_torch.kernels.adamw import kernel as K
    from repro_torch.optim import adamw
    if n_leaves == len(ADAMW_LEAVES):
        grads = adamw_leaves(3, 3.0)[0]
    else:
        rng = np.random.default_rng(1)
        grads = adamw_leaves(4, 1.0, [((int(n),), "float32", "same", "plain")
                                      for n in rng.integers(1, 5000,
                                                            n_leaves)])[0]
    want = sum(float(x.double().square().sum()) for x in grads
               if x is not None) ** 0.5
    n0 = K.sumsq.launches
    a = adamw.global_norm(grads)
    b = adamw.global_norm(grads)
    torch.cuda.synchronize()
    assert a.dtype == torch.float32 and a.shape == () and a.is_cuda
    assert abs(float(a) - want) <= 1e-6 * want
    same_bits(a, b)
    assert K.sumsq.launches - n0 == 2 * (-(-n_leaves // 640) + 1)


def test_adamw_update_never_syncs_with_the_host():
    """A whole ``adamw.update`` (the schedule, the norm, the clip, the
    kernels) under ``torch.cuda.set_sync_debug_mode("error")``."""
    from repro_torch.optim import adamw
    grads, ms, vs, params = adamw_leaves(5, 1.0, ADAMW_LEAVES[:-1])
    cfg = adamw.AdamWConfig()
    state = adamw.AdamWState(
        step=torch.zeros((), dtype=torch.int32, device="cuda"), m=ms, v=vs)
    _, state, _ = adamw.update(cfg, grads, state, params)  # builds, loads
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, state, info = adamw.update(cfg, grads, state, params)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(state.step) == 2 and torch.isfinite(info["grad_norm"])


def test_adamw_update_launches_for_582_leaves():
    """rwkv6-1.6b's 582 leaves (their sizes cut by 64): the counters show
    one update launch, one norm launch and its finalize, and the whole
    ``adamw.update`` launches at most 40 device operations."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.adamw import kernel as K
    from repro_torch.optim import adamw
    sizes = ([2048 * 65536 // 64] * 2 + [2048 * 7168 // 64] * 48
             + [2048 * 2048 // 64] * 120 + [2048 * 32] * 100
             + [2048] * 310 + [32 * 2048] * 2)
    assert len(sizes) == 582
    cases = [((n,), "bfloat16", "same", "plain") for n in sizes]
    grads, ms, vs, params = adamw_leaves(6, 1.0, cases)
    cfg = adamw.AdamWConfig()
    state = adamw.init(params)
    adamw.update(cfg, grads, state, params)
    torch.cuda.synchronize()
    counts = (K.update.launches, K.sumsq.launches, K.update.leaves)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        adamw.update(cfg, grads, state, params)
        torch.cuda.synchronize()
    assert (K.update.launches - counts[0], K.sumsq.launches - counts[1],
            K.update.leaves - counts[2]) == (1, 2, 582)
    ops = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    assert 3 <= len(ops) <= 40, len(ops)
