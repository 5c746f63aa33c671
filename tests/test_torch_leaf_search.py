"""PyTorch port, leaf-search kernel: the gathered-row entry's plain version
and wrapper on CPU tensors against the reference's Pallas kernel (interpret
mode) and its jnp oracle, on the reference kernel test's shapes, a ragged
batch and the tree's own uint8 versions; the pool entry
(``leaf_search_pool_ref`` and ``lookup_leaves``) against the reference's
``lookup_leaves`` on bulkloaded and written trees with torn versions, at
the kernel test's shapes, a ragged batch and an empty one; the wrappers'
refusals.  The CUDA kernel against the plain versions is in
test_torch_cuda.py.  Tolerance: exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tree as JT
from repro.kernels.leaf_search.kernel import leaf_search as j_leaf_search
from repro.kernels.leaf_search.ops import lookup_leaves as j_lookup_leaves
from repro.kernels.leaf_search.ref import leaf_search_ref as j_ref
from repro_torch.core import tree as TT
from repro_torch.core.api import ShermanIndex
from repro_torch.kernels.leaf_search.kernel import (leaf_search,
                                                    leaf_search_pool)
from repro_torch.kernels.leaf_search.ops import lookup_leaves
from repro_torch.kernels.leaf_search.ref import (leaf_search_pool_ref,
                                                 leaf_search_ref)


def make_inputs(seed, b, f):
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


def assert_outputs_equal(ref, got):
    dtypes = (torch.int32, torch.bool, torch.bool)
    for r, g, dt in zip(ref, got, dtypes):
        assert g.dtype == dt
        np.testing.assert_array_equal(np.asarray(r), g.numpy())


@pytest.mark.parametrize("b,f,bt", [(256, 8, 64), (512, 16, 128),
                                    (128, 32, 128), (256, 64, 256),
                                    (300, 16, 300), (1, 16, 1)])
def test_plain_version_matches_pallas_kernel_and_oracle(b, f, bt):
    host = make_inputs(b * f, b, f)
    jargs = [jnp.asarray(a) for a in host]
    pallas = j_leaf_search(*jargs, bt=bt, interpret=True)
    oracle = j_ref(*jargs)
    targs = [torch.from_numpy(a) for a in host]
    assert_outputs_equal(pallas, leaf_search_ref(*targs))
    assert_outputs_equal(oracle, leaf_search_ref(*targs))
    # the wrapper on CPU tensors runs the plain version
    assert_outputs_equal(oracle, leaf_search(*targs))


def test_uint8_versions_match_int32_versions():
    """The tree keeps FEV/REV as uint8; the kernel takes both widths."""
    host = make_inputs(5, 512, 16)
    targs = [torch.from_numpy(a) for a in host]
    narrow = list(targs)
    narrow[3], narrow[4] = targs[3].to(torch.uint8), targs[4].to(torch.uint8)
    for a, b in zip(leaf_search(*targs), leaf_search(*narrow)):
        assert torch.equal(a, b)


def test_empty_batch_returns_empty_outputs():
    host = make_inputs(1, 4, 16)
    targs = [torch.from_numpy(a)[:0] for a in host]
    value, found, cons = leaf_search(*targs)
    assert value.shape == found.shape == cons.shape == (0,)


@pytest.mark.parametrize("break_arg", ["dtype", "shape", "contiguity",
                                       "fanout"])
def test_wrapper_refuses_what_the_kernel_does_not_take(break_arg):
    host = make_inputs(2, 8, 16)
    targs = [torch.from_numpy(a) for a in host]
    if break_arg == "dtype":
        targs[1] = targs[1].to(torch.int64)
    elif break_arg == "shape":
        targs[5] = targs[5][:4]
    elif break_arg == "contiguity":
        targs[2] = torch.from_numpy(np.asfortranarray(host[2]))
    else:
        wide = make_inputs(2, 8, 300)
        targs = [torch.from_numpy(a) for a in wide]
    n0 = leaf_search.launches
    with pytest.raises((TypeError, ValueError)):
        leaf_search(*targs)
    assert leaf_search.launches == n0


def test_lookup_leaves_on_a_bulkloaded_tree():
    kw = dict(n_ms=2, nodes_per_ms=512, fanout=8, n_locks_per_ms=1024,
              max_height=6, n_cs=2)
    rng = np.random.default_rng(0)
    keys = rng.choice(100_000, size=300, replace=False).astype(np.int32)
    jcfg, tcfg = JT.TreeConfig(**kw), TT.TreeConfig(**kw)
    jst = JT.bulkload(jcfg, keys, keys * 3)
    tst = TT.bulkload(tcfg, keys, keys * 3, device="cpu")
    # tear one leaf (node versions) and one entry (entry versions)
    leaves = np.nonzero(np.asarray(jst.level) == 0)[0]
    jst = jst._replace(fnv=jst.fnv.at[leaves[0]].add(1),
                       fev=jst.fev.at[leaves[1], 0].add(1))
    tst.fnv[leaves[0]] += 1
    tst.fev[leaves[1], 0] += 1
    leaf = np.repeat(leaves[:8], 8).astype(np.int32)
    q = np.asarray(jst.keys)[leaf, np.arange(64) % 8].astype(np.int32)
    q[::5] = 123_456                                   # some misses
    want = j_lookup_leaves(jcfg, jst, jnp.asarray(leaf), jnp.asarray(q),
                           interpret=True)
    got = lookup_leaves(tcfg, tst, torch.from_numpy(leaf),
                        torch.from_numpy(q))
    assert_outputs_equal(want, got)
    assert not np.asarray(want[2]).all()          # the torn lanes showed


# --------------------------------------------------------------------------
# the pool entry against the reference's lookup_leaves
# --------------------------------------------------------------------------

def torn_tree(fanout, lanes, written, seed):
    """A port index's pool on the CPU: bulkloaded and, with ``written``,
    after inserts that split leaves and deletes; then torn: fnv != rnv on
    some leaves, free_bit on others, fev != rev in every entry of some
    leaves and in half the entries of others.  And ``lanes`` queries: leaf
    ids of torn and clean leaves and of other rows (internal, unallocated,
    negative, past the pool), with keys of the row's slots or absent."""
    cfg = TT.TreeConfig(n_ms=2, nodes_per_ms=1024, fanout=fanout,
                        n_locks_per_ms=1024, max_height=8, n_cs=2)
    rng = np.random.default_rng(seed)
    keys = rng.choice(1 << 20, size=30 * fanout, replace=False)
    idx = ShermanIndex.build(cfg, keys.astype(np.int32),
                             (keys * 3).astype(np.int32), device="cpu")
    if written:
        new = rng.choice(1 << 21, size=24 * fanout, replace=False)
        new = new[~np.isin(new, keys)].astype(np.int32)
        for lo in range(0, new.size, 64):
            idx.insert(new[lo:lo + 64], new[lo:lo + 64] + 7)
        idx.delete(rng.choice(keys, size=4 * fanout,
                              replace=False).astype(np.int32))
        assert idx.counters["leaf_splits"] > 0
    st = idx.state
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
    return cfg, st, row.astype(np.int32), q.astype(np.int32)


def jax_state(st):
    return JT.TreeState(*[jnp.asarray(a) for a in TT.state_to_numpy(st)])


def jax_lookup_leaves(jst, leaf, q):
    """The reference's lookup_leaves (Pallas in interpret mode) where its
    tiling takes the batch (B <= 256 or a multiple of 256), else the same
    gather into its jnp oracle."""
    b = leaf.shape[0]
    if 0 < b and (b <= 256 or b % 256 == 0):
        cfg = None                              # unused by the function
        return j_lookup_leaves(cfg, jst, jnp.asarray(leaf), jnp.asarray(q),
                               interpret=True)
    r = jnp.asarray(leaf)
    i32 = jnp.int32
    return j_ref(jnp.asarray(q), jst.keys[r], jst.vals[r], jst.fev[r],
                 jst.rev[r], jst.fnv[r].astype(i32), jst.rnv[r].astype(i32),
                 jst.free_bit[r].astype(i32))


# (fanout, lanes, written): the reference kernel test's shapes on fresh
# trees, two written trees, a ragged batch, one lane and none
POOL_CASES = [(8, 256, False), (16, 512, False), (32, 128, False),
              (64, 256, False), (8, 256, True), (16, 512, True),
              (16, 300, False), (16, 1, False), (16, 0, False)]


@pytest.mark.parametrize("fanout,lanes,written", POOL_CASES)
def test_pool_entry_matches_jax_lookup_leaves(fanout, lanes, written):
    cfg, st, leaf, q = torn_tree(fanout, lanes, written, fanout + lanes)
    want = jax_lookup_leaves(jax_state(st), leaf, q)
    tl, tq = torch.from_numpy(leaf), torch.from_numpy(q)
    assert_outputs_equal(want, leaf_search_pool_ref(
        tq, tl, st.keys, st.vals, st.fev, st.rev, st.fnv, st.rnv,
        st.free_bit))
    assert_outputs_equal(want, lookup_leaves(cfg, st, tl, tq))
    if lanes >= 128:
        # every branch of `consistent` showed: torn node, freed node, torn
        # entry found, torn row but the query absent, and clean hits
        found, cons = np.asarray(want[1]), np.asarray(want[2])
        assert found.any() and (~cons).any() and (cons & ~found).any()


@pytest.mark.parametrize("break_arg", ["leaf_dtype", "pool_dtype", "shape",
                                       "contiguity", "fanout", "device"])
def test_pool_wrapper_refuses_what_the_kernel_does_not_take(break_arg):
    _, st, leaf, q = torn_tree(8, 16, False, 3)
    args = [torch.from_numpy(q), torch.from_numpy(leaf), st.keys, st.vals,
            st.fev, st.rev, st.fnv, st.rnv, st.free_bit]
    if break_arg == "leaf_dtype":
        args[1] = args[1].long()
    elif break_arg == "pool_dtype":
        args[6] = args[6].to(torch.int32)
    elif break_arg == "shape":
        args[7] = args[7][:4]
    elif break_arg == "contiguity":
        args[3] = args[3].t().contiguous().t()
    elif break_arg == "fanout":
        args[2:6] = [a.repeat(1, 40) for a in args[2:6]]
    else:
        args[0] = args[0].to("meta")
    n0 = leaf_search.launches
    with pytest.raises((TypeError, ValueError)):
        leaf_search_pool(*args)
    assert leaf_search.launches == n0
