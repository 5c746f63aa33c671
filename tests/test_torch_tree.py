"""PyTorch port, tree state: the vectorized bulkload against the reference's
per-node loop, the allocator, pool exhaustion, and the numpy round trip
that carries a JAX state across.  Tolerance: exact, dtypes included."""
import jax
import numpy as np
import pytest
import torch

from repro.core import tree as JT
from repro_torch.core import tree as TT

CFGS = {
    "core_tree": dict(n_ms=2, nodes_per_ms=512, fanout=8,
                      n_locks_per_ms=1024, max_height=6, n_cs=2),
    "system": dict(n_ms=4, nodes_per_ms=1024, fanout=16,
                   n_locks_per_ms=1024, max_height=7, n_cs=4),
    "narrow": dict(n_ms=2, nodes_per_ms=512, fanout=4, n_locks_per_ms=512,
                   max_height=8, n_cs=2),
}


def _pair(name):
    return JT.TreeConfig(**CFGS[name]), TT.TreeConfig(**CFGS[name])


def assert_state_equal(jst, tst):
    ref = jax.tree_util.tree_map(np.asarray, jst)
    got = TT.state_to_numpy(tst)
    for name, a, b in zip(TT.TreeState._fields, ref, got):
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("cfg,n,fill", [
    ("core_tree", 300, 0.8), ("core_tree", 0, 0.8), ("core_tree", 1, 0.8),
    ("core_tree", 6, 0.8), ("core_tree", 7, 0.8), ("core_tree", 200, 1.0),
    ("core_tree", 200, 0.5), ("system", 5_000, 0.8), ("narrow", 40, 0.8),
    ("narrow", 1, 0.8),
])
def test_bulkload_parity(cfg, n, fill):
    jcfg, tcfg = _pair(cfg)
    rng = np.random.default_rng(n)
    keys = rng.choice(1 << 18, size=n, replace=False)
    vals = rng.integers(0, 1 << 20, size=n)
    assert_state_equal(JT.bulkload(jcfg, keys, vals, fill=fill),
                       TT.bulkload(tcfg, keys, vals, fill=fill,
                                   device="cpu"))


def test_bulkload_from_tensors_on_device():
    """Tensors in (the load phase's path) give the numpy path's state."""
    _, tcfg = _pair("core_tree")
    rng = np.random.default_rng(3)
    keys = rng.choice(100_000, size=300, replace=False)
    vals = rng.integers(0, 1 << 20, size=300)
    a = TT.bulkload(tcfg, keys, vals, device="cpu")
    b = TT.bulkload(tcfg, torch.from_numpy(keys), torch.from_numpy(vals))
    for name, x, y in zip(TT.TreeState._fields, a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), name


def test_empty_state_parity():
    jcfg, tcfg = _pair("narrow")
    assert_state_equal(JT.empty_state(jcfg),
                       TT.empty_state(tcfg, device="cpu"))


def test_bulkload_rejects_duplicates_like_reference():
    jcfg, tcfg = _pair("core_tree")
    with pytest.raises(ValueError):
        JT.bulkload(jcfg, np.asarray([1, 1, 2]), np.asarray([1, 2, 3]))
    with pytest.raises(ValueError):
        TT.bulkload(tcfg, np.asarray([1, 1, 2]), np.asarray([1, 2, 3]),
                    device="cpu")


@pytest.mark.parametrize("n", [0, 400])
def test_pool_exhaustion_raises_like_reference(n):
    """A pool with no allocatable row cannot hold even an empty tree's
    leaf; a 400-key load needs far more nodes than 2 MS x 3 rows."""
    kw = dict(n_ms=2, nodes_per_ms=4 if n else 1, fanout=4,
              n_locks_per_ms=16, max_height=6, n_cs=2)
    keys = np.arange(n)
    with pytest.raises(RuntimeError, match="exhausted"):
        JT.bulkload(JT.TreeConfig(**kw), keys, keys)
    with pytest.raises(RuntimeError, match="exhausted"):
        TT.bulkload(TT.TreeConfig(**kw), keys, keys, device="cpu")


def test_pool_filled_to_capacity_matches_reference():
    """The last allocatable row of every MS is used, none beyond."""
    kw = dict(n_ms=3, nodes_per_ms=5, fanout=4, n_locks_per_ms=16,
              max_height=6, n_cs=2)
    # 3 MS x 4 rows = 12 allocations: 9 leaves (3 keys each) + 3 + 1 = 13
    # is one too many; 8 leaves + 2 + 1 = 11 fits
    for n, ok in ((24, True), (27, False)):
        keys = np.arange(n) * 5
        if ok:
            assert_state_equal(
                JT.bulkload(JT.TreeConfig(**kw), keys, keys),
                TT.bulkload(TT.TreeConfig(**kw), keys, keys, device="cpu"))
        else:
            with pytest.raises(RuntimeError):
                JT.bulkload(JT.TreeConfig(**kw), keys, keys)
            with pytest.raises(RuntimeError):
                TT.bulkload(TT.TreeConfig(**kw), keys, keys, device="cpu")


def test_allocator_rows_match_the_loop():
    cfg = TT.TreeConfig(n_ms=3, nodes_per_ms=7, fanout=4)
    nxt, want = [0] * cfg.n_ms, []
    for k in range(cfg.n_ms * cfg.alloc_cap):
        ms = k % cfg.n_ms
        want.append(ms * cfg.nodes_per_ms + nxt[ms])
        nxt[ms] += 1
    got = TT._alloc_rows(cfg, 0, len(want), torch.device("cpu"))
    assert got.tolist() == want


def test_numpy_round_trip_carries_a_jax_state():
    jcfg, tcfg = _pair("core_tree")
    rng = np.random.default_rng(0)
    keys = rng.choice(100_000, size=300, replace=False)
    jst = JT.bulkload(jcfg, keys, keys)
    arrays = jax.tree_util.tree_map(np.asarray, jst)
    tst = TT.state_from_numpy(arrays, device="cpu")
    assert_state_equal(jst, tst)
    for name, t in zip(TT.TreeState._fields, tst):
        assert t.dtype == TT.STATE_DTYPES[name]
    back = TT.state_from_numpy(TT.state_to_numpy(tst), device="cpu")
    assert_state_equal(jst, back)


def test_state_from_numpy_refuses_dtype_drift():
    jcfg, _ = _pair("narrow")
    arrays = jax.tree_util.tree_map(np.asarray, JT.empty_state(jcfg))
    bad = arrays._replace(fev=arrays.fev.astype(np.int32))
    with pytest.raises(TypeError, match="fev"):
        TT.state_from_numpy(bad, device="cpu")


def test_clone_state_is_independent():
    _, tcfg = _pair("narrow")
    st = TT.bulkload(tcfg, np.arange(10), np.arange(10), device="cpu")
    copy = TT.clone_state(st)
    st.keys.fill_(7)
    assert not torch.equal(copy.keys, st.keys)
