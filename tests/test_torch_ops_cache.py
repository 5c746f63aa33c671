"""PyTorch port, read path and CS-side cache: traversal, lookup and range
against the reference on seeded trees, the cache image and its descent,
the cached lookup (fresh and stale images, against both of the
reference's probe modes), and the
``IndexCache`` scenarios of tests/test_cache.py run on both packages with
every counter compared.  Tolerance: exact, dtypes included."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.api as JA
from repro.core import OracleIndex
from repro.core import cache as JC
from repro.core import ops as JO
from repro.core import tree as JT
from repro.core import write as JW
from repro.workloads import SYSTEMS as J_SYSTEMS
from repro.workloads import build_index as j_build_index
from repro_torch.core import cache as TC
from repro_torch.core import ops as TO
from repro_torch.core import tree as TT
from repro_torch.workloads import SYSTEMS as T_SYSTEMS
from repro_torch.workloads import build_index as t_build_index
from repro_torch.workloads import scramble

KEYSPACE = 1 << 20
CACHE_CFG = dict(n_ms=2, nodes_per_ms=2048, fanout=16, n_locks_per_ms=1024,
                 max_height=7, n_cs=4)
TREE_CFGS = {
    "core_tree": dict(n_ms=2, nodes_per_ms=512, fanout=8,
                      n_locks_per_ms=1024, max_height=6, n_cs=2),
    "property": dict(n_ms=2, nodes_per_ms=1024, fanout=8,
                     n_locks_per_ms=512, max_height=7, n_cs=2),
}

_J_WRITE = jax.jit(JW.write_phase, static_argnums=(0,))
_J_REPAIR = jax.jit(lambda cfg, st, rq: JW.run_repair(cfg, st, rq, iters=2),
                    static_argnums=(0,))


def _j_repair_step(cfg, st, rq):
    st, rq, ni, nr = _J_REPAIR(cfg, st, rq)
    return st, rq, ni, nr, jnp.sum(rq.valid.astype(jnp.int32))


@pytest.fixture
def undonated(monkeypatch):
    """The reference donates its state to the jitted write phase while its
    cache image keeps an alias of the state's root (repro/core/cache.py:98),
    so some op sequences hit a deleted buffer on a JAX with CPU donation.
    Its phases run undonated here; donation changes no value."""
    monkeypatch.setattr(JA, "_jit_write_phase", _J_WRITE)
    monkeypatch.setattr(JA, "_jit_repair", _j_repair_step)


def np_of(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_tuple_equal(ref, got, what=""):
    for name, a, b in zip(ref._fields, ref, got):
        a, b = np.asarray(a), np_of(b)
        assert a.dtype == b.dtype, (what, name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {name}")


def assert_state_equal(jst, tst):
    ref = jax.tree_util.tree_map(np.asarray, jst)
    assert_tuple_equal(ref, TT.state_to_numpy(tst), "state")


def _ranks(lo, hi):
    return scramble(np.arange(lo, hi), KEYSPACE).astype(np.int32)


# -- read ops on seeded trees ----------------------------------------------

@pytest.mark.parametrize("cfg_name,n,seed", [("core_tree", 300, 0),
                                             ("property", 1_500, 1)])
def test_traverse_lookup_range_parity(cfg_name, n, seed):
    jcfg = JT.TreeConfig(**TREE_CFGS[cfg_name])
    tcfg = TT.TreeConfig(**TREE_CFGS[cfg_name])
    rng = np.random.default_rng(seed)
    keys = rng.choice(100_000, size=n, replace=False)
    vals = rng.integers(0, 1 << 20, size=n)
    jst = JT.bulkload(jcfg, keys, vals)
    tst = TT.bulkload(tcfg, keys, vals, device="cpu")
    q = np.concatenate([keys[:200], rng.integers(0, 100_000, 56),
                        [0, 99_999, -5, 2**31 - 2]]).astype(np.int32)
    jq, tq = jnp.asarray(q), torch.from_numpy(q)

    jtr, ttr = JO.traverse(jcfg, jst, jq), TO.traverse(tcfg, tst, tq)
    assert_tuple_equal(jtr, ttr, "traverse")
    for lv in range(int(jst.height) + 1):
        np.testing.assert_array_equal(np.asarray(JO.parent_at_level(jtr, lv)),
                                      TO.parent_at_level(ttr, lv).numpy())
    stop = np.asarray(jst.height) - 1 - np.arange(q.size) % 2
    assert_tuple_equal(
        JO.traverse(jcfg, jst, jq, stop_level_arr=jnp.asarray(stop)),
        TO.traverse(tcfg, tst, tq, stop_level_arr=torch.from_numpy(stop)),
        "traverse to per-lane levels")
    assert_tuple_equal(JO.lookup_batch(jcfg, jst, jq),
                       TO.lookup_batch(tcfg, tst, tq), "lookup_batch")
    lo = q[:32]
    assert_tuple_equal(JO.range_batch(jcfg, jst, jnp.asarray(lo), 10, 12),
                       TO.range_batch(tcfg, tst, torch.from_numpy(lo), 10,
                                      12), "range_batch")


@pytest.mark.parametrize("tear", ["node", "entry", "free"])
def test_leaf_lookup_version_protocol_parity(tear):
    jcfg = JT.TreeConfig(**TREE_CFGS["core_tree"])
    tcfg = TT.TreeConfig(**TREE_CFGS["core_tree"])
    rng = np.random.default_rng(0)
    keys = rng.choice(100_000, size=300, replace=False)
    jst = JT.bulkload(jcfg, keys, keys)
    tst = TT.bulkload(tcfg, keys, keys, device="cpu")
    leaf = int(JO.traverse(jcfg, jst, jnp.asarray(keys[:1], jnp.int32))
               .leaf[0])
    if tear == "node":
        jst = jst._replace(fnv=jst.fnv.at[leaf].add(1))
        tst.fnv[leaf] += 1
    elif tear == "entry":
        jst = jst._replace(fev=jst.fev.at[leaf, 0].add(1))
        tst.fev[leaf, 0] += 1
    else:
        jst = jst._replace(free_bit=jst.free_bit.at[leaf].set(True))
        tst.free_bit[leaf] = True
    row = np.asarray(jst.keys[leaf])
    q = np.concatenate([row[row != -1], [777_777]]).astype(np.int32)
    lv = np.full(q.size, leaf, np.int32)
    ref = JO.leaf_lookup(jst, jnp.asarray(lv), jnp.asarray(q))
    assert_tuple_equal(ref, TO.leaf_lookup(tst, torch.from_numpy(lv),
                                           torch.from_numpy(q)), tear)
    assert not np.asarray(ref.consistent).all()


# -- cache image, descent, cached lookup -----------------------------------

def _cache_pair(records, **kw):
    jcfg, tcfg = JT.TreeConfig(**CACHE_CFG), TT.TreeConfig(**CACHE_CFG)
    j = j_build_index(J_SYSTEMS["sherman"], jcfg, records=records, **kw)
    t = t_build_index(T_SYSTEMS["sherman"], tcfg, records=records,
                      device="cpu", **kw)
    assert_state_equal(j.state, t.state)
    return j, t


def assert_image_equal(jimg, timg):
    for k in jimg:
        a, b = np.asarray(jimg[k]), timg[k].numpy()
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("levels,rows", [(None, None), (2, None),
                                         (None, 6)])
def test_fill_and_descend_image_parity(levels, rows):
    j, t = _cache_pair(8_000)
    jimg, jev = JC.fill_image(j.cfg, j.state, levels=levels, max_rows=rows)
    timg, tev = TC.fill_image(t.cfg, t.state, levels=levels, max_rows=rows)
    assert jev == tev
    assert_image_equal(jimg, timg)
    q = np.concatenate([_ranks(0, 200), [5, 2**31 - 2]]).astype(np.int32)
    ref = JC.descend_image(jimg, jnp.asarray(q), j.cfg.max_height)
    got = TC.descend_image(timg, torch.from_numpy(q), t.cfg.max_height)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # the image carried across from the reference, and back
    assert_image_equal(jimg, TC.image_from_numpy(
        {k: np.asarray(v) for k, v in jimg.items()}, device="cpu"))
    assert_image_equal(jimg, TC.image_from_numpy(TC.image_to_numpy(timg),
                                                 device="cpu"))


def test_cached_lookup_fresh_and_stale_parity(undonated):
    """A fresh image hits; after inserts split leaves the same image is
    stale, and the chase/retraversal must agree lane for lane."""
    j, t = _cache_pair(3_000)
    jimg, _ = JC.fill_image(j.cfg, j.state)
    timg, _ = TC.fill_image(t.cfg, t.state)
    # 128 consecutive keys land in one or two leaves and split them
    new_k = np.sort(_ranks(0, 3_000))[1_000] + np.arange(1, 129,
                                                          dtype=np.int32)
    q = np.concatenate([_ranks(0, 300), new_k])

    def compare(tag):
        r2, s2 = TC.cached_lookup(t.cfg, t.state, timg, torch.from_numpy(q))
        for jmode in ("ref", "interpret"):
            r1, s1 = JC.cached_lookup(j.cfg, j.state, jimg, jnp.asarray(q),
                                      kernel_mode=jmode)
            assert_tuple_equal(r1, r2, f"{tag} {jmode} result")
            assert_tuple_equal(s1, s2, f"{tag} {jmode} stats")
        return s2

    fresh = compare("fresh")
    assert fresh.hit[:300].all()
    j.insert(new_k, new_k)
    t.insert(new_k, new_k)
    assert_state_equal(j.state, t.state)
    stale = compare("stale")
    assert t.counters["leaf_splits"] > 0 and stale.stale.any()


# -- IndexCache scenarios (tests/test_cache.py) on both packages ----------

def _apply(idx, op):
    kind, *args = op
    if kind == "insert":
        return idx.insert(*args)
    if kind == "delete":
        return idx.delete(*args)
    if kind == "lookup":
        return idx.lookup(*args)
    if kind == "range":
        return idx.range(*args)
    if kind == "sync":
        return idx.cache.sync_versions(idx.state)
    if kind == "invalidate":
        return idx.cache.invalidate_covering(*args)
    if kind == "drop_root":           # as a version sweep would
        c = idx.cache
        v = c._valid.copy()
        v[c._rows == c._root] = False
        return c._set_valid(v)
    raise ValueError(kind)


def run_scenario(ops, records, oracle=None, cache_attrs=(), **kw):
    j, t = _cache_pair(records, **kw)
    for name, val in cache_attrs:
        setattr(j.cache, name, val)
        setattr(t.cache, name, val)
    for op in ops:
        a, b = _apply(j, op), _apply(t, op)
        if isinstance(a, tuple):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y, err_msg=op[0])
        else:
            assert a == b, op[0]
        assert j.counters == t.counters, op[0]
        assert j.cache.counters.as_dict() == t.cache.counters.as_dict(), \
            op[0]
        if oracle is not None:
            if op[0] == "insert":
                oracle.insert_batch(*op[1:])
            elif op[0] == "delete":
                oracle.delete_batch(op[1])
            elif op[0] == "lookup":
                want = [oracle.lookup(int(k)) for k in op[1]]
                for g, f, w in zip(*b, want):
                    assert (w is None and not f) or (f and g == w)
    assert_state_equal(j.state, t.state)
    np.testing.assert_array_equal(j.cache._valid, t.cache._valid)
    for name in ("latencies_write", "latencies_read", "doorbells_write",
                 "write_bytes"):
        a, b = getattr(j, name), getattr(t, name)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y, err_msg=name)
    return j, t


def test_stale_cache_lookups_parity_and_oracle(undonated):
    rng = np.random.default_rng(3)
    load_k = _ranks(0, 2_000)
    load_v = rng.integers(0, 1 << 20, 2_000).astype(np.int32)
    ops = [("insert", load_k, load_v), ("lookup", load_k[:64])]
    for lo in range(2_000, 2_400, 100):
        new_k = _ranks(lo, lo + 100)
        ops.append(("insert", new_k,
                    rng.integers(0, 1 << 20, 100).astype(np.int32)))
        ops.append(("lookup", np.concatenate(
            [new_k, load_k[rng.integers(0, 2_000, 156)]])))
    _, t = run_scenario(ops, 2_000, oracle=OracleIndex())
    assert t.counters["leaf_splits"] > 0


def test_random_op_mix_never_refreshed_cache(undonated):
    rng = np.random.default_rng(11)
    k0 = _ranks(0, 2_000)
    ops = [("insert", k0, np.arange(2_000, dtype=np.int32)),
           ("lookup", k0[:32])]
    cursor = 2_000
    for _ in range(4):
        ins = _ranks(cursor, cursor + 100)
        cursor += 100
        ops.append(("insert", ins,
                    rng.integers(0, 1 << 20, 100).astype(np.int32)))
        ops.append(("delete", scramble(rng.choice(cursor, 100,
                                                  replace=False),
                                       KEYSPACE).astype(np.int32)))
        ops.append(("lookup", np.concatenate(
            [ins[:56], _ranks(0, cursor)[rng.integers(0, cursor, 200)]])))
    _, t = run_scenario(ops, 2_000, oracle=OracleIndex(),
                        cache_attrs=(("sync_every", 0),
                                     ("refresh_frac", 1.1)))
    assert t.counters["cache_stale"] > 0


def test_eviction_partial_levels_and_disabled_cache():
    q = _ranks(0, 256)
    budget = 6 * TT.TreeConfig(**CACHE_CFG).node_bytes
    _, t = run_scenario([("lookup", q)], 8_000, cache_bytes=budget)
    assert t.cache.counters.evictions > 0
    _, t = run_scenario([("lookup", q)], 8_000, cache_levels=2)
    assert t.counters["cache_misses"] == 256
    _, t = run_scenario([("lookup", q)], 4_000, cache_bytes=0)
    assert t.counters["lookup_reads"] == 256 * int(t.state.height)


def test_invalidation_sync_and_counters(undonated):
    ops = [("lookup", _ranks(0, 64)), ("invalidate", _ranks(100, 101)),
           ("invalidate", _ranks(100, 101)),
           ("insert", _ranks(4_000, 4_128), np.arange(128, dtype=np.int32)),
           ("sync",), ("lookup", _ranks(0, 256)),
           ("range", _ranks(0, 32), 8), ("drop_root",),
           ("lookup", _ranks(0, 64)), ("delete", _ranks(0, 128)),
           ("lookup", _ranks(0, 64)), ("lookup", np.zeros(0, np.int32))]
    _, t = run_scenario(ops, 4_000,
                        cache_attrs=(("sync_every", 10**9),))
    c = t.counters
    assert c["cache_hits"] + c["cache_misses"] + c["cache_stale"] \
        == c["lookup_ops"]
    assert t.cache.counters.invalidations >= 1
