"""PyTorch port of the cluster plane against the reference, on the CPU.

The per-CS key streams, the private caches' round sweep, the merged-trace
digests of every wave (``Cluster.record_traces``), the counters, the
conservation invariant, the ``RunResult`` of ``run_cluster_systems`` and
the final tree contents are all compared exactly.  The reference's write
and repair phases run undonated: its scheduler binds ``_jit_write_phase``
at import (repro/cluster/sched.py:47), so both that name and
``repro.core.api``'s are patched.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.cluster as JCL
import repro.cluster.sched as JS
import repro.core.api as JA
import repro.workloads as JWL
from repro.core import FG_PLUS as J_FG, SHERMAN as J_SH
from repro.core import TreeConfig as JCfg
from repro.core import write as JW
from repro.core.ref import OracleIndex
from repro.workloads.spec import WorkloadSpec as JSpec
import repro_torch.cluster as TCL
import repro_torch.workloads as TWL
from repro_torch.core import FG_PLUS as T_FG, SHERMAN as T_SH
from repro_torch.core import TreeConfig as TCfg
from repro_torch.core.tree import state_to_numpy
from repro_torch.workloads.spec import WorkloadSpec as TSpec

#: the reference cluster tests' config: small fanout, so waves split leaves
CFG = dict(n_ms=2, nodes_per_ms=1024, fanout=8, n_locks_per_ms=512,
           max_height=6, n_cs=4)
TINY = dict(load_records=2_000, ops=256, batch=128)
MIXED = dict(name="mixed", read=0.3, insert=0.2, update=0.2, delete=0.1,
             scan=0.1, rmw=0.1, **TINY)
FEATS = {"sherman": (J_SH, T_SH), "fg+": (J_FG, T_FG)}

_J_WRITE = jax.jit(JW.write_phase, static_argnums=(0,))
_J_REPAIR = jax.jit(lambda cfg, st, rq: JW.run_repair(cfg, st, rq, iters=2),
                    static_argnums=(0,))


def _j_repair_step(cfg, st, rq):
    st, rq, ni, nr = _J_REPAIR(cfg, st, rq)
    return st, rq, ni, nr, jnp.sum(rq.valid.astype(jnp.int32))


@pytest.fixture
def undonated(monkeypatch):
    """The reference's write and repair phases, undonated (donation
    changes no value; its cache image aliases the donated root)."""
    monkeypatch.setattr(JA, "_jit_write_phase", _J_WRITE)
    monkeypatch.setattr(JS, "_jit_write_phase", _J_WRITE)
    monkeypatch.setattr(JA, "_jit_repair", _j_repair_step)


def both_clusters(system="sherman", records=TINY["load_records"], **kw):
    jf, tf = FEATS[system]
    j = JCL.build_cluster(jf, JCfg(**CFG), records=records, seed=0, **kw)
    t = TCL.build_cluster(tf, TCfg(**CFG), records=records, seed=0,
                          device="cpu", **kw)
    return j, t


def assert_same_state(j, t):
    ref = jax.tree_util.tree_map(np.asarray, j.state)
    for name, a, b in zip(ref._fields, ref, state_to_numpy(t.state)):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def assert_same_samples(j, t):
    for name in ("latencies_write", "latencies_read", "doorbells_write",
                 "write_bytes", "queue_write", "queue_read"):
        a, b = getattr(j, name), getattr(t, name)
        assert len(a) == len(b), name
        for x, y in zip(a, b):
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)


# -- the per-CS key streams --------------------------------------------------

@pytest.mark.parametrize("partitioned", [False, True],
                         ids=["shared", "partitioned"])
@pytest.mark.parametrize("preset", ["ycsb-a", "ycsb-c", "ycsb-d",
                                    "uniform-hotspot"])
def test_streams_draw_the_reference_keys(preset, partitioned):
    kw = dict(load_records=5_000)
    if preset == "uniform-hotspot":
        specs = (JWL.get_preset("ycsb-a", **kw).replace(
                     distribution="hotspot", hot_frac=0.8, hot_n=32),
                 TWL.get_preset("ycsb-a", **kw).replace(
                     distribution="hotspot", hot_frac=0.8, hot_n=32))
    else:
        specs = (JWL.get_preset(preset, **kw), TWL.get_preset(preset, **kw))
    j = JCL.ClusterStreams(specs[0], 4, keyspace=1 << 20,
                           partitioned=partitioned, seed=3)
    t = TCL.ClusterStreams(specs[1], 4, keyspace=1 << 20,
                           partitioned=partitioned, seed=3)
    for step in range(3):
        for cs in range(4):
            a, b = j.draw(cs, 40 + cs), t.draw(cs, 40 + cs)
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)
            a, b = j.draw_insert(cs, 7), t.draw_insert(cs, 7)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        if step == 1:               # a mid-run skew shift, then a snapshot
            j.shift_skew(distribution="uniform")
            t.shift_skew(distribution="uniform")
    assert j.n_records == t.n_records
    snap = t.export_state()
    assert snap == j.export_state()
    after = [t.draw(cs, 9) for cs in range(4)]
    t.import_state(snap)
    for cs in range(4):
        np.testing.assert_array_equal(t.draw(cs, 9), after[cs])


# -- the private caches' round sweep -----------------------------------------

def test_cache_end_round_gives_the_reference_counters(undonated):
    """CS 1 warms its image, CS 0 splits leaves; CS 1 learns of them only
    through its round-periodic version sweep (sync_rounds=2)."""
    j, t = both_clusters(n_clients=2, sync_rounds=2)
    rng = np.random.default_rng(5)
    for rnd in range(6):
        probe = rng.integers(0, 1 << 20, 64).astype(np.int32)
        keys = rng.integers(0, 1 << 20, 96).astype(np.int32)
        for cl in (j, t):
            cl.lookup_wave([None, probe])
            cl.write_wave([keys, None], [keys, None])
            cl.end_round()
        for a, b in zip(j.nodes, t.nodes):
            assert a.cache.counters.as_dict() == b.cache.counters.as_dict()
            assert a.cache._rounds_since_sync == b.cache._rounds_since_sync
            assert a.counters == b.counters
        rj, rt = j.nodes[1].cache.rows_ms(), t.nodes[1].cache.rows_ms()
        assert rj.dtype == rt.dtype
        np.testing.assert_array_equal(rj, rt)
    assert t.nodes[1].cache.counters.sync_sweeps == 3
    assert t.nodes[0].counters["leaf_splits"] > 0
    assert_same_state(j, t)


# -- whole runs: digests wave for wave, counters, tree -------------------------

@pytest.mark.parametrize("system", ["sherman", "fg+"])
def test_trace_digests_counters_and_tree_equal_reference(undonated, system):
    j, t = both_clusters(system, n_clients=8)
    j.record_traces()
    t.record_traces()
    rj = JCL.run_cluster(j, JSpec(**MIXED), seed=1, keyspace=1 << 20)
    rt = TCL.run_cluster(t, TSpec(**MIXED), seed=1, keyspace=1 << 20)
    assert rj == rt
    assert len(t.trace_log) > 20
    for wave, (a, b) in enumerate(zip(j.trace_log, t.trace_log)):
        assert a == b, f"wave {wave}"
    assert len(j.trace_log) == len(t.trace_log)
    assert j.combined_counters() == t.combined_counters()
    assert j.node_totals() == t.node_totals()
    for a, b in zip(j.nodes, t.nodes):
        assert a.counters == b.counters
        assert a.cache.counters.as_dict() == b.cache.counters.as_dict()
    assert j.conservation_ok() and t.conservation_ok()
    assert j.throughput_mops() == t.throughput_mops()
    assert_same_samples(j, t)
    assert_same_state(j, t)
    # and the fleet's answers on the final tree
    rng = np.random.default_rng(8)
    keys = [rng.integers(0, 1 << 20, 20 + cs).astype(np.int32)
            for cs in range(4)]
    for (va, fa), (vb, fb) in zip(j.lookup_wave(keys), t.lookup_wave(keys)):
        np.testing.assert_array_equal(va, vb)
        np.testing.assert_array_equal(fa, fb)
    for a, b in zip(j.scan_wave(keys, count=6), t.scan_wave(keys, count=6)):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    assert j.trace_log == t.trace_log


def test_fleet_from_an_empty_pool_matches_oracle_and_reference(undonated):
    """The reference's oracle scenario (tests/test_cluster.py): an empty
    pool seeded through the fleet's own write waves, then interleaved
    per-CS writes and reads; within a round CS order is arrival order."""
    j, t = both_clusters(records=0, n_clients=8)
    j.record_traces()
    t.record_traces()
    base = np.arange(0, 2_000, 4)
    oracle = OracleIndex()
    for cs in range(4):
        mine = base[cs::4]
        for i in range(0, mine.size, 64):
            kb = [None] * 4
            kb[cs] = mine[i:i + 64].astype(np.int32)
            for cl in (j, t):
                cl.write_wave(kb, kb)
        oracle.insert_batch(mine, mine)
    rng = np.random.default_rng(0)
    for _ in range(3):
        keys = [rng.choice(base, 16).astype(np.int32) for _ in range(4)]
        vals = [rng.integers(0, 1 << 20, 16).astype(np.int32)
                for _ in range(4)]
        for cl in (j, t):
            cl.write_wave(keys, vals)
        for k, v in zip(keys, vals):
            oracle.insert_batch(k, v)
        probe = [rng.choice(base, 24).astype(np.int32) for _ in range(4)]
        got_t = t.lookup_wave(probe)
        got_j = j.lookup_wave(probe)
        for p, (vt, ft), (vj, fj) in zip(probe, got_t, got_j):
            assert ft.all()
            np.testing.assert_array_equal(
                vt, [oracle.lookup(int(k)) for k in p])
            np.testing.assert_array_equal(vt, vj)
        for cl in (j, t):
            cl.end_round()
    assert j.trace_log == t.trace_log
    assert j.combined_counters() == t.combined_counters()
    assert t.conservation_ok()
    assert_same_state(j, t)


# -- the engine's entry point --------------------------------------------------

@pytest.mark.parametrize("partitioned", [False, True],
                         ids=["shared", "partitioned"])
def test_run_cluster_systems_result_equals_reference(undonated, partitioned):
    kw = dict(n_clients=8, partitioned=partitioned)
    want = JWL.run_cluster_systems(JWL.get_preset("write-intensive", **TINY),
                                   ("sherman", "fg+"), JCfg(**CFG), **kw)
    got = TWL.run_cluster_systems(TWL.get_preset("write-intensive", **TINY),
                                  ("sherman", "fg+"), TCfg(**CFG),
                                  device="cpu", **kw)
    for a, b in zip(want, got):
        assert a.to_dict() == b.to_dict()
        assert b.conservation_ok and len(b.per_cs) == 4
        assert b.rounds == TINY["ops"] // 8      # 8 lanes a round
