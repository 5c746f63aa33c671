"""PyTorch port, lock plane and write path: HOCL conflict groups and lock
counters on the inputs of tests/test_hocl.py, the segment and queue
helpers, and ``write_phase`` on the inputs of tests/test_core_write.py and
a seeded random op sequence that forces leaf, internal and root splits —
state, done mask, WriteStats and RepairQueue compared after every phase.
Tolerance: exact, dtypes included."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hocl as JH
from repro.core import tree as JT
from repro.core import write as JW
from repro_torch.core import hocl as TH
from repro_torch.core import tree as TT
from repro_torch.core import write as TW
from repro_torch.core.api import REPAIR_CAP, run_repair_drain

HOCL_CFG = dict(n_ms=2, nodes_per_ms=64, fanout=4, n_locks_per_ms=64,
                max_height=4, n_cs=4, handover_max=4)
WRITE_CFGS = {
    "core_write": dict(n_ms=2, nodes_per_ms=512, fanout=8,
                       n_locks_per_ms=1024, max_height=6, n_cs=2),
    "narrow": dict(n_ms=2, nodes_per_ms=512, fanout=4, n_locks_per_ms=512,
                   max_height=8, n_cs=2),
}
B = 64                                  # the dispatch bucket of every phase

_J_WRITE = jax.jit(JW.write_phase, static_argnums=(0,))
_J_REPAIR = jax.jit(lambda cfg, st, rq: JW.run_repair(cfg, st, rq, iters=2),
                    static_argnums=(0,))


def np_of(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_tuple_equal(ref, got, what=""):
    for name, a, b in zip(ref._fields, ref, got):
        a, b = np.asarray(a), np_of(b)
        assert a.dtype == b.dtype, (what, name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {name}")


def assert_state_equal(jst, tst, what="state"):
    assert_tuple_equal(jax.tree_util.tree_map(np.asarray, jst),
                       TT.state_to_numpy(tst), what)


# -- HOCL ------------------------------------------------------------------

def _hocl_inputs(case):
    if case == "single_group":
        return [5, 5, 5, 5], [0, 0, 0, 0], None
    if case == "depth_cap":
        return [7] * 11, [0] * 11, None
    if case == "cross_cs":
        return [9, 9, 9, 9], [0, 0, 1, 1], None
    if case == "inactive":
        return [3, 3, 3], [0, 0, 0], [True, False, True]
    rng = np.random.default_rng(int(case[-1]))
    n = 64
    return (rng.integers(0, 20, n).tolist(), rng.integers(0, 4, n).tolist(),
            (rng.random(n) < 0.8).tolist())


@pytest.mark.parametrize("case", ["single_group", "depth_cap", "cross_cs",
                                  "inactive", "random0", "random1",
                                  "random2"])
def test_group_by_node_and_lock_stats_parity(case):
    nodes, cs, active = _hocl_inputs(case)
    nodes = np.asarray(nodes, np.int32)
    cs = np.asarray(cs, np.int32)
    active = np.ones(nodes.shape, bool) if active is None else \
        np.asarray(active)
    jcfg, tcfg = JT.TreeConfig(**HOCL_CFG), TT.TreeConfig(**HOCL_CFG)
    jg = JH.group_by_node(jcfg, jnp.asarray(nodes), jnp.asarray(cs),
                          jnp.asarray(active))
    tg = TH.group_by_node(tcfg, torch.from_numpy(nodes),
                          torch.from_numpy(cs), torch.from_numpy(active))
    assert_tuple_equal(jg, tg, case)
    js = JH.lock_phase_stats(jcfg, jg, jnp.asarray(active))
    ts = TH.lock_phase_stats(tcfg, tg, torch.from_numpy(active))
    for k in js:
        assert np.asarray(js[k]).dtype == np_of(ts[k]).dtype, k
        assert int(js[k]) == int(ts[k]), k


def test_cross_cs_contention_and_reset_glt():
    leaves = [np.asarray([1, 2, 3]), np.asarray([2, 3, 3]), np.asarray([]),
              np.asarray([3, 9])]
    assert JH.cross_cs_contention(leaves) == TH.cross_cs_contention(leaves)
    cfg = TT.TreeConfig(**HOCL_CFG)
    st = TT.empty_state(cfg, device="cpu")
    st.glt.fill_(3)
    TH.reset_glt(st, 1)
    assert not st.glt[1].to(torch.int32).any()
    assert (st.glt[0].to(torch.int32) == 3).all()


def test_segment_helpers_keep_jax_identities():
    """Empty segments keep 0 / INT32_MAX, as ``jax.ops.segment_*`` do."""
    vals = np.asarray([5, -3, 7, 2], np.int32)
    ids = np.asarray([0, 2, 2, 4], np.int32)
    tv, ti = torch.from_numpy(vals), torch.from_numpy(ids)
    for jf, tf in ((jax.ops.segment_sum, TH.segment_sum),
                   (jax.ops.segment_min, TH.segment_min)):
        want = np.asarray(jf(jnp.asarray(vals), jnp.asarray(ids),
                             num_segments=6))
        got = tf(tv, ti, 6).numpy()
        assert want.dtype == got.dtype
        np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rank_by_and_enqueue_pending_parity(seed):
    rng = np.random.default_rng(seed)
    q = 16
    key = rng.integers(0, 6, 24).astype(np.int32)
    act = rng.random(24) < 0.7
    for a, b in zip(JW._rank_by(jnp.asarray(key), jnp.asarray(act), 100),
                    TW._rank_by(torch.from_numpy(key), torch.from_numpy(act),
                                100)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # a partly full queue; more separators than free slots on seed 2
    valid = rng.random(q) < (0.9 if seed == 2 else 0.4)
    pend = dict(sep=rng.integers(0, 999, q).astype(np.int32),
                child=rng.integers(0, 99, q).astype(np.int32),
                level=rng.integers(0, 3, q).astype(np.int32), valid=valid)
    jq = JW.RepairQueue(**{k: jnp.asarray(v) for k, v in pend.items()})
    tq = TW.repair_from_numpy(pend, device="cpu")
    sep = rng.integers(0, 999, 24).astype(np.int32)
    child = rng.integers(0, 99, 24).astype(np.int32)
    level = np.ones(24, np.int32)
    did = rng.random(24) < 0.5
    assert_tuple_equal(
        JW._enqueue_pending(jq, *map(jnp.asarray, (sep, child, level, did))),
        TW._enqueue_pending(tq, *map(torch.from_numpy,
                                     (sep, child, level, did))), "enqueue")


# -- write_phase, phase by phase -------------------------------------------

class Pair:
    """One tree in both packages, driven by identical write batches."""

    def __init__(self, cfg_name, base_keys, base_vals):
        kw = WRITE_CFGS[cfg_name]
        self.jcfg, self.tcfg = JT.TreeConfig(**kw), TT.TreeConfig(**kw)
        self.jst = JT.bulkload(self.jcfg, base_keys, base_vals)
        self.tst = TT.bulkload(self.tcfg, base_keys, base_vals,
                               device="cpu")
        self.jrq = JW.RepairQueue.empty(REPAIR_CAP)
        self.trq = TW.RepairQueue.empty(REPAIR_CAP, device="cpu")
        self.phases = 0
        self.splits = np.zeros(3, int)

    def write(self, keys, vals=None, delete=False):
        n = len(keys)
        assert 0 < n <= B
        k = np.zeros(B, np.int32)
        k[:n] = keys
        v = np.zeros(B, np.int32)
        if vals is not None:
            v[:n] = vals
        is_del = np.full(B, delete)
        per = -(-n // self.tcfg.n_cs)
        cs = ((np.arange(B) // per) % self.tcfg.n_cs).astype(np.int32)
        active = np.arange(B) < n
        for _ in range(8):
            j_args = [jnp.asarray(a) for a in (k, v, is_del, active, cs)]
            t_args = [torch.from_numpy(a) for a in (k, v, is_del, active, cs)]
            self.jst, jdone, jstats, self.jrq = _J_WRITE(
                self.jcfg, self.jst, *j_args, self.jrq)
            self.tst, tdone, tstats, self.trq = TW.write_phase(
                self.tcfg, self.tst, *t_args, self.trq)
            self.phases += 1
            tag = f"phase {self.phases}"
            assert_state_equal(self.jst, self.tst, tag)
            np.testing.assert_array_equal(np.asarray(jdone), tdone.numpy())
            assert_tuple_equal(jstats, tstats, tag + " stats")
            assert_tuple_equal(self.jrq, self.trq, tag + " repair")
            self.splits += [int(tstats.n_leaf_splits),
                            int(tstats.n_internal_splits),
                            int(tstats.n_root_splits)]
            active = active & ~tdone.numpy()
            if not active.any():
                break
        self.drain()

    def drain(self):
        for _ in range(16):
            if not bool(self.trq.valid.any()):
                break
            self.jst, self.jrq, jni, jnr = _J_REPAIR(self.jcfg, self.jst,
                                                     self.jrq)
            self.tst, self.trq, tni, tnr = TW.run_repair(
                self.tcfg, self.tst, self.trq, iters=2)
            assert (int(jni), int(jnr)) == (int(tni), int(tnr))
            assert_state_equal(self.jst, self.tst, "repair")
            assert_tuple_equal(self.jrq, self.trq, "repair queue")
            self.splits += [0, int(tni), int(tnr)]


def _fresh(seed=1, n=200):
    rng = np.random.default_rng(seed)
    keys = rng.choice(50_000, size=n, replace=False)
    vals = rng.integers(0, 1 << 20, size=n)
    return Pair("core_write", keys, vals), keys, rng


def test_update_existing_keys():
    p, keys, rng = _fresh()
    p.write(keys[:32], rng.integers(0, 100, 32))


def test_inserts_cause_splits():
    p, _, rng = _fresh()
    for _ in range(6):
        p.write(rng.integers(0, 50_000, size=64),
                rng.integers(0, 1 << 20, size=64))
    assert p.splits[0] > 0


def test_delete_then_reinsert():
    p, keys, _ = _fresh()
    p.write(keys[:24], delete=True)
    p.write(np.concatenate([keys[:24], [77_777]]), delete=True)
    p.write(keys[:24], keys[:24] * 3)


def test_intra_batch_last_op_wins_and_duplicate_new_key():
    p, keys, _ = _fresh()
    p.write([keys[0]] * 3, [1, 2, 3])
    p.write([77_777] * 5, np.arange(5))
    p.write([77_777], delete=True)


def test_handover_contention():
    p, _, _ = _fresh()
    p.write(np.full(64, 4_242), np.arange(64))
    p.write(np.full(64, 4_242), np.arange(64), delete=True)


def test_random_ops_force_leaf_internal_and_root_splits():
    """A seeded insert/update/delete sequence on a fanout-4 tree grown
    from one key: leaf, internal and root splits all happen."""
    rng = np.random.default_rng(3)
    p = Pair("narrow", np.asarray([10]), np.asarray([1]))
    live = [10]
    for i in range(14):
        ks = rng.choice(10_000, size=48, replace=False)
        p.write(ks, ks * 2)
        live.extend(ks.tolist())
        if i % 3 == 2:
            p.write(rng.choice(live, 16, replace=False), delete=True)
        if i % 4 == 3:
            upd = rng.choice(live, 32, replace=False)
            p.write(upd, rng.integers(0, 1 << 20, 32))
    leaf, internal, root = p.splits
    assert leaf > 0 and internal > 0 and root > 0, p.splits


def test_split_nodes_and_repair_drain_parity():
    """Split six leaves without repairing their parents, queue the
    separators, then drain the queue with each package's API drain."""
    import repro.core.api as JA
    rng = np.random.default_rng(9)
    p = Pair("narrow", np.asarray([10]), np.asarray([1]))
    for _ in range(3):
        ks = rng.choice(10_000, size=64, replace=False)
        p.write(ks, ks)
    level = np.asarray(p.jst.level)
    cnt = (np.asarray(p.jst.keys) != -1).sum(axis=1)
    nodes = np.nonzero((level == 0) & (cnt >= 2))[0][:6].astype(np.int32)
    rep = np.ones(nodes.size, bool)
    jout = JW._split_nodes(p.jcfg, p.jst, jnp.asarray(nodes),
                           jnp.asarray(rep))
    tout = TW._split_nodes(p.tcfg, p.tst, torch.from_numpy(nodes),
                           torch.from_numpy(rep))
    assert_state_equal(jout[0], tout[0], "split")
    for a, b in zip(jout[1:], tout[1:]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    jst, jsep, jrow, jdid, _ = jout
    tst, tsep, trow, tdid, _ = tout
    jq = JW._enqueue_pending(JW.RepairQueue.empty(REPAIR_CAP), jsep, jrow,
                             jst.level[jrow].astype(jnp.int32), jdid)
    tq = TW._enqueue_pending(TW.RepairQueue.empty(REPAIR_CAP, "cpu"), tsep,
                             trow, tst.level[trow].to(torch.int32), tdid)
    assert_tuple_equal(jq, tq, "queue")
    assert int(tq.valid.sum()) == 6
    jres = JA.run_repair_drain(p.jcfg, jst, jq)
    tres = run_repair_drain(p.tcfg, tst, tq)
    assert_state_equal(jres[0], tres[0], "drained")
    assert_tuple_equal(jres[1], tres[1], "drained queue")
    assert jres[2:] == tres[2:] and tres[4] == 0
