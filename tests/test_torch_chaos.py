"""PyTorch port of the chaos plane against the reference, on the CPU: the
fault schedules of ``tests/test_chaos.py``.

For every schedule both packages' runners run on the same build recipe,
seed and faults (placed at fractions of the reference's fault-free
horizon), and everything a run leaves behind is held equal
(:func:`torch_chaos_common.assert_same_run`): fault log, executed write
log, samples, ``report()``, merged-trace digests wave for wave, op
counts, counters and the final tree byte for byte.  The mechanisms under
the runner (``write_wave(drain=False)``, repair abandonment and
re-derivation, recovery traces) are held to the reference on their own.
"""
import numpy as np
import pytest

from repro.chaos import faults as JF
from repro.core.tree import TreeConfig as JCfg
from repro_torch.chaos import faults as TF
from repro_torch.cluster import run_cluster
from repro_torch.core.tree import TreeConfig as TCfg
from torch_chaos_common import (CFG, assert_same_run, assert_same_state,
                                build_pair, one_torch_thread, run_pair,
                                runner_pair, spec_pair, undonated_reference)

pytestmark = pytest.mark.chaos


@pytest.fixture(scope="module", autouse=True)
def undonated():
    with undonated_reference(), one_torch_thread():
        yield


@pytest.fixture(scope="module")
def baseline():
    """The fault-free runs of both packages, by system."""
    return {system: run_pair(system) for system in ("sherman", "fg+")}


def horizon(baseline, system="sherman") -> float:
    return baseline[system][0].cluster.counters["sim_time_s"]


# -- the runner is run_cluster when nothing fails -----------------------------

@pytest.mark.parametrize("system", ["sherman", "fg+"])
def test_empty_schedule_equals_reference(baseline, system):
    rj, rt = baseline[system]
    assert_same_run(rj, rt)
    assert rt.done == 640 and rt.fault_log == [] and len(rt.samples) == 20


def test_empty_schedule_equals_the_ports_run_cluster(baseline):
    _, rt = baseline["sherman"]
    _, cl = build_pair("sherman")
    cl.record_traces()
    done, op_counts = run_cluster(cl, spec_pair()[1], seed=1)
    assert done == rt.done
    assert op_counts == {k: v for k, v in rt.op_counts.items() if v}
    assert cl.trace_log == rt.cluster.trace_log
    assert cl.combined_counters() == rt.cluster.combined_counters()
    for name, a, b in zip(cl.state._fields, cl.state, rt.cluster.state):
        assert a.dtype == b.dtype and bool((a == b).all()), name


# -- MS crashes ---------------------------------------------------------------

@pytest.mark.parametrize("system", ["sherman", "fg+"])
def test_ms_crashes_without_memory_loss_equal_reference(baseline, system):
    h = horizon(baseline, system)
    rj, rt = run_pair(system, (
        dict(kind="ms_crash", at_s=0.3 * h, ms=0, down_s=0.02 * h),
        dict(kind="ms_crash", at_s=0.6 * h, ms=1, down_s=0.01 * h)))
    assert_same_run(rj, rt)
    assert [f["kind"] for f in rt.fault_log] == ["ms_crash"] * 2
    # memory survived: the tree is the fault-free run's, bit for bit
    assert_same_state(baseline[system][0].cluster.state, rt.cluster.state)


@pytest.mark.parametrize("system", ["sherman", "fg+"])
def test_lose_memory_without_checkpoint_raises_as_reference(system):
    faults = (dict(kind="ms_crash", at_s=0.0, ms=0, lose_memory=True),)
    rj, rt = runner_pair(system, faults, record=False)
    with pytest.raises(RuntimeError, match="checkpoint") as ej:
        rj.run()
    with pytest.raises(RuntimeError, match="checkpoint") as et:
        rt.run()
    assert str(et.value) == str(ej.value)
    assert len(rt.write_log) == len(rj.write_log) == 1
    assert rt.cluster._repair_backlog == rj.cluster._repair_backlog == 0
    assert_same_state(rj.cluster.state, rt.cluster.state)


def test_strand_and_rederive_equal_reference():
    """``write_wave(drain=False)`` strands the wave's half-splits; the
    mirror ``abandon_repairs`` takes, ``requeue_repairs`` and
    ``drain_repairs`` then give the drained twin's tree — in both
    packages, with equal mirrors and trees."""
    keys = (500_000 + np.arange(192) * 200).astype(np.int32)
    kb = [keys[i::4] for i in range(4)]
    twin_j, twin_t = build_pair()
    j, t = build_pair()
    for cl in (twin_j, twin_t):
        cl.write_wave(kb, kb)
    for cl in (j, t):
        cl.write_wave(kb, kb, drain=False)
    assert t._repair_backlog == j._repair_backlog > 0
    mj, mt = JF.abandon_repairs(j), TF.abandon_repairs(t)
    assert t._repair_backlog == 0 and int(t.repair.valid.sum()) == 0
    assert t.repair.valid.device == t.device
    assert sorted(mt) == sorted(mj)
    for k in mj:
        assert mt[k].dtype == mj[k].dtype, k
        np.testing.assert_array_equal(mt[k], mj[k], err_msg=k)
    # a host copy: clearing the queue on the device leaves it intact
    assert mt["valid"].sum() > 0
    assert TF.requeue_repairs(t, mt) == JF.requeue_repairs(j, mj) > 0
    assert t.repair.sep.device == t.device
    for cl in (j, t):
        cl.drain_repairs()
    assert_same_state(j.state, t.state)
    assert_same_state(twin_j.state, t.state)
    assert_same_state(twin_j.state, twin_t.state)
    # nothing pending: the mirror is None in both
    assert TF.abandon_repairs(t) is None and JF.abandon_repairs(j) is None


@pytest.mark.parametrize("kw", [dict(scan_rows=1000, small_bytes=64),
                                dict(restore_rows=500),
                                dict(restore_rows=3, max_verbs=2),
                                dict(scan_rows=0, restore_rows=0),
                                dict(scan_rows=100_000, small_bytes=100)],
                         ids=["scan", "restore", "chunked", "glt-only",
                              "capped"])
def test_recovery_trace_arrays_equal_reference(kw):
    a = JF.recovery_trace(JCfg(**CFG), 1, **kw)
    b = TF.recovery_trace(TCfg(**CFG), 1, **kw)
    for f in ("kind", "role", "ms", "nbytes", "lane", "doorbell", "dep",
              "dep2", "at"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert (a.n_lanes, a.meta, a.obj) == (b.n_lanes, b.meta, b.obj)
    assert b.n_verbs <= 1 + kw.get("max_verbs", TF.MAX_RECOVERY_VERBS)


# -- CS churn and skew storms -------------------------------------------------

@pytest.mark.parametrize("system", ["sherman", "fg+"])
def test_cs_leave_then_join_equals_reference(baseline, system):
    h = horizon(baseline, system)
    rj, rt = run_pair(system, (dict(kind="cs_leave", at_s=0.3 * h, cs=2),
                               dict(kind="cs_join", at_s=0.65 * h, cs=2)))
    assert_same_run(rj, rt)
    assert [f["kind"] for f in rt.fault_log] == ["cs_leave", "cs_join"]
    for a, b in zip(rj.cluster.nodes, rt.cluster.nodes):
        assert a.counters == b.counters
        assert a.cache.counters.as_dict() == b.cache.counters.as_dict()


def test_all_four_cs_leaving_equals_reference(baseline):
    h = horizon(baseline)
    rj, rt = run_pair("sherman", tuple(
        dict(kind="cs_leave", at_s=0.1 * h * (i + 1), cs=i)
        for i in range(4)))
    assert_same_run(rj, rt)
    assert sum(1 for f in rt.fault_log if f.get("skipped")) == 1
    assert sum(rt.alive) == 1


def test_hotspot_storm_and_lift_equal_reference(baseline):
    h = horizon(baseline)
    rj, rt = run_pair("sherman", (
        dict(kind="skew_shift", at_s=0.4 * h, distribution="hotspot",
             hot_frac=0.95, hot_n=8),
        dict(kind="skew_shift", at_s=0.75 * h, distribution="zipfian",
             theta=0.99)))
    assert_same_run(rj, rt)
    assert [f["distribution"] for f in rt.fault_log] == ["hotspot",
                                                         "zipfian"]
    assert rt.streams.export_state() == rj.streams.export_state()
