"""PyTorch port of the open-loop serving plane against the reference, on
the CPU: the arrival generators' int64 picosecond grids, the op
materialization, the single-station replay, ``run_open_loop_systems``'
RunResults (sojourn, queueing, SLO and sustained fields included), the
port's own t=0 open-loop == closed-loop digests, one M/D/1
Pollaczek–Khinchine case, and the load sweep.  The reference's write and
repair phases run undonated (both ``_jit_write_phase`` bindings patched).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.cluster.sched as JS
import repro.core.api as JA
import repro.serve as JSV
import repro.workloads as JWL
from repro.cluster import ClusterStreams as JStreams
from repro.core import TreeConfig as JCfg
from repro.core import write as JW
import repro_torch.serve as TSV
import repro_torch.workloads as TWL
from repro_torch.cluster import ClusterStreams as TStreams
from repro_torch.cluster import build_cluster, run_cluster
from repro_torch.core import SHERMAN as T_SH
from repro_torch.core import TreeConfig as TCfg
from repro_torch.core.netsim import PS_PER_S, NetConfig
from repro_torch.workloads.spec import WorkloadSpec as TSpec

CFG = dict(n_ms=2, nodes_per_ms=1024, fanout=8, n_locks_per_ms=512,
           max_height=6, n_cs=4)
TINY = dict(load_records=2_000, ops=256, batch=128)
MIXED = dict(name="mixed", read=0.3, insert=0.2, update=0.2, delete=0.1,
             scan=0.1, rmw=0.1, **TINY)

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


# -- arrivals ----------------------------------------------------------------

GENERATORS = [
    ("poisson", lambda m: m.poisson_arrivals(2e6, 5_000, seed=4)),
    ("bursty", lambda m: m.bursty_arrivals(2e6, 5_000, seed=4)),
    ("bursty-knobs", lambda m: m.bursty_arrivals(
        1e6, 3_000, seed=9, burst_factor=4.0, burst_frac=0.2,
        burst_ops=16.0)),
    ("diurnal", lambda m: m.diurnal_arrivals(2e6, 5_000, seed=4)),
    ("closed", lambda m: m.make_arrivals("closed", 1.0, 100)),
    ("make-diurnal", lambda m: m.make_arrivals(
        "diurnal", 5e5, 2_000, seed=2, diurnal_period_s=1e-3,
        diurnal_peak=1.5)),
    ("spliced", lambda m: m.spliced_arrivals(
        [("poisson", 1e6, 1_000), ("bursty", 8e6, 0),
         ("bursty", 8e6, 500), ("diurnal", 2e6, 700)], seed=6)),
]


@pytest.mark.parametrize("gen", [g for _, g in GENERATORS],
                         ids=[n for n, _ in GENERATORS])
def test_arrivals_equal_reference_int64_ps(gen):
    want, got = gen(JSV), gen(TSV)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(want, got)
    assert (np.diff(got) >= 0).all()


def test_arrival_argument_errors_equal_reference():
    for call in (lambda m: m.poisson_arrivals(0.0, 10),
                 lambda m: m.bursty_arrivals(1e6, 10, burst_frac=1.5),
                 lambda m: m.diurnal_arrivals(1e6, 10, peak=3.0),
                 lambda m: m.make_arrivals("square", 1e6, 10)):
        with pytest.raises(ValueError) as want:
            call(JSV)
        with pytest.raises(ValueError) as got:
            call(TSV)
        assert str(got.value) == str(want.value)


def test_materialize_ops_equals_reference():
    jspec = JWL.get_preset("ycsb-a", **TINY).replace(**{
        k: v for k, v in MIXED.items() if k not in TINY})
    tspec = TSpec(**MIXED)
    assert jspec.to_dict() == tspec.to_dict()
    want = JSV.materialize_ops(
        jspec, JStreams(jspec, 4, keyspace=1 << 20, seed=1), 4, 2, 32)
    got = TSV.materialize_ops(
        tspec, TStreams(tspec, 4, keyspace=1 << 20, seed=1), 4, 2, 32)
    for a_cs, b_cs in zip(want, got):
        for a, b in zip(a_cs, b_cs):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("chunk", [None, 777])
def test_simulate_station_equals_reference(chunk):
    arr = TSV.poisson_arrivals(5e5, 4_000, seed=3) / PS_PER_S
    nbytes = np.random.default_rng(1).integers(64, 4_096, arr.size)
    net = NetConfig(rtt_s=4e-5)
    want = JSV.simulate_station(arr, nbytes, net, n_ms=2, chunk=chunk)
    got = TSV.simulate_station(arr, nbytes, net, n_ms=2, chunk=chunk)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)


def test_md1_pollaczek_khinchine_at_half_load():
    """Deterministic payload => M/D/1: the port's replay gives the P-K
    mean queueing delay within 15% at rho = 0.5 (the reference test's
    bound, tests/test_serve_queueing.py)."""
    net = NetConfig(rtt_s=4e-5)
    svc_bytes = 12_500                 # 1 us of NIC occupancy under net
    svc_s = max(1.0 / net.nic_iops_small, svc_bytes / net.nic_bw_Bps)
    arr = TSV.poisson_arrivals(0.5 / svc_s, 20_000, seed=3)
    sim = TSV.simulate_station(arr / PS_PER_S, svc_bytes, net, n_ms=1)
    lam = (arr.size - 1) / ((arr[-1] - arr[0]) / PS_PER_S)
    s = sim["service_s"]
    rho = lam * s.mean()
    assert rho < 1.0
    wq = lam * np.mean(s ** 2) / (2.0 * (1.0 - rho))
    assert sim["wait_s"].mean() == pytest.approx(wq, rel=0.15)
    np.testing.assert_allclose(sim["sojourn_s"],
                               sim["wait_s"] + s + sim["rtt_s"], atol=1e-12)


# -- the cluster serving loop ------------------------------------------------

@pytest.mark.parametrize("arrival", ["poisson", "bursty"])
def test_run_open_loop_systems_result_equals_reference(undonated, arrival):
    kw = dict(n_clients=8, slo_us=20.0)
    jspec = JWL.get_preset("ycsb-a", **TINY).replace(arrival=arrival,
                                                     offered_mops=1.0)
    tspec = TWL.get_preset("ycsb-a", **TINY).replace(arrival=arrival,
                                                     offered_mops=1.0)
    want = JWL.run_open_loop_systems(jspec, ("sherman", "fg+"),
                                     JCfg(**CFG), **kw)
    got = TWL.run_open_loop_systems(tspec, ("sherman", "fg+"), TCfg(**CFG),
                                    device="cpu", **kw)
    for a, b in zip(want, got):
        assert a.to_dict() == b.to_dict()
        assert b.arrival == arrival and b.queue_p99_us > 0
        assert 0 < b.slo_attainment <= 1 and 0 < b.sustained_frac <= 1


def test_open_loop_sojourn_and_queueing_arrays_equal_reference(undonated):
    from repro.cluster import build_cluster as j_build
    from repro.serve.loop import run_open_loop as j_run
    jspec = JWL.get_preset("write-intensive", **TINY).replace(
        arrival="poisson", offered_mops=2.0)
    tspec = TWL.get_preset("write-intensive", **TINY).replace(
        arrival="poisson", offered_mops=2.0)
    j = j_build(JWL.SYSTEMS["sherman"], JCfg(**CFG), n_clients=8,
                records=TINY["load_records"], seed=0)
    t = build_cluster(T_SH, TCfg(**CFG), n_clients=8,
                      records=TINY["load_records"], seed=0, device="cpu")
    j.record_traces()
    t.record_traces()
    assert j_run(j, jspec, seed=1) == TSV.run_open_loop(t, tspec, seed=1)
    assert j.trace_log == t.trace_log
    for name in ("latencies_write", "latencies_read", "queue_write",
                 "queue_read", "doorbells_write"):
        a, b = getattr(j, name), getattr(t, name)
        assert len(a) == len(b), name
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y, err_msg=name)
    assert j.combined_counters() == t.combined_counters()


@pytest.mark.parametrize("spec", [dict(name="ycsb-a", read=0.5, update=0.5,
                                       **TINY), MIXED],
                         ids=["ycsb-a", "all-kinds"])
def test_port_open_loop_at_t0_reproduces_its_closed_loop(spec):
    """Every arrival at t=0: the port's serving loop executes its closed
    loop's program, digest for digest."""
    spec = TSpec(**spec)
    closed = build_cluster(T_SH, TCfg(**CFG), n_clients=8,
                           records=TINY["load_records"], seed=0,
                           device="cpu")
    closed.record_traces()
    done_c, ops_c = run_cluster(closed, spec, seed=1, keyspace=1 << 20)
    served = build_cluster(T_SH, TCfg(**CFG), n_clients=8,
                           records=TINY["load_records"], seed=0,
                           device="cpu")
    served.record_traces()
    done_o, ops_o, info = TSV.run_open_loop(served, spec, seed=1,
                                            keyspace=1 << 20)
    assert done_o == done_c and ops_o == ops_c
    assert served.trace_log == closed.trace_log
    drop = lambda c: {k: v for k, v in c.items() if k != "sim_time_s"}
    assert drop(served.combined_counters()) == \
        drop(closed.combined_counters())
    assert served.node_totals() == closed.node_totals()
    assert info["last_arrival_s"] == 0.0
    assert 0 < served.counters["sim_time_s"] <= closed.counters["sim_time_s"]


def test_load_sweep_equals_reference(undonated):
    kw = dict(systems=("sherman",), n_clients=8, load_records=2_000,
              ops=128, points=(0.5,), out=None)
    want = JSV.load_sweep(cfg=JCfg(**CFG), **kw)
    got = TSV.load_sweep(cfg=TCfg(**CFG), device="cpu", **kw)
    assert want == got
    assert len(got["rates_mops"]) == 3
