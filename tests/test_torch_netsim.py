"""PyTorch port, verb plane and replay: the port's host-NumPy copies of
``verbs`` and ``netsim`` give the reference's traces, completion grids and
priced totals from the same stats dicts, under both ``simulate`` and
``simulate_ref``; the stats dicts themselves come from the port's write
path.  Tolerance: exact (the replay is an int64 picosecond grid)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import netsim as JN
from repro.core import verbs as JV
from repro_torch.core import netsim as TN
from repro_torch.core import tree as TT
from repro_torch.core import verbs as TV
from repro_torch.core import write as TW
from repro_torch.core.api import write_stats_dict
from repro_torch.workloads import SYSTEMS

CFG = TT.TreeConfig(n_ms=2, nodes_per_ms=1024, fanout=8, n_locks_per_ms=512,
                    max_height=6, n_cs=4)
FEATURES = sorted(SYSTEMS)


def _one_write_phase(n=96, seed=7):
    """One raw write phase of the port (hot keys + fresh keys: contention
    and splits), as the API hands it to netsim."""
    rng = np.random.default_rng(seed)
    base = rng.choice(20_000, size=600, replace=False)
    st = TT.bulkload(CFG, base, base, device="cpu")
    hot = rng.integers(0, 40, size=n // 2)
    new = rng.choice(np.setdiff1d(np.arange(20_000), base), size=n // 2,
                     replace=False)
    keys = torch.from_numpy(np.concatenate([hot, new]).astype(np.int32))
    cs = torch.from_numpy((np.arange(n) % CFG.n_cs).astype(np.int32))
    _, _, stats, _ = TW.write_phase(CFG, st, keys, torch.ones_like(keys),
                                    torch.zeros(n, dtype=torch.bool),
                                    torch.ones(n, dtype=torch.bool), cs)
    hits = rng.random(n) < 0.5
    return write_stats_dict(stats, np.ones(n, bool), hits, int(st.height))


def _read_stats(n=128, seed=3):
    rng = np.random.default_rng(seed)
    return dict(active=np.arange(n) < n - 5,
                cache_hit=rng.random(n) < 0.7,
                remote_reads=rng.integers(1, 5, n),
                leaf=rng.integers(0, CFG.n_nodes, n).astype(np.int32),
                height=4)


def assert_priced_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def assert_trace_equal(a, b):
    for f in dataclasses.fields(JV.VerbTrace):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "meta":
            assert x.keys() == y.keys()
            for k in x:
                np.testing.assert_array_equal(np.asarray(x[k]),
                                              np.asarray(y[k]))
        elif x is None or y is None:
            assert x is None and y is None, f.name
        else:
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)


def _feat(mod, name):
    f = SYSTEMS[name]
    return mod.Features(combine=f.combine, onchip=f.onchip,
                        hierarchical=f.hierarchical, twolevel=f.twolevel)


@pytest.mark.parametrize("name", FEATURES)
def test_write_phase_pricing_parity(name):
    sd = _one_write_phase()
    a = JN.price_write_phase(sd, _feat(JN, name), JN.NetConfig(), CFG)
    b = TN.price_write_phase(sd, _feat(TN, name), TN.NetConfig(), CFG)
    assert_priced_equal(a, b)
    assert a["makespan_s"] > 0


@pytest.mark.parametrize("name", FEATURES)
def test_write_trace_and_transforms_parity(name):
    sd = _one_write_phase()
    a = JN.transformed_write_trace(sd, _feat(JN, name), JN.NetConfig(), CFG)
    b = TN.transformed_write_trace(sd, _feat(TN, name), TN.NetConfig(), CFG)
    assert_trace_equal(a, b)


@pytest.mark.parametrize("scan", [False, True])
def test_read_and_maintenance_pricing_parity(scan):
    sd = _read_stats()
    if scan:
        sd = dict(sd, scan=True, retries=sd.pop("remote_reads") - 1)
    for name in ("sherman", "fg+"):
        assert_priced_equal(
            JN.price_read_phase(sd, _feat(JN, name), JN.NetConfig(), CFG),
            TN.price_read_phase(sd, _feat(TN, name), TN.NetConfig(), CFG))
    rows_ms = np.asarray([0, 1, 1, 0, 1], np.int32)
    assert_priced_equal(
        JN.price_maintenance(40, 17, JN.SHERMAN, JN.NetConfig(), CFG,
                             rows_ms=rows_ms),
        TN.price_maintenance(40, 17, TN.SHERMAN, TN.NetConfig(), CFG,
                             rows_ms=rows_ms))


@pytest.mark.parametrize("onchip", [True, False])
def test_simulate_and_simulate_ref_grids_parity(onchip):
    """Both replays of both packages give one completion grid."""
    sd = _one_write_phase(seed=11)
    jt = JN.transformed_write_trace(sd, JN.SHERMAN, JN.NetConfig(), CFG)
    tt = TN.transformed_write_trace(sd, TN.SHERMAN, TN.NetConfig(), CFG)
    runs = [JN.simulate(jt, JN.NetConfig(), CFG.n_ms, onchip),
            JN.simulate_ref(jt, JN.NetConfig(), CFG.n_ms, onchip),
            TN.simulate(tt, TN.NetConfig(), CFG.n_ms, onchip),
            TN.simulate_ref(tt, TN.NetConfig(), CFG.n_ms, onchip)]
    for r in runs[1:]:
        assert_priced_equal(runs[0], r)


def test_merged_traces_parity():
    """The cross-CS merge (GLT lock chains) is copied bit for bit."""
    sds = [_one_write_phase(n=32, seed=s) for s in (1, 2, 3)]
    jts = [JN.transformed_write_trace(sd, JN.SHERMAN, JN.NetConfig(), CFG)
           for sd in sds]
    tts = [TN.transformed_write_trace(sd, TN.SHERMAN, TN.NetConfig(), CFG)
           for sd in sds]
    assert_trace_equal(JV.merge_traces(jts), TV.merge_traces(tts))
    jsim, jmerged = JN.price_merged_phase(jts, JN.SHERMAN, JN.NetConfig(),
                                          CFG)
    tsim, tmerged = TN.price_merged_phase(tts, TN.SHERMAN, TN.NetConfig(),
                                          CFG)
    assert_priced_equal(jsim, tsim)
    assert_trace_equal(jmerged, tmerged)


def test_write_trace_conservation_on_the_port():
    """The port's replay conserves the functional plane's counters (the
    closed form of tests/test_netsim_trace.py), for Sherman and FG+."""
    sd = _one_write_phase()
    act = np.asarray(sd["active"], bool)
    n = int(act.sum())
    height = max(int(sd["height"]), 1)
    reads = int(np.where(np.asarray(sd["cache_hit"])[act], 1, height).sum())
    splits = int(np.asarray(sd["split_lane"])[act].sum())
    assert splits > 0
    for feat in (TN.SHERMAN, TN.FG_PLUS):
        if feat.hierarchical:
            cas = int(sd["hocl_remote_cas"])
            unlocks = int(np.asarray(sd["chain_end"])[act].sum())
        else:
            cas, unlocks = int(sd["flat_remote_cas"]), n
        priced = TN.price_write_phase(sd, feat, TN.NetConfig(), CFG)
        assert priced["msgs"] == reads + cas + n + 2 * splits + unlocks
        assert priced["cas_msgs"] == cas
        assert np.isfinite(priced["latency_s"]).all()
