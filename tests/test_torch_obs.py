"""PyTorch port of the observability plane against the reference, on the
CPU: the recorded ``Segment``s, ``span_accounting``, ``attribute_ops``,
``summarize``, ``timeseries`` and the Chrome trace of a single-frontend
run and of a cluster run are equal to the reference's; recording is
neutral on the port (closed loop, cluster and open loop); and the port's
CLI records and writes a trace.  The reference's write and repair phases
run undonated (both ``_jit_write_phase`` bindings patched).
"""
import dataclasses
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.cluster.sched as JS
import repro.core.api as JA
import repro.obs as JOBS
import repro.workloads as JWL
from repro.core import TreeConfig as JCfg
from repro.core import write as JW
import repro_torch.obs as TOBS
import repro_torch.workloads as TWL
from repro_torch.core import TreeConfig as TCfg

CFG = dict(n_ms=2, nodes_per_ms=1024, fanout=8, n_locks_per_ms=512,
           max_height=6, n_cs=4)
TINY = dict(load_records=2_000, ops=256, batch=128)
ROOT = __file__.rsplit("/tests/", 1)[0]

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


def assert_same_recording(j, t):
    """Every captured segment field for field (dtypes too), then every
    analysis built on them."""
    assert j.n_segments == t.n_segments > 0
    assert j.faults == t.faults
    for i, (a, b) in enumerate(zip(j.segments, t.segments)):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype, (i, f.name)
                np.testing.assert_array_equal(x, y, err_msg=f"{i} {f.name}")
            else:
                assert x == y, (i, f.name)
    assert JOBS.span_accounting(j) == TOBS.span_accounting(t)
    assert JOBS.attribute_ops(j) == TOBS.attribute_ops(t)
    assert JOBS.attribute_ops(j, top_k=5) == TOBS.attribute_ops(t, top_k=5)
    assert JOBS.summarize(j, tail_k=8) == TOBS.summarize(t, tail_k=8)
    assert JOBS.timeseries(j, buckets=16) == TOBS.timeseries(t, buckets=16)
    assert json.dumps(JOBS.to_chrome_trace(j)) == \
        json.dumps(TOBS.to_chrome_trace(t))


def test_run_workload_recording_equals_reference(undonated):
    recs_j, recs_t = {}, {}
    want = JWL.run_systems(JWL.get_preset("ycsb-a", **TINY), ("sherman",),
                           JCfg(**CFG), recorders=recs_j, tail_k=8)[0]
    got = TWL.run_systems(TWL.get_preset("ycsb-a", **TINY), ("sherman",),
                          TCfg(**CFG), recorders=recs_t, tail_k=8,
                          device="cpu")[0]
    assert want.to_dict() == got.to_dict()
    assert got.obs["spans_ok"] and got.obs["attr_residual_ps"] == 0
    assert {s.label for s in recs_t["sherman"].segments} >= {"read",
                                                             "write"}
    assert_same_recording(recs_j["sherman"], recs_t["sherman"])


@pytest.mark.parametrize("system", ["sherman", "fg+"])
def test_cluster_recording_equals_reference(undonated, system):
    recs_j, recs_t = {}, {}
    want = JWL.run_cluster_systems(
        JWL.get_preset("write-intensive", **TINY), (system,), JCfg(**CFG),
        n_clients=8, recorders=recs_j, tail_k=8)[0]
    got = TWL.run_cluster_systems(
        TWL.get_preset("write-intensive", **TINY), (system,), TCfg(**CFG),
        n_clients=8, recorders=recs_t, tail_k=8, device="cpu")[0]
    assert want.to_dict() == got.to_dict()
    assert_same_recording(recs_j[system], recs_t[system])
    assert any((s.cs >= 0).any() for s in recs_t[system].segments)


def test_write_chrome_trace_file_equals_reference(undonated, tmp_path):
    recs_j, recs_t = {}, {}
    ol = dict(arrival="poisson", offered_mops=1.0)
    JWL.run_open_loop_systems(JWL.get_preset("ycsb-a", **TINY).replace(**ol),
                              ("sherman",), JCfg(**CFG), n_clients=8,
                              recorders=recs_j)
    TWL.run_open_loop_systems(TWL.get_preset("ycsb-a", **TINY).replace(**ol),
                              ("sherman",), TCfg(**CFG), n_clients=8,
                              recorders=recs_t, device="cpu")
    assert all(s.clocked for s in recs_t["sherman"].segments)
    assert_same_recording(recs_j["sherman"], recs_t["sherman"])
    a = JOBS.write_chrome_trace(recs_j["sherman"], str(tmp_path / "j.json"))
    b = TOBS.write_chrome_trace(recs_t["sherman"], str(tmp_path / "t.json"))
    with open(a) as fa, open(b) as fb:
        assert fa.read() == fb.read()


def _same_but_obs(a, b):
    da, db = a.to_dict(), b.to_dict()
    da.pop("obs"), db.pop("obs")
    assert da == db


def test_recording_is_neutral_on_the_port():
    """A Recorder is a pure observation on every plane of the port."""
    cfg = TCfg(**CFG)
    spec = TWL.get_preset("ycsb-a", **TINY)
    recs = {}
    base = TWL.run_systems(spec, ("sherman",), cfg, device="cpu")[0]
    on = TWL.run_systems(spec, ("sherman",), cfg, device="cpu",
                         recorders=recs, tail_k=4)[0]
    _same_but_obs(base, on)
    assert base.obs == {} and on.obs["verbs"] == recs["sherman"].n_verbs
    kw = dict(n_clients=8, device="cpu")
    wi = TWL.get_preset("write-intensive", **TINY)
    _same_but_obs(TWL.run_cluster_systems(wi, ("fg+",), cfg, **kw)[0],
                  TWL.run_cluster_systems(wi, ("fg+",), cfg, recorders={},
                                          **kw)[0])
    ol = spec.replace(arrival="bursty", offered_mops=1.0)
    _same_but_obs(TWL.run_open_loop_systems(ol, ("sherman",), cfg, **kw)[0],
                  TWL.run_open_loop_systems(ol, ("sherman",), cfg,
                                            recorders={}, **kw)[0])


def test_cli_records_an_open_loop_trace(tmp_path):
    trace = tmp_path / "run.trace.json"
    out = tmp_path / "out.json"
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.workloads", "--preset", "ycsb-a",
         "--quick", "--ops", "256", "--records", "2000", "--systems",
         "sherman", "--n-clients", "16", "--arrival", "poisson", "--rate",
         "0.5", "--record-trace", str(trace), "--tail-k", "4", "--device",
         "cpu", "--json", str(out)],
        capture_output=True, text=True, cwd=ROOT,
        env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"})
    assert run.returncode == 0, run.stderr
    assert "open loop: poisson @ 0.50 Mops" in run.stdout
    assert f"trace: {trace}" in run.stdout
    doc = json.loads(trace.read_text())
    assert {"X", "M"} <= {e["ph"] for e in doc["traceEvents"]}
    (res,) = json.loads(out.read_text())["results"]
    assert res["arrival"] == "poisson" and res["n_clients"] == 16
    assert res["obs"]["spans_ok"] and len(res["obs"]["tail"]) == 4
