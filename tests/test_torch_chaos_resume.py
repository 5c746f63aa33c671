"""PyTorch port of the chaos plane against the reference, on the CPU: the
checkpoint-backed paths — a memory-losing crash restored from its
checkpoint and replayed, resumes (tick for tick, across a memory-losing
crash, and across packages in both directions), the recorder's fault
markers, the standard schedule and ``chaos_sweep``.

Everything a run leaves behind is held equal to the reference's
(:func:`torch_chaos_common.assert_same_run`), and the two packages'
snapshot directories hold the same bytes.
"""
import dataclasses
import json
import os
import shutil

import pytest

from repro.chaos import bench as JB
from repro.chaos import faults as JF
from repro.obs import Recorder as JRecorder, to_chrome_trace as j_chrome
from repro_torch.chaos import bench as TB
from repro_torch.chaos import faults as TF
from repro_torch.obs import Recorder as TRecorder, to_chrome_trace as t_chrome
from torch_chaos_common import (assert_same_run, assert_same_state,
                                one_torch_thread, run_pair, runner_pair,
                                undonated_reference)

pytestmark = pytest.mark.chaos


@pytest.fixture(scope="module", autouse=True)
def undonated():
    with undonated_reference(), one_torch_thread():
        yield


@pytest.fixture(scope="module")
def baseline():
    """The fault-free sherman runs of both packages."""
    return run_pair("sherman")


def _horizon(baseline) -> float:
    return baseline[0].cluster.counters["sim_time_s"]


def _tree(d) -> dict:
    out = {}
    for root, _, files in os.walk(d):
        for n in files:
            p = os.path.join(root, n)
            out[os.path.relpath(p, d)] = open(p, "rb").read()
    return out


def _crash(h, at, ms, down):
    return dict(kind="ms_crash", at_s=at * h, ms=ms, down_s=down * h,
                lose_memory=True)


def test_lose_memory_restores_and_replays_as_reference(tmp_path, baseline):
    rj, rt = run_pair("sherman", (_crash(_horizon(baseline), 0.55, 1, 0.03),),
                      ckpt=str(tmp_path), every=2)
    assert_same_run(rj, rt)
    crash = [f for f in rt.fault_log if f["kind"] == "ms_crash"]
    assert len(crash) == 1 and crash[0]["replayed_waves"] >= 1
    # the same snapshots, byte for byte
    assert _tree(tmp_path / "port") == _tree(tmp_path / "ref")
    assert len(rt.mgr.steps()) == 4


def _resume(tmp_path, tag, faults, until=3):
    """Both packages: run to ``until``, then a fresh runner resumes from
    the newest snapshot and finishes.  Returns the resumed runners and
    the digest counts of the interrupted runs."""
    first = runner_pair("sherman", faults, ckpt=str(tmp_path / tag), every=3)
    for r in first:
        r.run(until_round=until)
    n_dig = [len(r.cluster.trace_log) for r in first]
    second = runner_pair("sherman", faults, ckpt=str(tmp_path / tag),
                         every=3, record=False)
    for r in second:
        assert r.load_latest() == until
        r.cluster.record_traces()
        r.run()
    return second, n_dig


def test_resume_tick_for_tick_equals_reference(tmp_path, baseline):
    (rj, rt), (nj, nt) = _resume(tmp_path, "tick", ())
    assert nj == nt
    assert_same_run(rj, rt)
    assert rt.cluster.trace_log == baseline[1].cluster.trace_log[nt:]
    assert rt.cluster.counters == baseline[1].cluster.counters
    assert_same_state(baseline[0].cluster.state, rt.cluster.state)


def test_resume_across_a_memory_losing_crash_equals_reference(tmp_path,
                                                              baseline):
    faults = (_crash(_horizon(baseline), 0.7, 0, 0.01),)
    whole = run_pair("sherman", faults, ckpt=str(tmp_path / "whole"),
                     every=3)
    assert_same_run(*whole)
    (rj, rt), _ = _resume(tmp_path, "resumed", faults)
    assert_same_run(rj, rt)
    assert rt.fault_log == whole[1].fault_log
    assert rt.cluster.counters == whole[1].cluster.counters
    assert_same_state(whole[0].cluster.state, rt.cluster.state)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_snapshot_resumes_across_packages(tmp_path, baseline, writer):
    """A round-3 snapshot written by one package's runner resumes in a
    fresh runner of the other, which goes on with the writer's
    uninterrupted digests, counters and final tree: the cache images, the
    JSON side record and the RNG states cross over."""
    rj, rt = runner_pair("sherman", ckpt=str(tmp_path / "w"), every=3)
    w = rj if writer == "reference" else rt
    w.run(until_round=3)
    n_dig = len(w.cluster.trace_log)
    src = w.mgr.dir
    dst = {"reference": tmp_path / "port", "port": tmp_path / "ref"}[writer]
    shutil.copytree(src, dst)
    sj, st = runner_pair("sherman", ckpt=str(tmp_path), every=0,
                         record=False)
    r = st if writer == "reference" else sj
    assert r.load_latest() == 3
    r.cluster.record_traces()
    r.run()
    want = baseline[0]
    assert r.cluster.trace_log == want.cluster.trace_log[n_dig:]
    assert r.cluster.counters == want.cluster.counters
    assert r.samples == want.samples and r.report() == want.report()
    assert_same_state(want.cluster.state, r.cluster.state)


def test_recorder_fault_markers_equal_reference(tmp_path, baseline):
    h = _horizon(baseline)
    sched = [dataclasses.asdict(e) for e in TF.schedule_for_horizon(h, cs=1)]
    assert sched == [dataclasses.asdict(e)
                     for e in JF.schedule_for_horizon(h, cs=1)]
    recs = (JRecorder(), TRecorder())
    rj, rt = run_pair("sherman", sched, ckpt=str(tmp_path), every=4,
                      recorders=recs)
    assert_same_run(rj, rt)
    assert {f["kind"] for f in rt.fault_log} == {"ms_crash", "cs_leave",
                                                 "cs_join", "skew_shift"}
    assert rt.report()["unfired_faults"] == 0
    assert recs[1].faults == recs[0].faults and len(recs[1].faults) == 5
    assert json.dumps(t_chrome(recs[1])) == json.dumps(j_chrome(recs[0]))


def test_chaos_sweep_payload_equals_reference(tmp_path):
    kw = dict(records=2_000, ops=640, n_clients=32)
    want = JB.chaos_sweep(out=str(tmp_path / "ref.json"), **kw)
    got = TB.chaos_sweep(out=str(tmp_path / "port.json"), device="cpu", **kw)
    assert got == want
    assert open(tmp_path / "port.json", "rb").read() == \
        open(tmp_path / "ref.json", "rb").read()
    for row in got["results"]:
        assert row["oracle_ok"] and row["unfired_faults"] == 0
