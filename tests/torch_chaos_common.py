"""Shared set-up of the chaos plane's parity tests (not a test module).

``tests/test_torch_chaos.py`` and ``tests/test_torch_chaos_resume.py``
run the reference's :class:`repro.chaos.ChaosRunner` and the port's on the
same build recipe, seed and fault schedule, and compare everything a run
leaves behind: the fault log, the executed write log, the per-round
samples, ``report()``, the merged-trace digests wave for wave, the op
counts and the final tree byte for byte (dtypes included).

The geometry is ``tests/test_chaos.py``'s (its ``CFG``, 2,000 records,
the 640-op ``chaos-mix`` spec in batches of 128) with 32 client threads
(8 lanes a CS, 20 rounds) instead of its 8 (80 rounds), which keeps each
file well inside its time budget on one CPU process.

The reference's write and repair phases run undonated (its cache image
aliases the donated root under JAX 0.9): ``repro.core.api`` and
``repro.cluster.sched`` both bind ``_jit_write_phase``, and
``run_repair_drain`` looks ``_jit_repair`` up at call time.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.cluster.sched as JS
import repro.core.api as JA
from repro.chaos import ChaosRunner as JRunner
from repro.cluster import build_cluster as j_build
from repro.core import write as JW
from repro.core.netsim import FG_PLUS as J_FG, SHERMAN as J_SH
from repro.core.tree import TreeConfig as JCfg
from repro.workloads.spec import FaultEvent as JFault
from repro.workloads.spec import WorkloadSpec as JSpec
from repro_torch.chaos import ChaosRunner as TRunner
from repro_torch.cluster import build_cluster as t_build
from repro_torch.core.netsim import FG_PLUS as T_FG, SHERMAN as T_SH
from repro_torch.core.tree import TreeConfig as TCfg, state_to_numpy
from repro_torch.workloads.spec import FaultEvent as TFault
from repro_torch.workloads.spec import WorkloadSpec as TSpec

CFG = dict(n_ms=2, nodes_per_ms=1024, fanout=8, n_locks_per_ms=512,
           max_height=6, n_cs=4)
RECORDS = 2_000
N_CLIENTS = 32
MIX = dict(name="chaos-mix", read=0.3, update=0.3, insert=0.2, delete=0.1,
           rmw=0.1, load_records=RECORDS, ops=640, batch=128)
SYSTEMS = {"sherman": (J_SH, T_SH), "fg+": (J_FG, T_FG)}

_J_WRITE = jax.jit(JW.write_phase, static_argnums=(0,))
_J_REPAIR = jax.jit(lambda cfg, st, rq: JW.run_repair(cfg, st, rq, iters=2),
                    static_argnums=(0,))


def _j_repair_step(cfg, st, rq):
    st, rq, ni, nr = _J_REPAIR(cfg, st, rq)
    return st, rq, ni, nr, jnp.sum(rq.valid.astype(jnp.int32))


@contextlib.contextmanager
def undonated_reference():
    """The reference's write and repair phases, undonated (donation
    changes no value), for as long as the block runs."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JA, "_jit_write_phase", _J_WRITE)
        mp.setattr(JS, "_jit_write_phase", _J_WRITE)
        mp.setattr(JA, "_jit_repair", _j_repair_step)
        yield


@contextlib.contextmanager
def one_torch_thread():
    """The port's CPU ops on one intra-op thread for as long as the block
    runs.  The tier-1 run puts several test processes on the machine's
    cores, and the pool-sized ops of ``chaos_sweep``'s geometry slow down
    tenfold when every process also spreads them over all the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def build_pair(system="sherman"):
    """The two packages' clusters on ``test_chaos.py``'s recipe."""
    jf, tf = SYSTEMS[system]
    kw = dict(n_clients=N_CLIENTS, records=RECORDS, cache_bytes=4 << 20,
              sync_rounds=2)
    return (j_build(jf, JCfg(**CFG), **kw),
            t_build(tf, TCfg(**CFG), device="cpu", **kw))


def spec_pair(faults=(), **kw):
    """The chaos-mix spec in each package, with ``faults`` (FaultEvent
    keyword dicts) in each package's FaultEvent."""
    return (JSpec(**MIX, **kw).replace(
                faults=tuple(JFault(**f) for f in faults)),
            TSpec(**MIX, **kw).replace(
                faults=tuple(TFault(**f) for f in faults)))


def runner_pair(system="sherman", faults=(), *, ckpt=None, every=0,
                record=True, recorders=None, **kw):
    """Unstarted runners of both packages; ``ckpt`` is a directory under
    which each package gets its own checkpoint directory."""
    j, t = build_pair(system)
    if record:
        j.record_traces()
        t.record_traces()
    if recorders is not None:
        j.recorder, t.recorder = recorders
    sj, st = spec_pair(faults)
    dirs = (None, None) if ckpt is None else (f"{ckpt}/ref", f"{ckpt}/port")
    return (JRunner(j, sj, seed=1, ckpt_dir=dirs[0], ckpt_every=every, **kw),
            TRunner(t, st, seed=1, ckpt_dir=dirs[1], ckpt_every=every,
                    **kw))


def run_pair(system="sherman", faults=(), **kw):
    rj, rt = runner_pair(system, faults, **kw)
    return rj.run(), rt.run()


def _host_state(state):
    """Either package's tree as numpy arrays."""
    if isinstance(state.keys, torch.Tensor):
        return state_to_numpy(state)
    return jax.tree_util.tree_map(np.asarray, state)


def assert_same_state(j_state, t_state):
    """Two trees equal field for field, dtypes included (the second may
    be either package's)."""
    ref = _host_state(j_state)
    for name, a, b in zip(ref._fields, ref, _host_state(t_state)):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def assert_same_write_log(a, b):
    assert len(a) == len(b)
    for wave, ((ka, va, da), (kb, vb, db)) in enumerate(zip(a, b)):
        assert da == db, wave
        for side_a, side_b in ((ka, kb), (va, vb)):
            assert (side_a is None) == (side_b is None), wave
            if side_a is None:
                continue
            assert len(side_a) == len(side_b), wave
            for x, y in zip(side_a, side_b):
                assert (x is None) == (y is None), wave
                if x is not None:
                    x, y = np.asarray(x), np.asarray(y)
                    assert x.dtype == y.dtype, wave
                    np.testing.assert_array_equal(x, y, err_msg=str(wave))


def assert_same_run(rj, rt):
    """Everything a run leaves behind, held equal."""
    assert rt.fault_log == rj.fault_log
    assert_same_write_log(rj.write_log, rt.write_log)
    assert rt.samples == rj.samples
    assert rt.report() == rj.report()
    assert rt.op_counts == rj.op_counts
    assert (rt.done, rt.round_no, rt.alive) == (rj.done, rj.round_no,
                                                rj.alive)
    lj, lt = rj.cluster.trace_log, rt.cluster.trace_log
    if lj is not None:
        assert len(lt) == len(lj)
        for wave, (a, b) in enumerate(zip(lj, lt)):
            assert a == b, f"wave {wave}"
    assert rt.cluster.combined_counters() == rj.cluster.combined_counters()
    assert_same_state(rj.cluster.state, rt.cluster.state)
