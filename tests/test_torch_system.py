"""PyTorch port, the slice as a whole: the four end-to-end scenarios of
tests/test_system.py and a YCSB ``run_workload`` on both packages, with
lookups, counters, latency and write-bytes arrays and the RunResult
compared exactly; the load-phase recipe; the CLI; the import boundary
(no JAX, no reference package); and the CUDA default of every entry point.
"""
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.api as JA
import repro.workloads as JWL
from repro.core import FG_PLUS as J_FG, SHERMAN as J_SH
from repro.core import OracleIndex, ShermanIndex as JIndex
from repro.core import TreeConfig as JCfg
from repro.core import write as JW
import repro_torch.workloads as TWL
from repro_torch.core import FG_PLUS as T_FG, SHERMAN as T_SH
from repro_torch.core import ShermanIndex as TIndex
from repro_torch.core import TreeConfig as TCfg
from repro_torch.core.tree import state_to_numpy
from repro_torch.workloads import cli, jitstats

SYS_CFG = dict(n_ms=4, nodes_per_ms=1024, fanout=16, n_locks_per_ms=1024,
               max_height=7, n_cs=4)

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


class Both:
    """One index in each package; every call goes to both and must agree."""

    def __init__(self, keys, vals, j_feat=J_SH, t_feat=T_SH):
        self.j = JIndex.build(JCfg(**SYS_CFG), keys, vals, features=j_feat)
        self.t = TIndex.build(TCfg(**SYS_CFG), keys, vals, features=t_feat,
                              device="cpu")

    def __getattr__(self, name):
        def call(*args, **kw):
            a = getattr(self.j, name)(*args, **kw)
            b = getattr(self.t, name)(*args, **kw)
            if isinstance(a, tuple):
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(x, y, err_msg=name)
            else:
                assert a == b, name
            assert self.j.counters == self.t.counters, name
            return b
        return call

    def check(self):
        ref = jax.tree_util.tree_map(np.asarray, self.j.state)
        for name, a, b in zip(ref._fields, ref, state_to_numpy(self.t.state)):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        for name in ("latencies_write", "latencies_read",
                     "doorbells_write", "write_bytes"):
            a, b = getattr(self.j, name), getattr(self.t, name)
            assert len(a) == len(b), name
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y, err_msg=name)
        assert self.j.throughput_mops() == self.t.throughput_mops()
        assert self.j.latency_percentiles() == self.t.latency_percentiles()


# -- the four scenarios of tests/test_system.py -----------------------------

def test_ycsb_mix_end_to_end(undonated):
    rng = np.random.default_rng(11)
    base = rng.choice(1 << 18, size=5_000, replace=False)
    idx = Both(base, base * 7)
    oracle = OracleIndex()
    oracle.insert_batch(base, base * 7)
    for _ in range(6):
        hot = rng.integers(0, 64, 128)
        cold = rng.integers(0, 1 << 18, 128)
        keys = np.concatenate([hot, cold]).astype(np.int32)
        rng.shuffle(keys)
        idx.lookup(keys[:128])
        vals = rng.integers(0, 1 << 20, 128).astype(np.int32)
        idx.insert(keys[128:], vals)
        oracle.insert_batch(keys[128:], vals)
    items = oracle.items()
    keys = np.asarray([k for k, _ in items[:2000]])
    got, found = idx.lookup(keys)
    assert found.all()
    assert (got == np.asarray([v for _, v in items[:2000]])).all()
    idx.check()
    assert idx.t.counters["handovers"] > 0


def test_sherman_beats_fg_on_skewed_writes(undonated):
    rng = np.random.default_rng(12)
    base = rng.choice(1 << 18, size=5_000, replace=False)
    hot = rng.integers(0, 32, size=2_048).astype(np.int32)
    results = {}
    for name, jf, tf in (("fg", J_FG, T_FG), ("sherman", J_SH, T_SH)):
        idx = Both(base, base, jf, tf)
        idx.insert(hot, hot)
        idx.check()
        results[name] = (idx.t.throughput_mops(),
                         idx.t.latency_percentiles()[99])
    assert results["sherman"][0] > 5 * results["fg"][0]
    assert results["sherman"][1] < results["fg"][1] / 5


def test_write_bytes_two_level_versions(undonated):
    rng = np.random.default_rng(13)
    base = rng.choice(1 << 18, size=5_000, replace=False)
    keys = base[:512].astype(np.int32)
    for jf, tf, want in ((J_SH, T_SH, "entry_bytes"),
                         (J_FG, T_FG, "node_bytes")):
        idx = Both(base, base, jf, tf)
        idx.insert(keys, keys)
        idx.check()
        assert np.median(np.concatenate(idx.t.write_bytes)) == \
            getattr(TCfg(**SYS_CFG), want)


def test_paged_kv_page_table_roundtrip(undonated):
    table = Both(np.zeros(0, np.int32), np.zeros(0, np.int32))
    keys = np.asarray([s * 4096 + p for s in range(8) for p in range(4)],
                      np.int32)
    slots = np.arange(len(keys), dtype=np.int32)
    table.insert(keys, slots)
    got, found = table.lookup(keys)
    assert found.all() and (got == slots).all()
    rk, rv, rn = table.range(np.asarray([3 * 4096], np.int32), count=4,
                             max_leaves=16)
    mine = [int(k) for k in rk[0][:rn[0]] if k // 4096 == 3]
    assert len(mine) == 4
    table.delete(np.asarray(mine, np.int32))
    _, found = table.lookup(np.asarray(mine, np.int32))
    assert not found.any()
    table.check()


# -- the YCSB engine ---------------------------------------------------------

@pytest.mark.parametrize("system", ["sherman", "fg+"])
def test_run_workload_result_equals_reference(undonated, system):
    spec = JWL.get_preset("ycsb-a", load_records=4_000, ops=2_048,
                          batch=512, theta=0.99)
    want = JWL.run_systems(spec, (system,))[0].to_dict()
    got = TWL.run_systems(TWL.get_preset("ycsb-a", load_records=4_000,
                                         ops=2_048, batch=512, theta=0.99),
                          (system,), device="cpu")[0].to_dict()
    assert want == got


def test_load_phase_recipe_and_live_records():
    """Chunked generation gives the single draw's keys and values, and the
    port's load phase builds the reference's tree."""
    keys, vals = TWL.engine.load_arrays(1_000, seed=4, device="cpu",
                                        chunk=333)
    rng = np.random.default_rng(4)
    want_k = TWL.scramble(np.arange(1_000, dtype=np.int64), TWL.KEYSPACE)
    want_v = rng.integers(0, TWL.engine.VAL_MASK, size=1_000)
    np.testing.assert_array_equal(keys.numpy(), want_k.astype(np.int32))
    np.testing.assert_array_equal(vals.numpy(), want_v.astype(np.int32))
    j = JWL.build_index(JWL.SYSTEMS["sherman"], records=1_000)
    t = TWL.build_index(TWL.SYSTEMS["sherman"], records=1_000, device="cpu")
    for name, a, b in zip(t.state._fields,
                          jax.tree_util.tree_map(np.asarray, j.state),
                          state_to_numpy(t.state)):
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert JWL.live_records(j) == TWL.live_records(t) == 1_000


def test_cli_runs_on_the_cpu_and_refuses_unported_planes(tmp_path, capsys):
    out = tmp_path / "out.json"
    cli.main(["--preset", "write-intensive", "--quick", "--ops", "512",
              "--device", "cpu", "--json", str(out)])
    payload = json.loads(out.read_text())
    assert [r["system"] for r in payload["results"]] == ["sherman", "fg+"]
    assert all(r["mops"] > 0 for r in payload["results"])
    # the planes' flags are ported: the CLI checks them as the
    # reference's does, and no longer refuses them as not ported
    for flag, says in ((["--partitioned"], "--partitioned requires"),
                       (["--n-clients", "4", "--arrival", "poisson"],
                        "--arrival requires a positive --rate"),
                       (["--rate", "1"], "--rate only makes sense")):
        with pytest.raises(SystemExit):
            cli.main(["--preset", "ycsb-a", "--device", "cpu", *flag])
        err = capsys.readouterr().err
        assert says in err and "not ported" not in err
    with jitstats.count_compiles() as stats:
        pass
    assert not stats.available and stats.count == -1


def test_entry_points_default_to_cuda(monkeypatch):
    """Without a card every entry point that defaults to CUDA raises
    instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TCfg(**SYS_CFG)
    spec = TWL.get_preset("ycsb-a", load_records=100, ops=16, batch=16)
    calls = [lambda: TIndex.build(cfg, np.arange(10), np.arange(10)),
             lambda: TIndex.empty(cfg),
             lambda: TWL.build_index(T_SH, cfg, records=100),
             lambda: TWL.run_systems(spec, ("sherman",)),
             lambda: TWL.run_cluster_systems(spec, ("sherman",),
                                             n_clients=8),
             lambda: TWL.run_open_loop_systems(
                 spec.replace(arrival="poisson", offered_mops=1.0),
                 ("sherman",), n_clients=8),
             lambda: cli.main(["--preset", "ycsb-a", "--quick"]),
             lambda: cli.main(["--preset", "ycsb-a", "--quick",
                               "--n-clients", "8"])]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_port_imports_neither_jax_nor_the_reference():
    code = ("import sys, repro_torch.workloads, repro_torch.core, "
            "repro_torch.kernels.leaf_search.ops, repro_torch.configs, "
            "repro_torch.models.registry, "
            "repro_torch.kernels.flash_attention.ops, "
            "repro_torch.kernels.rwkv_scan.ops, repro_torch.cluster, "
            "repro_torch.serve, repro_torch.obs\n"
            "from repro_torch.configs import get\n"
            "[get(n) for n in repro_torch.configs.ALL_ARCHS]\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"},
                         cwd=__file__.rsplit("/tests/", 1)[0])
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_card_test_module_imports_neither_jax_nor_the_reference():
    """tests/test_torch_cuda.py must be collectable on a GPU host that has
    no JAX."""
    code = ("import sys, test_torch_cuda\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env={"PYTHONPATH": "src:tests",
                              "PATH": "/usr/bin:/bin"},
                         cwd=__file__.rsplit("/tests/", 1)[0])
    assert out.stdout.strip() == "[]", out.stdout + out.stderr
