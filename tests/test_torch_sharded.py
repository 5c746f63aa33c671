"""PyTorch port, the mesh-sharded index (``repro_torch.core.sharded`` on
``torch.distributed``) against the reference (``repro.core.sharded``).

The reference runs in a subprocess with 8 virtual CPU devices
(``XLA_FLAGS`` must precede its JAX import, as in
``tests/test_distributed_subprocess.py``) and writes its outputs to an
``.npz``; meanwhile the port runs as gloo ranks on the CPU, one spawn per
mesh, (2, 4) and (1, 4).  Every case compares exactly: the routed
lookups' ``value``, ``found``, ``consistent`` and ``leaf`` (present and
absent keys, a torn node, a torn entry, caches too shallow to reach a
leaf), and after each pjit write wave (the reference test's, one that
splits leaves, one with deletes, and one chained on the split wave's
state and repair queue) every block, ``done``, ``stats`` and the repair
queue, against the reference's and the single-process port's
``write_phase``.  A failing or hung rank makes the launch raise.
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import torch_sharded_common as C
from repro_torch.core import sharded as S
from repro_torch.core.tree import (TreeConfig, TreeState, bulkload,
                                   state_from_numpy, state_to_numpy)
from repro_torch.core.write import RepairQueue, WriteStats, write_phase
from repro_torch.launch.mesh import run_mesh, start_mesh

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
RANK_TIMEOUT = 150.0

REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np, jax, jax.numpy as jnp
from repro.core import ShermanIndex, TreeConfig
from repro.core import sharded as S
from repro.core.tree import TreeState
from repro.core.write import RepairQueue
from repro.launch.mesh import make_host_mesh
import torch_sharded_common as C

cfg = TreeConfig(**C.CFG_KW)
keys, vals, wk, wv = C.draw_records()
idx = ShermanIndex.build(cfg, keys, vals)
base = {n: np.asarray(x) for n, x in zip(TreeState._fields, idx.state)}
states, lookups, waves = C.make_cases(base, keys, vals, wk, wv)
jstate = lambda name: TreeState(**{n: jnp.asarray(x)
                                   for n, x in states[name].items()})
out = {f"S|{n}": x for n, x in base.items()}
for shape in C.MESHES:
    mesh, tag, fns = make_host_mesh(*shape), C.tag(shape), {}
    for name, sname, depth, q in lookups:
        st = jstate(sname)
        if depth not in fns:
            fns[depth] = S.routed_lookup_fn(cfg, mesh, depth=depth)
        fn = fns[depth]
        with mesh:
            r = fn(S.shard_tree(st, mesh, cfg),
                   S.build_cache(cfg, st, depth=depth), jnp.asarray(q))
        for f in r._fields:
            out[f"L|{tag}|{name}|{f}"] = np.asarray(getattr(r, f))
    wp = S.pjit_phase_fns(cfg, mesh)
    carried = {}
    for name, parent, w in waves:
        if parent is None:
            st, rq = S.shard_tree(jstate("base"), mesh, cfg), \
                RepairQueue.empty(C.B)
        else:
            st, rq = carried[parent]
        with mesh:
            st, done, stats, rq = wp(st, *(jnp.asarray(w[k]) for k in (
                "keys", "vals", "is_delete", "active", "cs")), rq)
        # carried over as host values, which the compiled wave takes as
        # it takes fresh ones (the same values, no second compile)
        carried[name] = (
            S.shard_tree(TreeState(*(np.asarray(x) for x in st)), mesh, cfg),
            RepairQueue(*(jnp.asarray(np.asarray(x)) for x in rq)))
        p = f"W|{tag}|{name}|"
        out[p + "done"] = np.asarray(done)
        for part, tree in (("st", st), ("stats", stats), ("rq", rq)):
            for f, x in zip(tree._fields, tree):
                out[f"{p}{part}.{f}"] = np.asarray(x)
out["clamp"] = np.array([tuple(make_host_mesh(*s).shape.values())
                         for s in C.CLAMPS])
np.savez(sys.argv[1], **out)
print("reference-ok")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's outputs, the port's ranks' results on both meshes,
    and the cases; the reference subprocess and the port's spawns run at
    the same time."""
    path = str(tmp_path_factory.mktemp("sharded") / "reference.npz")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, HERE]))
    ref = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, path], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        cfg = TreeConfig(**C.CFG_KW)
        keys, vals, wk, wv = C.draw_records()
        st = bulkload(cfg, keys, vals, device="cpu")
        base = dict(zip(TreeState._fields, state_to_numpy(st)))
        states, lookups, waves = C.make_cases(base, keys, vals, wk, wv)
        port = {}
        for shape in C.MESHES:
            big = shape == (2, 4)
            port[shape] = run_mesh(
                C.sharded_rank, *shape, backend="gloo", device="cpu",
                timeout=RANK_TIMEOUT, args=(states, lookups, waves,
                                            C.CLAMPS if big else (),
                                            not big))
        so, se = ref.communicate(timeout=RANK_TIMEOUT)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0 and "reference-ok" in so, se[-3000:]
    return dict(ref=dict(np.load(path)), port=port, states=states,
                lookups={n: (s, d, q) for n, s, d, q in lookups},
                waves={n: (p, w) for n, p, w in waves})


def _rank_rows(res, shape):
    """Ranks by data index, each row its mem ranks (rank = i * m + j)."""
    d, m = shape
    return [[res[i * m + j] for j in range(m)] for i in range(d)]


def _same(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


def test_same_bulkload(runs):
    for n, x in runs["states"]["base"].items():
        _same(x, runs["ref"][f"S|{n}"], n)


@pytest.mark.parametrize("case", C.LOOKUPS)
@pytest.mark.parametrize("shape", C.MESHES, ids=C.tag)
def test_routed_lookup(runs, shape, case):
    rows = _rank_rows(runs["port"][shape], shape)
    ref = runs["ref"]
    for f in ("value", "found", "consistent", "leaf"):
        shards = [[getattr(r["lookup"][case], f) for r in row]
                  for row in rows]
        for row in shards:          # identical across the mem row
            for x in row[1:]:
                _same(x, row[0], f"{case}.{f} across the mem row")
        got = np.concatenate([row[0] for row in shards])
        _same(got, ref[f"L|{C.tag(shape)}|{case}|{f}"], f"{case}.{f}")
    found = np.concatenate([row[0]["lookup"][case].found for row in rows])
    cons = np.concatenate([row[0]["lookup"][case].consistent
                           for row in rows])
    if case == "present":          # the reference test's own check
        assert found.all()
    if case.startswith("shallow") or case == "absent":
        assert not found.any()
    if case.startswith("torn"):
        assert not cons.all() and cons.any()


def _single_process(runs, wave):
    """The single-pool port's write_phase on the whole pool and wave."""
    cfg = TreeConfig(**C.CFG_KW)
    parent, w = runs["waves"][wave]
    if parent is None:
        st = state_from_numpy(runs["states"]["base"], "cpu")
        rq = RepairQueue.empty(C.B, "cpu")
    else:
        st, _, _, rq = _single_process(runs, parent)
    t = lambda k: torch.from_numpy(np.ascontiguousarray(w[k]))
    return write_phase(cfg, st, t("keys"), t("vals"), t("is_delete"),
                       t("active"), t("cs"), rq)


@pytest.mark.parametrize("wave", C.WAVES)
@pytest.mark.parametrize("shape", C.MESHES, ids=C.tag)
def test_pjit_write_wave(runs, shape, wave):
    rows = _rank_rows(runs["port"][shape], shape)
    ref, p = runs["ref"], f"W|{C.tag(shape)}|{wave}|"
    outs = [[r["wave"][wave] for r in row] for row in rows]
    st1, done1, stats1, rq1 = _single_process(runs, wave)
    specs = S.tree_pspecs(TreeConfig(**C.CFG_KW))
    for f, spec in zip(TreeState._fields, specs):
        blocks = [[getattr(o["block"], f) for o in row] for row in outs]
        for row in blocks[1:]:      # identical across the data column
            for x, y in zip(row, blocks[0]):
                _same(x, y, f"{f} across the data column")
        if spec:                    # the mem ranks' blocks, in order
            got = np.concatenate(blocks[0])
        else:                       # replicated: the same on every rank
            for x in blocks[0][1:]:
                _same(x, blocks[0][0], f)
            got = blocks[0][0]
        _same(got, ref[p + "st." + f], f"state.{f}")
        _same(got, getattr(st1, f).numpy(), f"state.{f} (single process)")
    for part, fields, one in (("stats", WriteStats._fields, stats1),
                              ("rq", RepairQueue._fields, rq1)):
        for f in fields:
            per = [[getattr(o[part], f) for o in row] for row in outs]
            for row in per:
                for x in row[1:]:
                    _same(x, row[0], f"{part}.{f} across the mem row")
            if per[0][0].ndim:
                got = np.concatenate([row[0] for row in per])
            else:
                got = per[0][0]
            _same(got, ref[f"{p}{part}.{f}"], f"{part}.{f}")
            _same(got, getattr(one, f).numpy(), f"{part}.{f} (single)")
    done = np.concatenate([row[0]["done"] for row in outs])
    _same(done, ref[p + "done"], "done")
    _same(done, done1.numpy(), "done (single process)")
    if wave in ("reference", "splits", "chained"):
        assert int(ref[p + "stats.n_leaf_splits"]) > 0
    if wave == "deletes":
        assert ref[p + "stats.applied_delete"].any()
        assert ref[p + "stats.miss_delete"].any()


def test_make_host_mesh_clamps_like_the_reference(runs):
    got = [list(s) for s in runs["port"][(2, 4)][0]["clamp"]]
    assert got == runs["ref"]["clamp"].tolist()


def test_rank_layout_is_row_major(runs):
    for shape in C.MESHES:
        coords = [r["coords"] for r in runs["port"][shape]]
        assert coords == [dict(data=r // shape[1], model=r % shape[1])
                          for r in range(shape[0] * shape[1])]


def test_model_ne_n_ms_raises(runs):
    for msg in runs["port"][(1, 4)][0]["guard"]:
        assert msg is not None and "cfg.n_ms is 4" in msg


def _boom(mesh):
    if mesh.rank == 1:
        raise ValueError("rank one gives up")
    return mesh.rank


def _hang(mesh):
    if mesh.rank == 1:
        time.sleep(3600)
    return mesh.rank


def test_failing_rank_raises_with_its_traceback():
    with pytest.raises(RuntimeError, match="rank one gives up"):
        run_mesh(_boom, 1, 2, backend="gloo", device="cpu", timeout=60)


def test_hung_rank_raises_instead_of_hanging():
    t0 = time.monotonic()
    ranks = start_mesh(_hang, 1, 2, backend="gloo", device="cpu", timeout=4)
    with pytest.raises(TimeoutError, match=r"ranks \[(0, )?1\]"):
        ranks.join()
    assert time.monotonic() - t0 < 60
    assert not any(p.is_alive() for p in ranks.procs)


def test_sharded_modules_import_no_jax():
    code = ("import sys, repro_torch.core.sharded, repro_torch.launch, "
            "repro_torch.launch.mesh; bad = [m for m in sys.modules if "
            "m == 'jax' or m.startswith(('jax.', 'jaxlib')) or m == 'repro' "
            "or m.startswith('repro.')]; print(bad); assert not bad")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _sum_rows(mesh, big):
    return int(big[mesh.rank::2].sum())


def test_ranks_take_arguments_larger_than_a_pipe():
    """A megabyte of arguments reaches every rank (it crosses a queue
    whose feeder must outlive start_mesh's frame)."""
    big = np.arange(1 << 18, dtype=np.int32)
    got = run_mesh(_sum_rows, 1, 2, backend="gloo", device="cpu",
                   args=(big,), timeout=60)
    assert got == [int(big[0::2].sum()), int(big[1::2].sum())]
