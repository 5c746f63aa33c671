"""Shared set-up of the sharded index's tests (not a test module).

``tests/test_torch_sharded.py`` holds the port's mesh-sharded index
(:mod:`repro_torch.core.sharded` on ``torch.distributed`` ranks) against
the reference's (``repro.core.sharded`` on 8 virtual CPU devices), and
``tests/test_torch_cuda.py`` holds the same ranks on the card against the
CPU.  The geometry is ``tests/test_distributed_subprocess.py``'s: its
``TreeConfig``, 400 keys from ``default_rng(1)`` and its 64-lane write
wave.  Everything here is numpy at the top level, so the reference's
subprocess imports it without torch; the rank body imports the port.
"""
import numpy as np

CFG_KW = dict(n_ms=4, nodes_per_ms=256, fanout=8, n_locks_per_ms=512,
              max_height=6, n_cs=2)
B = 64                                  # lanes of every lookup and wave
MESHES = ((2, 4), (1, 4))
#: make_host_mesh requests on an 8-rank world and what each clamps to
CLAMPS = ((2, 8), (16, 1), (3, 3), (1, 2))
LOOKUPS = ("present", "absent", "torn_node", "torn_entry", "shallow1",
           "shallow2")
WAVES = ("reference", "splits", "deletes", "chained")


def tag(shape) -> str:
    return f"{shape[0]}x{shape[1]}"


def draw_records():
    """The reference test's draws, in its order: 400 records, then its
    wave's keys and values."""
    rng = np.random.default_rng(1)
    keys = rng.choice(50_000, size=400, replace=False)
    vals = rng.integers(0, 1 << 20, size=400)
    wk = rng.integers(0, 50_000, size=B)
    wv = rng.integers(0, 100, size=B)
    return keys, vals, wk, wv


def _leaf_slot(st: dict, key: int):
    rows, slots = np.nonzero((st["keys"] == key) & (st["level"] == 0)[:, None])
    return int(rows[0]), int(slots[0])


def make_cases(base: dict, keys, vals, wk, wv):
    """The lookup and wave cases on the bulkloaded state ``base`` (numpy
    fields): ``(states, lookups, waves)``.  ``states`` holds ``base`` and
    ``torn``, where the leaf of ``keys[0]`` has FNV != RNV and the entry of
    ``keys[1]`` FEV != REV; ``lookups`` is ``(name, state, depth, qkeys)``;
    ``waves`` is ``(name, parent wave or None, arrays)``."""
    rng = np.random.default_rng(2)
    i32 = np.int32
    torn = {k: v.copy() for k, v in base.items()}
    la, _ = _leaf_slot(base, keys[0])
    lb, sb = _leaf_slot(base, keys[1])
    torn["fnv"][la] = (torn["rnv"][la] + 1) % 16
    torn["fev"][lb, sb] = (torn["rev"][lb, sb] + 1) % 16
    in_torn = np.concatenate([base["keys"][la], base["keys"][lb]])
    in_torn = in_torn[in_torn >= 0]
    absent = np.setdiff1d(np.arange(50_000), keys)
    absent = rng.choice(absent, size=2 * B, replace=False)
    torn_q = np.concatenate([in_torn, rng.choice(keys, B - in_torn.size,
                                                 replace=False)])
    lookups = [
        ("present", "base", 3, keys[:B]),
        ("absent", "base", 3, absent[:B]),
        ("torn_node", "torn", 3, rng.permutation(torn_q)),
        ("torn_entry", "torn", 3, rng.permutation(torn_q)[::-1]),
        # the image stops above level 1 (depth 1) or at it (depth 2), so
        # every lane's frontier is an internal node, which must not answer
        ("shallow1", "base", 1, keys[B:2 * B]),
        ("shallow2", "base", 2, keys[2 * B:3 * B]),
    ]
    lookups = [(n, s, d, np.asarray(q, i32)) for n, s, d, q in lookups]

    def wave(k, v, is_delete=None, active=None, cs=None):
        return dict(keys=np.asarray(k, i32), vals=np.asarray(v, i32),
                    is_delete=np.zeros(B, bool) if is_delete is None
                    else is_delete,
                    active=np.ones(B, bool) if active is None else active,
                    cs=np.zeros(B, i32) if cs is None else cs.astype(i32))

    # deletes: present and absent keys, updates, a repeated key, idle lanes
    dk = np.concatenate([rng.choice(keys, B - 8, replace=False),
                         absent[B:B + 8]])
    dk[-1] = dk[0]
    waves = [
        ("reference", None, wave(wk, wv)),
        ("splits", None, wave(absent[B:2 * B], rng.integers(0, 1 << 20, B),
                              cs=rng.integers(0, 2, B))),
        ("deletes", None, wave(dk, rng.integers(0, 1 << 20, B),
                               is_delete=rng.random(B) < 0.5,
                               active=rng.random(B) > 0.1,
                               cs=rng.integers(0, 2, B))),
        # a second insert wave on the split wave's state and repair queue
        ("chained", "splits", wave(rng.choice(absent[:B], B, replace=False)
                                   + 50_000, rng.integers(0, 1 << 20, B),
                                   cs=rng.integers(0, 2, B))),
    ]
    return dict(base=base, torn=torn), lookups, waves


def sharded_rank(mesh, states, lookups, waves, clamps, guard):
    """One rank of the port's mesh: every lookup case, every wave, the
    clamped meshes and (``guard``) the ``model != n_ms`` refusal."""
    import torch
    from repro_torch.core import sharded as S
    from repro_torch.core.tree import TreeConfig, clone_state, \
        state_from_numpy
    from repro_torch.core.write import RepairQueue
    from repro_torch.kernels.leaf_search.kernel import leaf_search
    from repro_torch.launch.mesh import make_host_mesh

    cfg = TreeConfig(**CFG_KW)
    dev = mesh.device
    d, i = mesh.shape["data"], mesh.axis_index("data")

    def shard(x):
        n = len(x) // d
        return torch.from_numpy(np.ascontiguousarray(x[i * n:(i + 1) * n])
                                ).to(dev)

    out = dict(lookup={}, wave={}, coords=dict(mesh.coords))
    leaf_search.launches = 0
    for name, sname, depth, q in lookups:
        st = state_from_numpy(states[sname], dev)
        local = S.shard_tree(st, mesh, cfg)
        cache = S.build_cache(cfg, st, depth=depth)
        fn = S.routed_lookup_fn(cfg, mesh, depth=depth)
        out["lookup"][name] = fn(local, cache, shard(q))
    out["launches"] = leaf_search.launches
    wp = S.pjit_phase_fns(cfg, mesh)
    carried = {}
    for name, parent, w in waves:
        if parent is None:
            local = S.shard_tree(state_from_numpy(states["base"], dev), mesh,
                                 cfg)
            rq = RepairQueue.empty(B // d, dev)
        else:
            local, rq = carried[parent]
        local, done, stats, rq = wp(local, shard(w["keys"]),
                                    shard(w["vals"]), shard(w["is_delete"]),
                                    shard(w["active"]), shard(w["cs"]), rq)
        carried[name] = (local, rq)
        out["wave"][name] = dict(block=clone_state(local), done=done,
                                 stats=stats, rq=rq)
    out["clamp"] = [tuple(make_host_mesh(*s, device=dev).shape.values())
                    for s in clamps]
    if guard:
        small = make_host_mesh(2, 2, device=dev)
        out["guard"] = []
        for make in (S.routed_lookup_fn, S.pjit_phase_fns):
            try:
                make(cfg, small)
                out["guard"].append(None)
            except ValueError as e:
                out["guard"].append(str(e))
    return out
