"""PyTorch port of the checkpoint manager against the reference, on the CPU.

A checkpoint written by either package restores in the other, with equal
``manifest.json`` and ``.npy`` bytes: on a flat dict of a tree and its
repair queue like the chaos runner's snapshots, and on a nested tree of
dicts, tuples, a NamedTuple and ``None`` whose same-shaped leaves pin
JAX's leaf order.  Then the port passes its own versions of the manager
cases of ``tests/test_checkpoint_train.py`` (round trip, keep-k and
latest, shape mismatch, atomicity and the corruption injections).  A
bfloat16 leaf is written as the reference's bytes (descr ``<V2``,
manifest ``bfloat16``) and restores bit for bit as a CPU bfloat16
tensor; one whose file was swapped for another dtype or shape raises.
(The reference cannot restore such a leaf itself, so the restore is
specified and held port to port.)
"""
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.core import tree as JT
from repro.workloads.keygen import scramble
from repro_torch.checkpoint import CheckpointManager, tree_flatten
from repro_torch.core import tree as TT
from repro_torch.core.write import RepairQueue

CFG = dict(n_ms=2, nodes_per_ms=256, fanout=8, n_locks_per_ms=64,
           max_height=6, n_cs=4)


class Pair(NamedTuple):
    """Field order differs from sorted order: the NamedTuple keeps it."""
    zeta: object
    alpha: object


def _files(step_dir) -> dict:
    return {n: open(os.path.join(step_dir, n), "rb").read()
            for n in sorted(os.listdir(step_dir))}


def _snapshot_arrays(rng):
    """A runner-like flat dict: tree fields and a repair queue, as numpy."""
    keys = np.unique(scramble(np.arange(700, dtype=np.int64), 1 << 20))
    st = JT.bulkload(JT.TreeConfig(**CFG), keys, keys * 3)
    out = {f"state/{f}": np.asarray(v) for f, v in zip(st._fields, st)}
    q = RepairQueue(sep=rng.integers(0, 1 << 20, 16).astype(np.int32),
                    child=rng.integers(0, 512, 16).astype(np.int32),
                    level=rng.integers(0, 3, 16).astype(np.int32),
                    valid=rng.random(16) < 0.5)
    out.update({f"repair/{f}": v for f, v in zip(q._fields, q)})
    return out


def _nested(rng, as_tensor):
    """Same-shaped leaves with distinct values, in dicts (inserted out of
    sorted order), tuples, lists, a NamedTuple and ``None``."""
    a = [rng.integers(0, 100, (3, 2)).astype(np.int32) for _ in range(6)]
    conv = torch.from_numpy if as_tensor else (lambda x: x)
    return {"z": (conv(a[0]), [conv(a[1]), None]),
            "b": Pair(zeta=conv(a[2]), alpha={"y": conv(a[3]),
                                              "x": conv(a[4])}),
            "m": None,
            "a": conv(a[5]),
            "scalar": np.float32(2.5)}


def test_tree_flatten_follows_jax_leaf_order():
    tree = _nested(np.random.default_rng(0), as_tensor=False)
    leaves, rebuild = tree_flatten(tree)
    want = jax.tree_util.tree_leaves(tree)
    assert len(leaves) == len(want) == 7
    for x, y in zip(leaves, want):
        assert x is y
    back = rebuild(iter(leaves))
    assert back.keys() == tree.keys() and type(back["b"]) is Pair
    assert back["m"] is None and back["z"][1][1] is None
    assert isinstance(back["z"], tuple) and isinstance(back["z"][1], list)


@pytest.mark.parametrize("what", ["snapshot", "nested"])
def test_checkpoints_cross_restore_with_equal_bytes(tmp_path, what):
    rng = np.random.default_rng(1)
    if what == "snapshot":
        np_tree = _snapshot_arrays(rng)
        port_tree = {k: torch.from_numpy(v.copy()) for k, v in np_tree.items()}
        # the tensor leaves through the port's own state constructor too
        st = TT.state_from_numpy({k[6:]: v for k, v in np_tree.items()
                                  if k.startswith("state/")}, device="cpu")
        port_tree.update({f"state/{f}": v for f, v in zip(st._fields, st)})
    else:
        np_tree = _nested(rng, as_tensor=False)
        port_tree = _nested(np.random.default_rng(1), as_tensor=True)
    jax_tree = jax.tree_util.tree_map(jnp.asarray, np_tree)
    extra = {"round_no": 3, "rng": [1, 2], "flag": True}
    jm = JManager(str(tmp_path / "ref"))
    tm = CheckpointManager(str(tmp_path / "port"))
    jm.save(jax_tree, step=7, extra=extra)
    tm.save(port_tree, step=7, extra=extra)
    assert _files(tmp_path / "port" / "step_00000007") == \
        _files(tmp_path / "ref" / "step_00000007")
    # the reference's checkpoint restores in the port, and the port's in
    # the reference, leaf for leaf with dtypes
    from_ref = CheckpointManager(str(tmp_path / "ref")).restore(port_tree, 7)
    from_port = JManager(str(tmp_path / "port")).restore(jax_tree, 7)
    want = jax.tree_util.tree_leaves(np_tree)
    for got in (tree_flatten(from_ref)[0],
                jax.tree_util.tree_leaves(from_port)):
        assert len(got) == len(want)
        for x, y in zip(got, want):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    assert tm.restore_extra(7) == jm.restore_extra(7) == extra
    raw_t = CheckpointManager(str(tmp_path / "ref")).restore_raw(7)
    raw_j = jm.restore_raw(7)
    assert list(raw_t) == list(raw_j)
    for k in raw_j:
        np.testing.assert_array_equal(raw_t[k], raw_j[k])
    if what == "snapshot":       # the flat dict rebuilds a TreeState
        st = TT.state_from_numpy(
            {f: from_ref[f"state/{f}"] for f in TT.TreeState._fields},
            device="cpu")
        for f, v in zip(st._fields, st):
            assert v.dtype == TT.STATE_DTYPES[f]


def test_tensor_leaves_save_from_any_layout(tmp_path):
    """A non-contiguous tensor is written C-ordered, as a JAX array is."""
    a = np.arange(12, dtype=np.int32).reshape(3, 4)
    CheckpointManager(str(tmp_path / "port")).save(
        {"x": torch.from_numpy(a).t()}, step=1)
    JManager(str(tmp_path / "ref")).save({"x": jnp.asarray(a.T)}, step=1)
    assert _files(tmp_path / "port" / "step_00000001") == \
        _files(tmp_path / "ref" / "step_00000001")


def test_bfloat16_leaf_raises(tmp_path):
    """A bfloat16 leaf whose file no longer holds 2-byte values (a swapped
    dtype) or holds another shape raises; the saved one restores."""
    mgr = CheckpointManager(str(tmp_path))
    w = torch.arange(8, dtype=torch.float32).to(torch.bfloat16)
    mgr.save({"w": w}, step=1)
    assert torch.equal(mgr.restore({"w": w}, 1)["w"], w)
    path = os.path.join(tmp_path, "step_00000001", "leaf_00000.npy")
    for bad in (np.arange(8, dtype=np.float16), np.arange(8, dtype=np.int16),
                np.arange(8, dtype=np.float32)):
        np.save(path, bad)
        with pytest.raises(ValueError, match="dtype"):
            mgr.restore({"w": w}, 1)
        with pytest.raises(ValueError, match="dtype"):
            mgr.restore_raw(1)
    np.save(path, np.zeros(9, np.uint16).view("V2"))
    with pytest.raises(ValueError, match="shape"):
        mgr.restore({"w": w}, 1)


BF16_VALUES = [0.0, -0.0, 1.0, -2.5, 3.140625, 1e-30, 65504.0, float("inf"),
               float("-inf"), 1.0e38]


@pytest.mark.parametrize("shape", [(10,), (2, 5), ()])
def test_bfloat16_leaf_is_the_reference_bytes(tmp_path, shape):
    """The port's file for a bfloat16 tensor is the reference's file for the
    same values (an ml_dtypes bfloat16 array): same ``.npy`` and manifest
    bytes."""
    vals = np.array(BF16_VALUES[:int(np.prod(shape, dtype=int))],
                    np.float32).reshape(shape)
    CheckpointManager(str(tmp_path / "port")).save(
        {"w": torch.from_numpy(vals).to(torch.bfloat16), "b": torch.ones(2)},
        step=2)
    JManager(str(tmp_path / "ref")).save(
        {"w": jnp.asarray(vals, jnp.bfloat16), "b": jnp.ones(2)}, step=2)
    assert _files(tmp_path / "port" / "step_00000002") == \
        _files(tmp_path / "ref" / "step_00000002")


def test_bfloat16_leaf_restores_bit_for_bit(tmp_path):
    """bf16 leaves (a tensor on any layout, an ml_dtypes array, NaN and
    signed zero included) come back as CPU bfloat16 tensors of the same
    bits, beside f32 and int leaves; restore_raw and restore_latest too."""
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 1 << 16, (6, 4)).astype(np.uint16)
    w = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    tree = {"w": w.t(), "m": torch.randn(3), "step": torch.tensor(
        7, dtype=torch.int32), "j": jnp.asarray(bits[0].view(np.int16))
        .view(jnp.bfloat16)}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(tree, step=5)
    got, step = mgr.restore_latest(tree)
    assert step == 5
    assert got["w"].dtype == torch.bfloat16 and got["w"].device.type == "cpu"
    assert torch.equal(got["w"].view(torch.int16),
                       w.t().contiguous().view(torch.int16))
    assert np.array_equal(got["j"].view(torch.int16).numpy(),
                          bits[0].view(np.int16))
    assert np.array_equal(got["m"], tree["m"].numpy())
    assert got["step"].dtype == np.int32 and int(got["step"]) == 7
    raw = mgr.restore_raw(5)             # leaf 0 is "j" (sorted keys)
    assert torch.equal(raw["leaf_00000"].view(torch.int16),
                       torch.from_numpy(bits[0].view(np.int16)))


# -- the manager cases of tests/test_checkpoint_train.py, on the port ---------

def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": torch.arange(6).reshape(2, 3),
            "b": (torch.ones(4), torch.zeros(()))}
    mgr.save(tree, step=3)
    out = mgr.restore(tree, 3)
    for x, y in zip(tree_flatten(tree)[0], tree_flatten(out)[0]):
        assert isinstance(y, np.ndarray)
        assert (x.numpy() == y).all() and x.numpy().dtype == y.dtype


def test_keep_k_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"x": torch.zeros(2)}
    for s in (1, 2, 3, 4):
        mgr.save({"x": torch.full((2,), float(s))}, step=s)
    assert mgr.steps() == [3, 4]
    (restored, step) = mgr.restore_latest(tree)
    assert step == 4 and (restored["x"] == 4).all()
    assert CheckpointManager(str(tmp_path / "empty")).restore_latest(
        tree) is None


def test_restore_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save({"x": torch.zeros(3)}, step=1)
    with pytest.raises(ValueError):
        mgr.restore({"x": torch.zeros(4)}, 1)


def test_atomicity_no_partial_dirs(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save({"x": torch.zeros(2)}, step=1)
    assert not any(d.startswith(".tmp") for d in os.listdir(tmp_path))


def _leaf_path(tmp_path, step, name="leaf_00000"):
    return os.path.join(tmp_path, f"step_{step:08d}", name + ".npy")


def test_restore_rejects_swapped_dtype(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = {"x": torch.arange(8, dtype=torch.int32)}
    mgr.save(tree, step=1)
    np.save(_leaf_path(tmp_path, 1), np.arange(8, dtype=np.float64))
    with pytest.raises(ValueError, match="dtype"):
        mgr.restore(tree, 1)
    with pytest.raises(ValueError, match="dtype"):
        mgr.restore_raw(1)


def test_restore_rejects_resized_leaf(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = {"x": torch.zeros((4, 3), dtype=torch.float32)}
    mgr.save(tree, step=2)
    np.save(_leaf_path(tmp_path, 2), np.zeros((4, 7), np.float32))
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(tree, 2)


def test_restore_rejects_truncated_npy(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = {"x": torch.arange(1024)}
    mgr.save(tree, step=3)
    path = _leaf_path(tmp_path, 3)
    blob = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(blob[:len(blob) // 3])
    with pytest.raises(ValueError, match="unreadable|shape|dtype"):
        mgr.restore(tree, 3)


def test_restore_latest_skips_nothing_validates_everything(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    tree = {"x": torch.zeros(5)}
    mgr.save({"x": torch.ones(5)}, step=1)
    mgr.save({"x": torch.full((5,), 2.0)}, step=2)
    np.save(_leaf_path(tmp_path, 2), np.zeros(5, np.int8))
    with pytest.raises(ValueError):
        mgr.restore_latest(tree)
