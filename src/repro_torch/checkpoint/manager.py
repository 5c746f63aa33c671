"""Checkpointing: atomic, manifest-based, keep-last-k, resumable.

The PyTorch counterpart of :mod:`repro.checkpoint.manager`, with the same
on-disk layout, so a checkpoint written by either package restores in the
other: ``step_%08d/leaf_%05d.npy`` (one raw ``.npy`` a leaf), a
``manifest.json`` of ``{"step", "leaves": {name: {dtype, shape}}}``, an
optional ``extra.json`` side record, and a ``.tmp_step_*`` directory
published by ``os.rename`` (atomic on POSIX) so a crash mid-save never
corrupts the latest checkpoint.  On restore every leaf is validated against
the manifest's dtype and shape before it is accepted.

Leaves are numbered in JAX's pytree order, which this module reproduces
without JAX (:func:`tree_flatten`): dict keys sorted, list/tuple and
NamedTuple entries in order, ``None`` an empty subtree, anything else a
leaf.  Insertion order would not do: two same-shaped leaves such as a
tree's ``fence_hi`` and ``fence_lo`` would swap with no dtype or shape
check to catch it.  A ``torch.Tensor`` leaf is saved from a host copy,
whatever device it lives on; restored leaves are numpy arrays, and a
caller that wants tensors moves them onto the device it names.

A bfloat16 leaf (a tensor, or an ml_dtypes array) is written as the
reference writes one: its raw 2-byte values under the ``.npy`` descr
``<V2`` and the manifest dtype ``bfloat16``, so the files are the same
bytes.  numpy has no bfloat16 without ml_dtypes, so such a leaf restores
as a CPU ``torch.bfloat16`` tensor, after the same manifest checks: a
file whose dtype is not 2-byte void, or whose shape differs, is refused.
(The reference itself refuses to restore such a leaf: ``np.load`` reads
``<V2`` back as ``|V2``, which its dtype check compares with
``bfloat16``.)
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

_MANIFEST = "manifest.json"
_EXTRA = "extra.json"
_BF16 = "bfloat16"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_flatten(tree: Any) -> tuple[list, Callable[[Iterator], Any]]:
    """``(leaves, rebuild)`` in JAX's leaf order; ``rebuild(iter(leaves))``
    gives the tree back with those leaves in place."""
    leaves: list = []

    def walk(node) -> Callable[[Iterator], Any]:
        if node is None:
            return lambda it: None
        if isinstance(node, dict):
            keys = sorted(node)
            subs = [walk(node[k]) for k in keys]
            return lambda it: {k: s(it) for k, s in zip(keys, subs)}
        if _is_namedtuple(node):
            subs = [walk(v) for v in node]
            cls = type(node)
            return lambda it: cls(*[s(it) for s in subs])
        if isinstance(node, (list, tuple)):
            subs = [walk(v) for v in node]
            cls = type(node)
            return lambda it: cls(s(it) for s in subs)
        leaves.append(node)
        return lambda it: next(it)

    rebuild = walk(tree)
    return leaves, rebuild


def _flatten_with_names(tree: Any):
    leaves, rebuild = tree_flatten(tree)
    names = [f"leaf_{i:05d}" for i in range(len(leaves))]
    return names, leaves, rebuild


def _host_array(leaf) -> np.ndarray:
    """One leaf on the host: a tensor (on any device) as a C-ordered numpy
    copy, as the reference writes a JAX array; anything else as
    ``np.asarray`` gives it.  A bfloat16 leaf comes back as its uint16
    bit patterns (see :func:`_save_leaf`)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.detach().view(torch.int16)
            return _host_array(leaf).view(np.uint16)
        arr = leaf.detach().cpu().numpy()
        # (np.ascontiguousarray would make a 0-d leaf 1-d)
        return arr if arr.flags.c_contiguous else arr.copy(order="C")
    arr = np.asarray(leaf)
    if arr.dtype.name == _BF16:                 # an ml_dtypes array
        return np.ascontiguousarray(arr).view(np.uint16)
    return arr


def _is_bf16(leaf) -> bool:
    if isinstance(leaf, torch.Tensor):
        return leaf.dtype == torch.bfloat16
    return getattr(getattr(leaf, "dtype", None), "name", None) == _BF16


def _save_leaf(path: str, leaf) -> dict:
    """Write one leaf's ``.npy``; return its manifest entry.  A bfloat16
    leaf gets the reference's bytes: a version 1.0 header with descr
    ``<V2`` (what ``np.save`` writes for an ml_dtypes bfloat16 array)
    over its raw values."""
    arr = _host_array(leaf)
    if not _is_bf16(leaf):
        np.save(path, arr)
        return {"dtype": str(arr.dtype), "shape": list(arr.shape)}
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False,
                "shape": tuple(arr.shape)})
        f.write(arr.tobytes())
    return {"dtype": _BF16, "shape": list(arr.shape)}


def _leaf_shape(leaf) -> tuple:
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) \
        else tuple(np.shape(leaf))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # -- save -------------------------------------------------------------
    def save(self, tree: Any, step: int,
             extra: Optional[dict] = None) -> str:
        """Atomically publish ``tree``'s leaves plus an optional
        JSON-serializable ``extra`` side record (host-side scalars — RNG
        states, counters — that ride along with the array leaves).  One
        leaf at a time is copied to the host."""
        names, leaves, _ = _flatten_with_names(tree)
        tmp = os.path.join(self.dir, f".tmp_step_{step:08d}")
        final = os.path.join(self.dir, f"step_{step:08d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": {}}
        for name, leaf in zip(names, leaves):
            # one leaf on the host at a time
            manifest["leaves"][name] = _save_leaf(
                os.path.join(tmp, name + ".npy"), leaf)
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f)
        if extra is not None:
            with open(os.path.join(tmp, _EXTRA), "w") as f:
                json.dump(extra, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)            # atomic publish
        self.gc()
        return final

    # -- restore ----------------------------------------------------------
    def steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, d, _MANIFEST)):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def _manifest(self, step: int) -> dict:
        path = os.path.join(self.dir, f"step_{step:08d}", _MANIFEST)
        with open(path) as f:
            return json.load(f)

    def _load_leaf(self, step: int, name: str, entry: dict):
        """Load one ``.npy`` and validate it against its manifest entry.

        The manifest is the ground truth written at save time; a leaf
        whose on-disk dtype/shape disagrees (truncated write, stale file
        from an older run, bit-rot) must never be accepted silently.  A
        ``bfloat16`` entry needs a 2-byte void file and restores as a CPU
        ``torch.bfloat16`` tensor.
        """
        path = os.path.join(self.dir, f"step_{step:08d}", name + ".npy")
        try:
            arr = np.load(path)
        except (OSError, ValueError, EOFError) as e:   # torn or corrupt
            raise ValueError(
                f"checkpoint leaf {name} at step {step} is unreadable "
                f"({e})") from e
        bf16 = entry["dtype"] == _BF16
        if bf16:
            ok = arr.dtype.kind == "V" and arr.dtype.itemsize == 2
        else:
            ok = str(arr.dtype) == entry["dtype"]
        if not ok:
            raise ValueError(
                f"checkpoint leaf {name} dtype {arr.dtype} != manifest "
                f"{entry['dtype']} (stale or corrupt leaf)")
        if list(arr.shape) != list(entry["shape"]):
            raise ValueError(
                f"checkpoint leaf {name} shape {list(arr.shape)} != "
                f"manifest {entry['shape']} (stale or corrupt leaf)")
        if bf16:
            return torch.from_numpy(
                np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
        return arr

    def restore(self, template: Any, step: int):
        """The tree saved at ``step``, in ``template``'s structure, with
        numpy leaves (bfloat16 ones as CPU tensors)."""
        manifest = self._manifest(step)
        names, leaves, rebuild = _flatten_with_names(template)
        if set(names) != set(manifest["leaves"]):
            raise ValueError(
                f"checkpoint step {step} has {len(manifest['leaves'])} "
                f"leaves, template has {len(names)}")
        loaded = []
        for name, leaf in zip(names, leaves):
            arr = self._load_leaf(step, name, manifest["leaves"][name])
            want = _leaf_shape(leaf)
            if tuple(arr.shape) != want:
                raise ValueError(
                    f"checkpoint leaf {name} shape {arr.shape} != {want}")
            loaded.append(arr)
        return rebuild(iter(loaded))

    def restore_raw(self, step: int) -> dict[str, np.ndarray]:
        """Load every leaf of a step by manifest name (validated), without
        needing a structural template — callers that saved a flat dict
        reassemble it themselves (the chaos plane's run snapshots)."""
        manifest = self._manifest(step)
        return {name: self._load_leaf(step, name, entry)
                for name, entry in sorted(manifest["leaves"].items())}

    def restore_extra(self, step: int) -> Optional[dict]:
        """The JSON side record saved alongside ``step`` (None if absent)."""
        path = os.path.join(self.dir, f"step_{step:08d}", _EXTRA)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def restore_latest(self, template: Any
                       ) -> Optional[tuple[Any, int]]:
        steps = self.steps()
        if not steps:
            return None
        s = steps[-1]
        return self.restore(template, s), s

    # -- retention --------------------------------------------------------
    def gc(self):
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)
