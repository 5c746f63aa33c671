"""Sharding rules: DP / TP / EP / SP over a (pod, data, model) mesh.  The
port of :mod:`repro.parallel.sharding`.

Mesh axes: ``pod`` (inter-pod DP), ``data`` (DP / FSDP / SP), ``model``
(TP / EP / the index's "mem" axis).  A sharded dim must divide the axis
size, so every rule is a *preference list* — the first candidate dim
divisible by the axis size wins, otherwise the tensor falls back to the
next scheme (e.g. 40 q-heads can't split 16-way, so attention falls back
from head-parallel (Megatron column) to d_model-parallel (row)):

* attention  wq/wk/wv: heads → d_model → head_dim;  wo: heads → d_model
* MLP        gate/up: d_ff → d_model;  down: d_ff → d_model
* MoE        experts (EP) → per-expert d_ff (TP-in-expert)
* embeddings vocab → d_model
* KV cache   batch over data; sequence over model

The rules are name-driven over the parameter tree (NamedTuples, dicts,
lists), so one function covers every architecture family; they read a
leaf's last two name parts and negative dims only, and take any mesh with
``.shape`` (axis name -> size) and ``.axis_names``.  A spec is a :class:`P`,
a tuple with ``jax.sharding.PartitionSpec``'s entries: None, an axis name,
or a tuple of names.  The port's trees are the models' ``param_tree``
(each stacked leaf a :class:`~repro_torch.models.common.Layers` of per-layer
tensors, ``.shape`` with the leading ``L``); :func:`flat_pspecs` gives each
per-layer tensor its stacked leaf's spec without the ``L`` entry, and
:func:`block_slices` the block of a tensor that a rank of the mesh holds.
"""
from __future__ import annotations

import math
from typing import Any, Sequence

from repro_torch.checkpoint.manager import tree_flatten
from repro_torch.models.common import Layers

MODEL = "model"
DATA = "data"
POD = "pod"


class P(tuple):
    """A partition spec: one entry per dim, None (replicated), an axis name
    or a tuple of axis names (sharded over their product, row-major); a
    tuple of one name is that name, as in ``PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)


def dp_axes(mesh):
    """Batch/data-parallel axes (includes pod when present)."""
    return (POD, DATA) if POD in mesh.axis_names else (DATA,)


def _axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def name_tree(tree: Any, prefix: str = "") -> Any:
    """Same-structure tree of dotted field names (NamedTuple/dict aware; a
    tensor or a ``Layers`` is a leaf)."""
    if tree is None:
        return None
    if hasattr(tree, "_fields"):
        vals = [name_tree(getattr(tree, f), f"{prefix}{f}.")
                for f in tree._fields]
        return type(tree)(*vals)
    if isinstance(tree, dict):
        return {k: name_tree(v, f"{prefix}{k}.") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(name_tree(v, f"{prefix}{i}.")
                          for i, v in enumerate(tree))
    return prefix.rstrip(".")


def _shape(x) -> tuple:
    return tuple(getattr(x, "shape", ()))


def _pick(shape: Sequence[int], prefs: Sequence[int], size: int,
          axis: str = MODEL) -> P:
    """First preferred dim (negative index) divisible by ``size`` wins."""
    spec: list = [None] * len(shape)
    for d in prefs:
        if len(shape) >= -d and shape[d] % size == 0 and shape[d] >= size:
            spec[d] = axis
            return P(*spec)
    return P(*spec)


def param_spec(name: str, shape: Sequence[int], mesh) -> P:
    """TP/EP spec for one named parameter."""
    m = _axis_size(mesh, MODEL)
    n = name.split(".")[-1]
    holder = name.split(".")[-2] if "." in name else ""

    if len(shape) == 0:
        return P()
    # --- norms / scalars / biases on d_model ---
    if n.startswith(("ln", "norm")) or n in ("b_a", "b_i", "conv_b", "b2",
                                             "lam", "mu_x", "mu_ck",
                                             "mu_cr", "w0", "mu"):
        return P(*([None] * len(shape)))
    # --- embeddings / heads ---
    if n in ("embed", "tok_embed"):
        return _pick(shape, (-2, -1), m)           # vocab, else d_model
    if n in ("head", "lm_head"):
        return _pick(shape, (-1, -2), m)           # vocab, else d_model
    if n in ("dec_pos", "enc_pos"):
        return _pick(shape, (-2,), m)
    # --- attention ---
    if n in ("wq", "wk", "wv") and holder in ("attn", "self_attn",
                                              "cross_attn", ""):
        return _pick(shape, (-2, -3, -1), m)       # heads, d_model, hd
    if n == "wo" and holder in ("attn", "self_attn", "cross_attn", ""):
        return _pick(shape, (-3, -1), m)           # heads, else d_model out
    # --- MoE (4D expert-stacked) / dense MLP ---
    if n in ("w_gate", "w_up"):
        if len(shape) >= 4 or holder == "moe":
            return _pick(shape, (-3, -1, -2), m)   # E, F, D
        return _pick(shape, (-1, -2), m)           # F, else D
    if n == "w_down":
        if len(shape) >= 4 or holder == "moe":
            return _pick(shape, (-3, -2, -1), m)   # E, F, D
        return _pick(shape, (-2, -1), m)
    if n == "router":
        return P(*([None] * len(shape)))
    if n in ("shared_gate", "shared_up"):
        return _pick(shape, (-1, -2), m)
    if n == "shared_down":
        return _pick(shape, (-2, -1), m)
    # --- whisper FFN ---
    if n == "w1":
        return _pick(shape, (-1, -2), m)
    if n == "w2":
        return _pick(shape, (-2, -1), m)
    if n == "b1":
        return _pick(shape, (-1,), m)
    # --- rwkv ---
    if n in ("wr", "wk", "wv", "wg", "wck", "wcr", "lora_a", "w_a"):
        return _pick(shape, (-1,), m)          # column-parallel (heads)
    if n in ("wo", "wcv"):
        # row-parallel pair of the column-parallel projections above
        return _pick(shape, (-2, -1), m)
    if n in ("w_b", "lora_b"):
        return _pick(shape, (-1, -2), m)
    if n == "u":
        return _pick(shape, (-2,), m)
    # --- rg-lru ---
    if n in ("w_x", "w_y"):
        return _pick(shape, (-1, -2), m)
    if n == "conv_w":
        return _pick(shape, (-1,), m)
    if n == "w_i":
        return _pick(shape, (-1,), m)
    if n == "w_o":
        return _pick(shape, (-2, -1), m)
    # --- fallback: last dim if divisible ---
    return _pick(shape, (-1, -2), m)


def _map_named(fn, tree):
    """``tree`` with each leaf ``x`` replaced by ``fn(name, x)``."""
    leaves, rebuild = tree_flatten(tree)
    names, _ = tree_flatten(name_tree(tree))
    return rebuild(iter([fn(nm, x) for nm, x in zip(names, leaves)]))


def spec_leaves(tree) -> list:
    """The :class:`P` leaves of a spec tree, in the tree's leaf order."""
    if tree is None:
        return []
    if isinstance(tree, P):
        return [tree]
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in spec_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [s for v in tree for s in spec_leaves(v)]
    raise TypeError(f"not a spec tree: {type(tree).__name__}")


def params_pspecs(params: Any, mesh) -> Any:
    return _map_named(lambda nm, p: param_spec(nm, _shape(p), mesh), params)


def placements(spec: P, mesh) -> tuple:
    """``torch.distributed.tensor`` placements of a spec, one per mesh axis
    in ``mesh.axis_names`` order: ``Shard(dim)`` where a dim's entry names
    the axis, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in mesh.axis_names:
        dims = [d for d, e in enumerate(spec)
                if e == axis or (isinstance(e, tuple) and axis in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def params_shardings(params: Any, mesh) -> Any:
    """Each leaf's placements on ``mesh`` (:func:`placements`), as data."""
    return _map_named(lambda nm, p: placements(
        param_spec(nm, _shape(p), mesh), mesh), params)


def flat_pspecs(tree: Any, mesh) -> list:
    """The spec of every tensor of ``flat_params(tree)``, in its order: a
    stacked leaf's parts each get its spec without the leading ``L``
    entry (raises where a rule would shard ``L``)."""
    out = []
    for nm, x, spec in zip(tree_flatten(name_tree(tree))[0],
                           tree_flatten(tree)[0],
                           spec_leaves(params_pspecs(tree, mesh))):
        if isinstance(x, Layers):
            if spec[0] is not None:
                raise ValueError(f"{nm}: spec {spec} shards the layer axis")
            out += [P(*spec[1:])] * len(x.parts)
        else:
            out.append(spec)
    return out


def _axes(entry) -> tuple:
    return () if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))


def block_slices(shape: Sequence[int], spec: P, mesh) -> tuple:
    """The slices of a ``shape`` tensor that this rank of ``mesh``
    (``mesh.axis_index``) holds under ``spec``: along a sharded dim the
    block of the rank's index over that entry's axes, row-major."""
    out = []
    for n, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = _axes(entry)
        size = math.prod(mesh.shape[a] for a in axes)
        idx = 0
        for a in axes:
            idx = idx * mesh.shape[a] + mesh.axis_index(a)
        block = n // size
        out.append(slice(idx * block, (idx + 1) * block))
    return tuple(out)


# --------------------------------------------------------------------------
# activations / batches / decode state
# --------------------------------------------------------------------------

def batch_pspecs(batch: dict, mesh) -> dict:
    """tokens [B,S] + stub embeddings sharded over the DP axes."""
    dp = dp_axes(mesh)
    dsize = math.prod(mesh.shape[a] for a in dp)

    def spec(x):
        shape = _shape(x)
        if shape and shape[0] % dsize == 0 and shape[0] >= dsize:
            return P(dp, *([None] * (len(shape) - 1)))
        return P(*([None] * len(shape)))

    return {k: spec(v) for k, v in batch.items()}


def state_spec(name: str, shape: Sequence[int], mesh) -> P:
    """Decode-state sharding: batch over data, sequence over model.

    KV caches ([L,B,S,KV,hd]) shard the *sequence* dim over model —
    attention then reduces only softmax statistics and a tiny partial
    output across shards (sequence-parallel decode).  Recurrent states
    ([L,B,H,N,N], [L,B,W,R], [L,B,R]) shard their widest inner dim.
    """
    d = _axis_size(mesh, DATA)
    m = _axis_size(mesh, MODEL)
    spec: list = [None] * len(shape)
    if len(shape) == 0:
        return P()
    # find a batch-like dim: the first dim (or second when stacked by layer)
    for bdim in (1, 0):
        if len(shape) > bdim and shape[bdim] % d == 0 and shape[bdim] >= d:
            spec[bdim] = DATA
            break
    # model axis: sequence dim (index 2) of stacked caches first, then the
    # innermost dims
    cands = (2, -1, -2) if len(shape) >= 4 else (-1, -2)
    for mdim in cands:
        i = mdim if mdim >= 0 else len(shape) + mdim
        if 0 <= i < len(shape) and shape[i] % m == 0 and shape[i] >= m \
                and spec[i] is None:
            spec[i] = MODEL
            break
    return P(*spec)


def decode_state_pspecs(state: Any, mesh) -> Any:
    return _map_named(lambda nm, x: state_spec(nm, _shape(x), mesh), state)


def describe(params: Any, mesh, max_rows: int = 0) -> str:
    """Human-readable sharding table."""
    names = tree_flatten(name_tree(params))[0]
    leaves = tree_flatten(params)[0]
    specs = spec_leaves(params_pspecs(params, mesh))
    rows = [f"{nm:48s} {str(_shape(lf)):24s} {sp}"
            for nm, lf, sp in zip(names, leaves, specs)]
    if max_rows:
        rows = rows[:max_rows]
    return "\n".join(rows)
