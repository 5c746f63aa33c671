"""Elastic scaling: re-mesh and re-shard live state after the rank set
changes (a node failure).  The port of :mod:`repro.launch.elastic`.

The reference re-forms a ``jax.sharding.Mesh`` from the surviving devices
and moves the parameters with ``jax.device_put``, which reads the old
devices.  Here a mesh is processes, so both steps are collective calls on
every rank of the old mesh: :func:`reform_mesh` and :func:`drop_devices`
make the new mesh's process groups (a rank left out gets a ``Mesh`` with
``coords`` None), and :func:`reshard_params` gathers the old blocks —
the leaving ranks hand theirs over — and gives each rank of the new mesh
its block under the new mesh's specs.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Sequence

import torch.distributed as dist

from repro_torch.launch.mesh import Collectives, Mesh
from repro_torch.launch.train import Sharded, gather, shard


def reform_mesh(ranks: Sequence[int], data: Optional[int] = None,
                model: Optional[int] = None, device=None) -> Mesh:
    """The largest (data, model) mesh that fits the surviving ``ranks``
    (world ranks, taken in increasing order): the model axis kept as large
    as possible (the TP degree is tied to the weights' block shapes),
    the data axis shrunk first, the standard elastic-DP policy.  Collective
    over every rank of the default process group; ``device`` is this
    rank's (``mesh.device`` of the old mesh)."""
    ranks = sorted(ranks)
    n = len(ranks)
    if model is None:
        model = n
        while model > 1 and n % model:
            model -= 1
    data = data or n // model
    if data * model > n:
        raise ValueError(f"{data}x{model} mesh needs {data * model} "
                         f"ranks, have {n}")
    kept = tuple(ranks[:data * model])
    rows = tuple(dist.new_group([kept[i * model + j] for j in range(model)])
                 for i in range(data))
    cols = tuple(dist.new_group([kept[i * model + j] for i in range(data)])
                 for j in range(model))
    group = dist.new_group(list(kept))
    r = dist.get_rank()
    coords = (dict(data=kept.index(r) // model, model=kept.index(r) % model)
              if r in kept else None)
    return Mesh(shape=OrderedDict(data=data, model=model), rank=r,
                coords=coords, device=device, row_groups=rows,
                col_groups=cols, ranks=kept, group=group)


def reshard_params(params: Sharded, new_mesh: Mesh) -> Sharded:
    """``params`` (this rank's blocks on the old mesh) as blocks on
    ``new_mesh`` under its specs.  Collective on every rank of the old
    mesh: the blocks are gathered whole over each old ``model`` row, then
    each rank of the new mesh keeps its block (None outside it).  The same
    call moves an AdamW moment's blocks."""
    if params.blocks is None:
        raise ValueError("reshard_params runs on the old mesh's ranks")
    whole = gather(params, Collectives(params.mesh))
    return shard(params.tree, whole, new_mesh)


def drop_devices(mesh: Mesh, n_failed: int) -> Mesh:
    """Lose the last ``n_failed`` ranks of ``mesh``: reform from the
    survivors, keeping the model axis (survivors that do not fill a whole
    ``model`` row are left out too)."""
    flat = [mesh.rank_of(i, j) for i in range(mesh.shape["data"])
            for j in range(mesh.shape["model"])]
    survivors = flat[:-n_failed] if n_failed else flat
    model = mesh.shape.get("model", 1)
    while model > 1 and len(survivors) % model:
        survivors = survivors[:-1]
    data = len(survivors) // model
    return reform_mesh(survivors, data=data, model=model, device=mesh.device)
