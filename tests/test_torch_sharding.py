"""PyTorch port of the sharding rules (``parallel/sharding.py``) and of the
shape cells (``launch/shapes.py``) against the reference on the CPU.

For all 10 configs at full width (shapes on ``meta`` in the port, from
``eval_shape`` in the reference; llama4-scout is ~218 GB in bf16), on the
reference test's ``MESH1``/``MESH2``: the parameter trees have the same
names, shapes and dtypes, the specs are equal leaf for leaf (and so is
``describe``'s table), every per-layer tensor's spec from its own name
and shape is its stacked leaf's without ``L``, and the decode-state and
batch specs are equal and divide the mesh.  Then the reference test's
attention fallback and llama4-vs-qwen expert cases, and
``test_long_500k_support_flags`` (``tests/test_models.py``), on the
port.  Exact equality throughout: the rules are integer arithmetic.
"""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import ALL_ARCHS, get as jget
from repro.launch import shapes as JS
from repro.models.registry import build as jbuild
from repro.parallel import sharding as JSH
from repro_torch.checkpoint.manager import tree_flatten
from repro_torch.configs import get
from repro_torch.launch import shapes as shp
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import registry
from repro_torch.models.common import flat_params
from repro_torch.parallel import sharding as sh


@dataclasses.dataclass
class FakeMesh:
    shape: dict
    axis_names: tuple


MESH1 = FakeMesh({"data": 16, "model": 16}, ("data", "model"))
MESH2 = FakeMesh({"pod": 2, "data": 16, "model": 16},
                 ("pod", "data", "model"))
MESHES = [MESH1, MESH2]
MESH_IDS = ["single", "multi"]


def ref_specs(tree, mesh):
    return [tuple(s) for s in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, JP))]


def port_specs(tree):
    return [tuple(s) for s in sh.spec_leaves(tree)]


def check_divisibility(specs, leaves, mesh):
    assert len(specs) == len(leaves)
    for sp, leaf in zip(specs, leaves):
        shape = tuple(getattr(leaf, "shape", ()))
        for dim, axes in enumerate(sp):
            if axes is None:
                continue
            axes = (axes,) if isinstance(axes, str) else axes
            size = math.prod(mesh.shape[a] for a in axes)
            assert shape[dim] % size == 0, (sp, shape, dim)


def dtype_name(x) -> str:
    return str(x.dtype).replace("torch.", "")


@pytest.fixture(scope="module")
def trees():
    """Per arch: the reference's and the port's full-size parameter
    stand-ins, and the port's model on ``meta``."""
    out = {}
    for name in ALL_ARCHS:
        japi = jbuild(jget(name))
        api = registry.build(get(name), device="meta")
        model = api.init(None)
        out[name] = (japi, JS.params_specs(japi), api,
                     api.param_tree(model), model)
    return out


@pytest.mark.parametrize("name", ALL_ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_param_specs_match_the_reference(trees, name, mesh):
    _, jp, api, tp, _ = trees[name]
    assert tree_flatten(sh.name_tree(tp))[0] == \
        jax.tree_util.tree_leaves(JSH.name_tree(jp))
    jl, tl = jax.tree_util.tree_leaves(jp), tree_flatten(tp)[0]
    assert [(tuple(a.shape), str(a.dtype)) for a in jl] == \
        [(tuple(b.shape), dtype_name(b)) for b in tl]
    specs = port_specs(sh.params_pspecs(tp, mesh))
    assert specs == ref_specs(JSH.params_pspecs(jp, mesh), mesh)
    check_divisibility(specs, tl, mesh)
    assert sh.describe(tp, mesh) == JSH.describe(jp, mesh)
    # shapes.params_specs gives the same tree, on meta
    again = tree_flatten(shp.params_specs(api))[0]
    assert all(p.device.type == "meta" for x in again
               for p in getattr(x, "parts", [x]))


@pytest.mark.parametrize("name", ALL_ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_per_layer_specs_are_the_stacked_ones_without_L(trees, name, mesh):
    """Each of the port's tensors, by its own per-layer name and shape
    (``layers.3.attn.wq``), gets the reference's stacked spec with the
    leading ``L`` entry dropped (``flat_pspecs``)."""
    _, jp, _, tp, model = trees[name]
    names = {id(p): n for n, p in model.named_parameters()}
    params = flat_params(tp)
    flat = sh.flat_pspecs(tp, mesh)
    assert len(flat) == len(params) == len(names)
    stacked = {}
    for jn, spec, leaf in zip(
            jax.tree_util.tree_leaves(JSH.name_tree(jp)),
            ref_specs(JSH.params_pspecs(jp, mesh), mesh),
            tree_flatten(tp)[0]):
        for p in getattr(leaf, "parts", [leaf]):
            stacked[id(p)] = spec[1:] if hasattr(leaf, "parts") else spec
    for p, spec in zip(params, flat):
        assert tuple(sh.param_spec(names[id(p)], p.shape, mesh)) == \
            tuple(spec) == stacked[id(p)], names[id(p)]


@pytest.mark.parametrize("name", ALL_ARCHS)
def test_decode_state_specs_match_the_reference(trees, name):
    japi, jp, api, _, _ = trees[name]
    n = 0
    for shape_name in ("decode_32k", "long_500k"):
        shape = shp.SHAPES[shape_name]
        ok, _ = shp.cell_supported(api.cfg, shape)
        assert ok == JS.cell_supported(japi.cfg, JS.SHAPES[shape_name])[0]
        if not ok:
            continue
        jst = JS.decode_state_specs(japi, jp, JS.SHAPES[shape_name])
        st = shp.decode_state_specs(api, shape)
        jl, tl = jax.tree_util.tree_leaves(jst), tree_flatten(st)[0]
        assert type(st).__name__ == type(jst).__name__
        # ``pos`` is a Python int in the port, an int32 scalar there
        assert [(tuple(a.shape), str(a.dtype)) for a in jl] == [
            (tuple(b.shape), dtype_name(b)) if isinstance(b, torch.Tensor)
            else ((), "int32") for b in tl]
        assert all(b.device.type == "meta" for b in tl
                   if isinstance(b, torch.Tensor))
        for mesh in MESHES:
            specs = port_specs(sh.decode_state_pspecs(st, mesh))
            assert specs == ref_specs(JSH.decode_state_pspecs(jst, mesh),
                                      mesh)
            check_divisibility(specs, tl, mesh)
        n += 1
    assert n >= 1


@pytest.mark.parametrize("name", ALL_ARCHS)
def test_batch_specs_match_the_reference(name):
    cfg, jcfg = get(name), jget(name)
    for shape_name, shape in shp.SHAPES.items():
        if not shp.cell_supported(cfg, shape)[0]:
            continue
        b = shp.batch_specs(cfg, shape)
        jb = JS.batch_specs(jcfg, JS.SHAPES[shape_name])
        assert sorted(b) == sorted(jb)
        for k in b:
            assert b[k].device.type == "meta"
            assert (tuple(b[k].shape), dtype_name(b[k])) == \
                (tuple(jb[k].shape), str(jb[k].dtype))
        for mesh in MESHES:
            specs = sh.batch_pspecs(b, mesh)
            jspecs = JSH.batch_pspecs(jb, mesh)
            assert {k: tuple(v) for k, v in specs.items()} == \
                {k: tuple(v) for k, v in jspecs.items()}
            check_divisibility([specs[k] for k in sorted(b)],
                               [b[k] for k in sorted(b)], mesh)
        tok = shp.token_spec(shape)
        assert tuple(tok.shape) == JS.token_spec(
            JS.SHAPES[shape_name]).shape and tok.dtype == torch.int32


def test_attention_fallback_when_heads_not_divisible(trees):
    """40 q-heads can't split 16 ways: wq must fall back to d_model."""
    tp = trees["llama4_scout_17b_a16e"][3]
    names = tree_flatten(sh.name_tree(tp))[0]
    by_name = dict(zip(names, sh.spec_leaves(sh.params_pspecs(tp, MESH1))))
    wq = [v for k, v in by_name.items() if k.endswith("attn.wq")][0]
    # [L, D, H=40, hd=128]: D (index 1) sharded, H untouched
    assert wq[1] == "model" and wq[2] is None


def test_moe_expert_sharding_llama4_vs_qwen(trees):
    """16 experts shard over model; 60 experts fall back to per-expert FF."""
    for name, expect_expert in (("llama4_scout_17b_a16e", True),
                                ("qwen2_moe_a2_7b", False)):
        tp = trees[name][3]
        names = tree_flatten(sh.name_tree(tp))[0]
        by_name = dict(zip(names,
                           sh.spec_leaves(sh.params_pspecs(tp, MESH1))))
        wg = [v for k, v in by_name.items() if k.endswith("moe.w_gate")][0]
        if expect_expert:
            assert wg[1] == "model"          # [L, E, D, F] E sharded
        else:
            assert wg[1] is None and wg[3] == "model"


def test_long_500k_support_flags():
    sub = {n: get(n).subquadratic for n in ALL_ARCHS}
    assert sub["rwkv6_1_6b"] and sub["recurrentgemma_2b"]
    assert sum(sub.values()) == 2
    for n in ALL_ARCHS:
        ok, why = shp.cell_supported(get(n), shp.SHAPES["long_500k"])
        assert ok == sub[n]
        assert (ok, why) == JS.cell_supported(jget(n), JS.SHAPES["long_500k"])
        if not ok:
            assert "sub-quadratic" in why


def test_placements_and_blocks_follow_the_specs():
    """``params_shardings`` gives ``Shard(dim)`` on the axes a spec names
    and ``Replicate()`` elsewhere; ``block_slices`` is a rank's block on
    the production mesh's shape, at every rank's coordinates."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = make_production_mesh(multi_pod=True)
    assert mesh.axis_names == ("pod", "data", "model") and mesh.size == 512
    assert sh.placements(sh.P(("pod", "data"), None, "model"), mesh) == \
        (Shard(0), Shard(0), Shard(2))
    assert sh.placements(sh.P(None, None), mesh) == (Replicate(),) * 3
    tree = {"embed": torch.empty((64, 8), device="meta")}
    assert sh.params_shardings(tree, mesh) == \
        {"embed": (Replicate(), Replicate(), Shard(0))}
    x = np.arange(32 * 6).reshape(32, 6)
    for pod in range(2):
        for data in range(16):
            m = dataclasses.replace(mesh, coords=dict(pod=pod, data=data,
                                                      model=3))
            got = x[sh.block_slices(x.shape, sh.P(("pod", "data"), None), m)]
            assert np.array_equal(got, x[pod * 16 + data:pod * 16 + data + 1])
            got = x[sh.block_slices(x.shape, sh.P(None, None), m)]
            assert np.array_equal(got, x)
