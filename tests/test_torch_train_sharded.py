"""PyTorch port of the sharded train step (``launch/train.py::
shard_train_fns``, ``run`` on a mesh) and of elastic re-meshing
(``launch/elastic.py``) against the reference on the CPU: the LM half of
``tests/test_distributed_subprocess.py`` on gloo CPU ranks.

Reduced smollm-135m and reduced rwkv6-1.6b (so K3's plain backward is
sharded too), in f32, from the reference's ``jax.random.PRNGKey(0)``
weights: one sharded step on a (2, 4) mesh of 8 ranks equals the
reference's jitted ``make_train_step`` on one CPU device (loss, grad
norm); each rank's blocks are the reference's updated weights sliced as
the reference's specs say; ``drop_devices(mesh, 4)`` gives (1, 4), and
after ``reshard_params`` (weights and both moments) the survivors' next
step equals the reference's second step, weights included.  (The
reference's 8-device run is not repeated: it computes the same function
on one device.)  Then ``run`` on a (2, 2) mesh and ``run`` on one
device resume each other's checkpoints to the same losses.

Tolerance 1e-4 (absolute and relative) in f32: the mesh sums the
gradients in another order, nothing else.
"""
import itertools

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

from repro import configs as JC
from repro.data import tokens as JD
from repro.launch import train as JTR
from repro.models import registry as JREG
from repro.optim import adamw as JA
from repro.parallel import sharding as JSH
from repro_torch import configs as TC
from repro_torch.launch import train as TTR
from repro_torch.launch.mesh import run_mesh
from repro_torch.models import registry as TREG
from repro_torch.models.common import flat_params
from repro_torch.optim import adamw as TA
from torch_train_sharded_common import (FROM_NUMPY, OPT, run_rank,
                                        sharded_steps_rank)

TOL = 1e-4
DATA, MODEL = 2, 4
BATCH, SEQ = 8, 16
TIMEOUT = 300.0


def per_layer(name, tree):
    """The reference's tree (numpy) as the port's tensors in
    ``flat_params`` order (a stacked leaf's layers in layer order)."""
    cfg = TC.get_reduced(name)
    model = FROM_NUMPY[cfg.family].params_from_numpy(tree, cfg, "cpu")
    api = TREG.build(cfg, device="cpu")
    return [p.detach().numpy() for p in flat_params(api.param_tree(model))]


@pytest.mark.parametrize("name", ["smollm_135m", "rwkv6_1_6b"])
def test_sharded_step_drop_and_reshard_match_the_reference(name):
    jcfg = JC.get_reduced(name)
    japi = JREG.build(jcfg)
    params = japi.init(jax.random.PRNGKey(0))
    tree0 = jax.tree_util.tree_map(np.asarray, params)
    batches = list(itertools.islice(JD.synthetic_batches(jcfg, BATCH, SEQ),
                                    2))
    step = jax.jit(JTR.make_train_step(japi, JA.AdamWConfig(**OPT)))
    state = JA.init(params)
    want, trees = [], []
    for b in batches:
        params, state, m = step(params, state, b)
        want.append((float(m["loss"]), float(m["grad_norm"])))
        trees.append(jax.tree_util.tree_map(np.asarray, params))
    res = run_mesh(sharded_steps_rank, DATA, MODEL, backend="gloo",
                   device="cpu", args=(name, tree0, batches, 4),
                   timeout=TIMEOUT)
    # step 1 on (2, 4): every rank's metrics, and its blocks
    after1 = per_layer(name, trees[0])
    n_sharded = 0
    for rank, r in enumerate(res):
        assert r["coords"] == dict(data=rank // MODEL, model=rank % MODEL)
        np.testing.assert_allclose(r["m1"], want[0], atol=TOL, rtol=TOL)
        for spec, whole, block in zip(r["specs1"], after1, r["blocks1"]):
            sl = tuple(slice(None) if e is None else
                       slice(r["coords"]["model"] * (n // MODEL),
                             (r["coords"]["model"] + 1) * (n // MODEL))
                       for e, n in zip(spec, whole.shape))
            n_sharded += any(e is not None for e in spec)
            np.testing.assert_allclose(block, whole[sl], atol=TOL, rtol=TOL)
    assert n_sharded > 0
    # the rank's specs are the reference's, L dropped for a layer's tensor
    jspecs = [tuple(s) for s in jax.tree_util.tree_leaves(
        JSH.params_pspecs(trees[0], type("M", (), {
            "shape": {"data": DATA, "model": MODEL},
            "axis_names": ("data", "model")})()),
        is_leaf=lambda x: isinstance(x, JP))]
    jleaves = jax.tree_util.tree_leaves(trees[0])
    expect = []
    for spec, leaf, (path, _) in zip(jspecs, jleaves,
                                     jax.tree_util.tree_flatten_with_path(
                                         trees[0])[0]):
        layered = any(getattr(k, "name", "") in ("layers",) for k in path)
        expect += [spec[1:]] * leaf.shape[0] if layered else [spec]
    assert [tuple(s) for s in res[0]["specs1"]] == expect
    # drop 4 of 8: (1, 4), ranks 4..7 out; the survivors' step 2
    after2 = per_layer(name, trees[1])
    for rank, r in enumerate(res):
        assert r["new_shape"] == dict(data=1, model=MODEL)
        if rank >= MODEL:
            assert r["new_coords"] is None and "m2" not in r
            continue
        assert r["new_coords"] == dict(data=0, model=rank)
        assert r["step2"] == 2
        np.testing.assert_allclose(r["m2"], want[1], atol=TOL, rtol=TOL)
        for got, w in zip(r["params2"], after2):
            np.testing.assert_allclose(got, w, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("order", ["mesh_then_one_device",
                                   "one_device_then_mesh"])
def test_run_on_a_mesh_and_on_one_device_resume_each_other(tmp_path, order):
    """``run`` on a (2, 2) mesh (rank 0 saves the gathered reference
    tree) and on one device write the same checkpoint: a run of 2 steps
    on one resumes on the other for a third, whose loss and weights are a
    single-device run's resumed from its own step-2 checkpoint (a resumed
    run starts its data over, as the reference's does)."""
    name = "smollm_135m"
    api = TREG.build(TC.get_reduced(name), device="cpu")
    opt = TA.AdamWConfig(**OPT)
    tc = lambda d, steps: TTR.TrainConfig(steps=steps, ckpt_every=2,
                                          log_every=100, ckpt_dir=str(d),
                                          opt=opt)
    one = lambda d, steps: TTR.run(api, tc(d, steps), batch_size=BATCH,
                                   seq=SEQ, verbose=False)
    first_two = one(tmp_path / "one", 2)
    resumed = one(tmp_path / "one", 3)
    d = tmp_path / order

    def on_mesh(steps):
        res = run_mesh(run_rank, 2, 2, backend="gloo", device="cpu",
                       args=(name, str(d), steps, 2), timeout=TIMEOUT)
        for r in res[1:]:               # every rank saw the same run
            assert r["losses"] == res[0]["losses"]
        return res[0]

    def on_one(steps):
        out = one(d, steps)
        return dict(out, step=int(out["opt_state"].step), params=[
            p.detach().numpy()
            for p in flat_params(api.param_tree(out["params"]))])

    first, second = (on_mesh, on_one) if order.startswith("mesh") else \
        (on_one, on_mesh)
    a = first(2)
    b = second(3)
    for key in ("losses", "grad_norms"):
        np.testing.assert_allclose(a[key], first_two[key], atol=TOL,
                                   rtol=TOL)
        np.testing.assert_allclose(b[key], resumed[key], atol=TOL, rtol=TOL)
    assert len(b["losses"]) == 1 and b["step"] == 3
    want = [p.detach().numpy()
            for p in flat_params(api.param_tree(resumed["params"]))]
    for g, w in zip(b["params"], want):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL)
