"""Rank functions of ``tests/test_torch_train_sharded.py`` and
``tests/test_torch_spans.py`` (not a test module: the gloo ranks import
it, and it imports no JAX)."""
import torch

from repro_torch.configs import get_reduced
from repro_torch.launch import elastic, train
from repro_torch.models import registry, rwkv6, transformer
from repro_torch.models.common import flat_params
from repro_torch.optim import adamw

FROM_NUMPY = {"dense": transformer, "ssm": rwkv6}
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=4)


def _host(xs):
    return [x.detach().cpu().numpy().copy() for x in xs]


def sharded_steps_rank(mesh, name, tree, batches, n_failed):
    """A step of the sharded train step on ``mesh`` from the weights
    ``tree`` (the reference's, as numpy), then ``drop_devices(mesh,
    n_failed)``, the weights and moments resharded, and a second step on
    the survivors.  Returns each step's metrics, the rank's blocks after
    the first step with their specs, and the gathered weights after the
    second (not on a dropped rank)."""
    cfg = get_reduced(name)
    api = registry.build(cfg, device="cpu")
    model = FROM_NUMPY[cfg.family].params_from_numpy(tree, cfg, "cpu")
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in batches]
    opt = adamw.AdamWConfig(**OPT)
    step, _ = train.shard_train_fns(api, mesh, model, None, batches[0], opt)
    params, state = step.shard_params(), step.shard_opt()
    params, state, m = step(params, state, batches[0])
    out = dict(coords=mesh.coords, m1=(float(m["loss"]),
                                       float(m["grad_norm"])),
               blocks1=_host(params.blocks),
               specs1=[tuple(s) for s in params.specs])
    new = elastic.drop_devices(mesh, n_failed)
    params = elastic.reshard_params(params, new)
    state = state._replace(m=elastic.reshard_params(state.m, new),
                           v=elastic.reshard_params(state.v, new))
    out.update(new_shape=dict(new.shape), new_coords=new.coords)
    if new.coords is None:
        return out
    step2, _ = train.shard_train_fns(api, new, model, None, batches[1], opt)
    params, state, m = step2(params, state, batches[1])
    step2.gather_params(params)
    out.update(m2=(float(m["loss"]), float(m["grad_norm"])),
               params2=_host(flat_params(api.param_tree(model))),
               step2=int(state.step))
    return out


def run_rank(mesh, name, ckdir, steps, ckpt_every):
    """``train.run`` on ``mesh`` (every rank), batch 8 of 16 tokens."""
    api = registry.build(get_reduced(name), device="cpu")
    tc = train.TrainConfig(steps=steps, ckpt_every=ckpt_every,
                           log_every=100, ckpt_dir=ckdir,
                           opt=adamw.AdamWConfig(**OPT))
    out = train.run(api, tc, mesh=mesh, batch_size=8, seq=16, verbose=False)
    return dict(losses=out["losses"], grad_norms=out["grad_norms"],
                step=int(out["opt_state"].step),
                params=_host(flat_params(api.param_tree(out["params"]))))



def profiled_sharded_step_rank(mesh, name):
    """One sharded step of reduced ``name`` (batch 4 of 12 tokens) under
    ``torch.profiler``; the names of the program's spans it yielded, in
    order of their start."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import spans
    cfg = get_reduced(name)
    api = registry.build(cfg, device="cpu")
    model = api.init(torch.Generator().manual_seed(0))
    batch = registry.make_batch(cfg, 4, 12, torch.Generator().manual_seed(1),
                                "cpu")
    step, _ = train.shard_train_fns(api, mesh, model, None, batch,
                                    adamw.AdamWConfig(**OPT))
    params, state = step.shard_params(), step.shard_opt()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(params, state, batch)
    evs = sorted((e.start_ns(), e.name())
                 for e in prof.profiler.kineto_results.events()
                 if e.name().startswith(spans.PREFIX))
    return [n for _, n in evs]
