"""PyTorch port, the spans inside the training step
(:mod:`repro_torch.obs.spans`): under ``torch.profiler`` one step of
``launch/train.py::make_train_step`` yields each named span where its
work happens, nested in the step's; without a profiler no profiler range
is opened at all; and a profiled step computes the same values, bit for
bit, as an unprofiled one.  On reduced f32 rwkv6 and internvl2 (the VLM
with its patch prefix) at two layers, and the sharded step's collectives
on a (1, 2) mesh of gloo ranks.  No JAX."""
import contextlib
import dataclasses
import gc

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs as TC
from repro_torch.launch.mesh import run_mesh
from repro_torch.launch.train import make_train_step
from repro_torch.models import registry as TREG
from repro_torch.models.common import flat_params
from repro_torch.obs import spans as S
from repro_torch.optim import adamw
from torch_train_sharded_common import profiled_sharded_step_rank

CASES = ("rwkv6_1_6b", "internvl2_1b")
LAYERS = 2
B, SEQ = 2, 12
ONCE = (S.STEP, S.FORWARD, S.BACKWARD, S.OPTIMIZER, S.GRAD_NORM, S.EMBED,
        S.HEAD, S.LOSS, S.HEAD_LOSS_BACKWARD)


def setup(case):
    cfg = dataclasses.replace(TC.get_reduced(case), n_layers=LAYERS)
    api = TREG.build(cfg, device="cpu")
    model = api.init(torch.Generator().manual_seed(0))
    batches = [TREG.make_batch(cfg, B, SEQ,
                               torch.Generator().manual_seed(1 + i), "cpu")
               for i in range(2)]
    state = adamw.init(flat_params(api.param_tree(model)))
    return api, model, state, batches


def span_events(prof) -> list:
    """[(name, start_ns, end_ns)] of the profiler's ``rt/`` ranges, in
    order of their start."""
    return sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith(S.PREFIX)), key=lambda e: e[1])


def inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.mark.parametrize("case", CASES)
def test_a_profiled_step_yields_every_span_nested(case):
    api, model, state, batches = setup(case)
    step = make_train_step(api, adamw.AdamWConfig())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(model, state, batches[0])
    evs = span_events(prof)
    named = {n: [e for e in evs if e[0] == n] for n in
             ONCE + (S.LAYER, S.REMAT_REPLAY)}
    for n in ONCE:
        assert len(named[n]) == 1, (n, evs)
    one = {n: named[n][0] for n in ONCE}
    for n in (S.FORWARD, S.BACKWARD, S.OPTIMIZER):
        assert inside(one[n], one[S.STEP])
    for n in (S.EMBED, S.HEAD, S.LOSS):
        assert inside(one[n], one[S.FORWARD])
    assert inside(one[S.HEAD_LOSS_BACKWARD], one[S.BACKWARD])
    assert inside(one[S.GRAD_NORM], one[S.OPTIMIZER])
    # the head's and the loss's backward come first in the backward
    assert one[S.HEAD_LOSS_BACKWARD][1] < min(
        e[1] for e in named[S.REMAT_REPLAY])
    # every layer's forward once, and its replay once in the backward
    assert len(named[S.LAYER]) == len(named[S.REMAT_REPLAY]) == LAYERS
    assert all(inside(e, one[S.FORWARD]) for e in named[S.LAYER])
    assert all(inside(e, one[S.BACKWARD]) for e in named[S.REMAT_REPLAY])


class Counting:
    """A stand-in for a profiler range's class that counts its uses and
    does the real range's work."""

    def __init__(self, real):
        self.real, self.made = real, 0

    def __call__(self, *args, **kw):
        self.made += 1
        return self.real(*args, **kw)


@pytest.mark.parametrize("case", CASES)
def test_without_a_profiler_no_range_is_opened(case, monkeypatch):
    api, model, state, batches = setup(case)
    step = make_train_step(api, adamw.AdamWConfig())
    fast = Counting(torch._C._profiler._RecordFunctionFast)
    user = Counting(torch.autograd.profiler.record_function)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", fast)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", user)
    monkeypatch.setattr(torch.profiler, "record_function", user)
    step(model, state, batches[0])
    gc.collect()
    assert fast.made == user.made == 0
    assert not S.enabled() and S.span(S.STEP) is S.span(S.LOSS)
    # the same stand-in sees the ranges a profiled step opens
    with profile(activities=[ProfilerActivity.CPU]):
        step(model, state, batches[1])
    assert fast.made >= len(ONCE) + 2 * LAYERS and user.made == 0


def two_steps(case, profiled: bool):
    api, model, state, batches = setup(case)
    step = make_train_step(api, adamw.AdamWConfig(warmup_steps=1))
    losses = []
    with profile(activities=[ProfilerActivity.CPU]) if profiled \
            else contextlib.nullcontext():
        for b in batches:
            model, state, m = step(model, state, b)
            losses.append(m["loss"])
    return (losses, [p.detach().clone()
                     for p in flat_params(api.param_tree(model))],
            state.m, state.v)


@pytest.mark.parametrize("case", CASES)
def test_a_profiled_step_computes_the_same_bits(case):
    on, off = two_steps(case, True), two_steps(case, False)
    for a, b in zip(on, off):
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_gc_collections_are_spans():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        gc.collect()
    assert [e[0] for e in span_events(prof)].count(S.GC) >= 1


def test_sharded_step_collectives_are_spans():
    res = run_mesh(profiled_sharded_step_rank, 1, 2, backend="gloo",
                   device="cpu", args=("rwkv6_1_6b",), timeout=300)
    for names in res:
        for n in (S.STEP, S.FORWARD, S.BACKWARD, S.GRAD_NORM, S.OPTIMIZER):
            assert names.count(n) == 1, (n, names)
        # the weights' gather and the gradients' sum
        assert names.count(S.PREFIX + "gather") == 1
        assert names.count(S.PREFIX + "all_reduce") == 1
