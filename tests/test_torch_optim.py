"""PyTorch port of the optimizer and the gradient compression
(``optim/adamw.py``, ``optim/compression.py``) against the reference on
the CPU.

Tolerances, in f32: ``schedule`` and ``global_norm`` within 1e-6
relative (one f32 rounding apart: JAX sums a leaf in another order); one
AdamW ``update`` within 1e-6 absolute and relative on the parameters and
moments (parameters of order 1, an update of order lr); the int8 round
trip bit for bit (``torch.round`` and ``jnp.round`` both round half to
even).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as JA
from repro.optim import compression as JC
from repro_torch.optim import adamw as TA
from repro_torch.optim import compression as TC

SHAPES = [(8, 4), (16,), (3, 5, 2), ()]


def leaves(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return [np.asarray(rng.standard_normal(s) * scale, np.float32)
            for s in SHAPES]


@pytest.mark.parametrize("cfg", [
    TA.AdamWConfig(),
    TA.AdamWConfig(warmup_steps=1, total_steps=4),
    TA.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10,
                   min_lr_frac=0.0)])
def test_schedule_over_steps(cfg):
    jcfg = JA.AdamWConfig(**dataclasses.asdict(cfg))
    for step in list(range(0, 12)) + [50, 99, 100, 101, 5000, 10_000, 12_000]:
        s = np.int32(step)
        got = TA.schedule(cfg, torch.tensor(s))
        want = JA.schedule(jcfg, jnp.asarray(s))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   atol=0)


def test_global_norm():
    g = leaves(1, 3.0)
    got = TA.global_norm([torch.from_numpy(x) for x in g])
    want = JA.global_norm(g)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # a None leaf (a weight the loss misses) adds nothing
    got_none = TA.global_norm([torch.from_numpy(x) for x in g] + [None])
    assert float(got_none) == float(got)


@pytest.mark.parametrize("grad_scale", [0.01, 10.0])    # unclipped, clipped
@pytest.mark.parametrize("step0", [0, 7])
def test_one_update_matches_the_reference(grad_scale, step0):
    cfg = TA.AdamWConfig(lr=1e-2, warmup_steps=3, total_steps=20)
    jcfg = JA.AdamWConfig(**dataclasses.asdict(cfg))
    p, g = leaves(2), leaves(3, grad_scale)
    m, v = leaves(4, 0.1), [np.asarray(np.abs(x), np.float32)
                            for x in leaves(5, 0.1)]
    jstate = JA.AdamWState(step=jnp.int32(step0), m=list(map(jnp.asarray, m)),
                           v=list(map(jnp.asarray, v)))
    jp, jst, jinfo = JA.update(jcfg, list(map(jnp.asarray, g)), jstate,
                               list(map(jnp.asarray, p)))
    tp = [torch.from_numpy(x.copy()) for x in p]
    state = TA.AdamWState(step=torch.tensor(step0, dtype=torch.int32),
                          m=[torch.from_numpy(x.copy()) for x in m],
                          v=[torch.from_numpy(x.copy()) for x in v])
    out_p, st, info = TA.update(cfg, [torch.from_numpy(x) for x in g],
                                state, tp)
    assert out_p is tp                       # updated in place
    assert st.step.dtype == torch.int32 and int(st.step) == step0 + 1
    for got, want in zip(tp + st.m + st.v, list(jp) + list(jst.m)
                         + list(jst.v)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(info["grad_norm"]),
                               float(jinfo["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(float(info["lr"]), float(jinfo["lr"]),
                               rtol=1e-6)


def test_update_of_bf16_params_keeps_their_dtype():
    """bf16 parameters, f32 moments: the new parameters are the f32 update
    rounded once to bf16, as the reference's ``astype(p.dtype)``."""
    cfg = TA.AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=4)
    jcfg = JA.AdamWConfig(**dataclasses.asdict(cfg))
    p, g = leaves(6), leaves(7)
    jp, _, _ = JA.update(jcfg, [jnp.asarray(x, jnp.bfloat16) for x in g],
                         JA.init([jnp.asarray(x, jnp.bfloat16) for x in p]),
                         [jnp.asarray(x, jnp.bfloat16) for x in p])
    tp = [torch.from_numpy(x).to(torch.bfloat16) for x in p]
    st = TA.init(tp)
    assert all(m.dtype == torch.float32 for m in st.m + st.v)
    TA.update(cfg, [torch.from_numpy(x).to(torch.bfloat16) for x in g], st,
              tp)
    for got, want in zip(tp, jp):
        assert got.dtype == torch.bfloat16
        diff = np.abs(got.float().numpy() - np.asarray(want, np.float32))
        # at most one bf16 rounding step apart
        assert (diff <= 2.0 ** -7 * np.abs(np.asarray(want, np.float32))
                + 1e-30).all()


def test_none_gradient_is_a_zero_one():
    cfg = TA.AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=4)
    p = [torch.ones(3), torch.ones(2)]
    q = [torch.ones(3), torch.ones(2)]
    g = torch.full((3,), 0.5)
    TA.update(cfg, [g, None], TA.init(p), p)
    TA.update(cfg, [g, torch.zeros(2)], TA.init(q), q)
    for a, b in zip(p, q):
        assert torch.equal(a, b)


def test_int8_compression_bit_for_bit():
    g = leaves(8, 2.0) + [np.zeros((4, 4), np.float32),
                          np.array([0.5, -0.5, 1.5, 2.5, -2.5, 127.0],
                                   np.float32)]
    got = TC.compress_grads([torch.from_numpy(x) for x in g], "int8")
    want = JC.compress_grads([jnp.asarray(x) for x in g], "int8")
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        assert a.numpy().tobytes() == np.asarray(b).tobytes()
    ints = torch.arange(5, dtype=torch.int32)
    assert TC.compress_grads([ints], "int8")[0] is ints
    assert TC.compress_grads(g, "none") is g
    with pytest.raises(ValueError, match="unknown compression"):
        TC.compress_grads(g, "fp8")


def test_grad_compression_int8_close():
    """The reference's bound (tests/test_checkpoint_train.py)."""
    g = {"w": torch.from_numpy(np.random.default_rng(0)
                               .standard_normal((64, 64)).astype(np.float32))}
    gq = TC.compress_grads(g, "int8")
    err = float((g["w"] - gq["w"]).abs().max())
    assert err < float(g["w"].abs().max()) / 100
