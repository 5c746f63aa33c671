"""PyTorch port, K2's backward ``wgmma`` route on the CPU: the forward's
log-sum-exp and the backward's explicit P/D/dS formula (the plain versions
of what the CUDA kernels compute) against the JAX reference, the
backward's route table, and the wrappers' refusals.

The log-sum-exp is held against ``jax.nn.logsumexp`` over the reference's
masked, scaled logits (``_sdpa_naive``'s, masked ones ``NEG_INF``), rows
that see no key included (NEG_INF + log Sk is NEG_INF in f32); the
formula against ``jax.grad`` of ``_sdpa_naive``; both at 1e-5 in f32 (the
two sum in other orders).  The cases are the attention cases of
tests/test_torch_train_grad.py: causal and full, GQA and MQA, a window,
Sq != Sk both ways, rows that see no key (the reference's gradient
jitted: op by op it spent ~3 s a case compiling); and at hd 256 (the ``wgmma``
route's widest tiles) the same kinds: MQA with a window inside the
sequence, rows that see no key, full and causal GQA, Sq != Sk both ways
and a full window.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro_torch.kernels.flash_attention.kernel import (BWD_WGMMA_HEAD_DIMS,
                                                        HEAD_DIMS,
                                                        _bwd_route,
                                                        flash_attention,
                                                        flash_attention_bwd)
from repro_torch.kernels.flash_attention.ops import flash_sdpa
from repro_torch.kernels.flash_attention.ref import (attention_bwd_lse_ref,
                                                     attention_bwd_ref,
                                                     attention_lse_ref,
                                                     attention_ref)

ATTN_CASES = [  # b, h, kv, sq, sk, hd, causal, window
    (2, 4, 2, 16, 16, 16, True, 0),      # causal, GQA
    (1, 2, 2, 12, 12, 32, False, 0),     # full
    (2, 4, 1, 20, 20, 16, True, 5),      # window, MQA
    (1, 4, 2, 10, 7, 16, False, 0),      # Sq != Sk (cross)
    (1, 2, 1, 18, 6, 16, True, 4),       # rows that see no key
    (1, 2, 2, 9, 14, 32, False, 3),      # full window, Sq < Sk
    (1, 2, 1, 20, 20, 256, True, 7),     # hd 256: MQA, window inside
    (1, 2, 1, 14, 5, 256, True, 3),      # hd 256: rows that see no key
    (1, 4, 2, 9, 12, 256, False, 0),     # hd 256: full, GQA, Sq < Sk
    (2, 4, 2, 17, 17, 256, True, 0),     # hd 256: causal, GQA, batch 2
    (1, 4, 1, 13, 8, 256, False, 0),     # hd 256: Sq > Sk, MQA
    (1, 2, 2, 11, 19, 256, False, 5)]    # hd 256: full window, Sq < Sk


def attn_inputs(seed, b, h, kv, sq, sk, hd):
    """q, k, v, dO in the model layout [B,S,H,hd], f32."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, hd), (b, sk, kv, hd), (b, sk, kv, hd),
                      (b, sq, h, hd))]


def kernel_layout(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).transpose(1, 2)


def reference_lse(q, k, causal, window):
    """jax.nn.logsumexp over _sdpa_naive's masked, scaled logits, as
    [B, H, Sq] (query head h = kv * G + g)."""
    b, sq, h, hd = q.shape
    kvh, sk = k.shape[2], k.shape[1]
    logits = jnp.einsum("bqkgh,bskh->bkgqs", JA._group_heads(q, kvh), k,
                        preferred_element_type=jnp.float32) * hd ** -0.5
    qpos, kpos = jnp.arange(sq), jnp.arange(sk)
    mask = jnp.ones((sq, sk), bool)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window:
        mask &= qpos[:, None] - kpos[None, :] < window
    logits = jnp.where(mask, logits, JA.NEG_INF)
    return np.asarray(jax.jit(jax.nn.logsumexp, static_argnums=1)(
        logits, -1)).reshape(b, h, sq)


@pytest.mark.parametrize("b,h,kv,sq,sk,hd,causal,window", ATTN_CASES)
def test_lse_plain_version_matches_jax_logsumexp(b, h, kv, sq, sk, hd,
                                                 causal, window):
    q, k, _, _ = attn_inputs(sq * 5 + sk, b, h, kv, sq, sk, hd)
    want = reference_lse(q, k, causal, window)
    got = attention_lse_ref(kernel_layout(q), kernel_layout(k),
                            causal=causal, window=window)
    assert got.dtype == torch.float32 and got.shape == (b, h, sq)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    blind = np.arange(sq) - (sk - 1) >= window if window else np.zeros(sq,
                                                                       bool)
    # a row that sees no key: NEG_INF exactly, on both sides
    assert np.all(got.numpy()[:, :, blind] == np.float32(JA.NEG_INF))
    assert np.all(want[:, :, blind] == np.float32(JA.NEG_INF))
    if (sq, sk, window) == (18, 6, 4):
        assert blind.sum() == 9


@pytest.mark.parametrize("b,h,kv,sq,sk,hd,causal,window", ATTN_CASES)
def test_bwd_lse_plain_version_matches_jax_grad(b, h, kv, sq, sk, hd,
                                                causal, window):
    q, k, v, do = attn_inputs(sq * 7 + sk, b, h, kv, sq, sk, hd)
    f = lambda q, k, v: jnp.sum(JA._sdpa_naive(
        q, k, v, causal=causal, window=window) * do)
    want = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(q, k, v)
    tq, tk, tv, tdo = map(kernel_layout, (q, k, v, do))
    kw = dict(causal=causal, window=window)
    o = attention_ref(tq, tk, tv, **kw)
    lse = attention_lse_ref(tq, tk, **kw)
    got = attention_bwd_lse_ref(tq, tk, tv, o, tdo, lse, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.transpose(1, 2).numpy(), w, atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("window", [0, 7])
def test_bwd_route_table(dtype, hd, window):
    """bf16 at hd 64, 128 and 256 takes wgmma, with or without a window;
    f32 never does (it stays within 2e-5 on FMA), nor bf16 at 16 and 32."""
    want = ("wgmma" if dtype == torch.bfloat16 and hd in (64, 128, 256)
            else "fma")
    assert _bwd_route(dtype, hd, window) == want
    assert BWD_WGMMA_HEAD_DIMS == (64, 128, 256)


def bf16_inputs(b=1, h=4, kv=2, sq=24, sk=24, hd=64, seed=3):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(torch.bfloat16)
            for s in ((b, h, sq, hd), (b, kv, sk, hd), (b, kv, sk, hd),
                      (b, h, sq, hd))]


def counts():
    return (flash_attention.launches, flash_attention.launches_wgmma,
            flash_attention.launches_fma, flash_attention_bwd.launches,
            flash_attention_bwd.launches_wgmma,
            flash_attention_bwd.launches_fma)


BAD_LSE = {
    "missing": lambda q: None,
    "misshapen": lambda q: torch.zeros(q.shape[:2] + (q.shape[2] + 1,)),
    "not float32": lambda q: torch.zeros(q.shape[:3], dtype=torch.bfloat16),
    "off the device": lambda q: torch.zeros(q.shape[:3], device="meta"),
    "not contiguous": lambda q: torch.zeros(
        (q.shape[0], q.shape[2], q.shape[1])).transpose(1, 2),
}


@pytest.mark.parametrize("bad", list(BAD_LSE))
def test_bwd_wgmma_route_refuses_a_bad_lse(bad):
    """The wgmma route (bf16, hd 64) raises before any launch when the
    forward's lse is missing, misshapen, not f32, on another device or
    not contiguous; the forward refuses the same lse (but a missing one,
    which it does not need)."""
    q, k, v, do = bf16_inputs()
    lse = BAD_LSE[bad](q)
    n0 = counts()
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, k, v, q, do, lse=lse)
    if lse is not None:
        with pytest.raises(ValueError, match="lse"):
            flash_attention(q, k, v, lse=lse)
    assert counts() == n0


def test_fma_route_refuses_an_lse():
    """f32 (and bf16 at hd 32) takes the fma route, which reads no lse:
    both wrappers raise when given one."""
    q, k, v, do = (x.float() for x in bf16_inputs())
    lse = torch.zeros(q.shape[:3])
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, k, v, q, do, lse=lse)
    with pytest.raises(ValueError, match="lse"):
        flash_attention(q, k, v, lse=lse)
    q, k, v, do = bf16_inputs(hd=32)
    with pytest.raises(ValueError, match="lse"):
        flash_attention(q, k, v, lse=torch.zeros(q.shape[:3]))


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 9)])
def test_cpu_calls_run_the_plain_versions_and_count_no_launch(causal,
                                                              window):
    """On CPU tensors the forward writes attention_lse_ref into ``lse`` and
    the wgmma route's backward is attention_bwd_lse_ref, bit for bit; no
    launch of either wrapper, on either route, is counted."""
    q, k, v, do = bf16_inputs(sq=40, sk=30)
    kw = dict(causal=causal, window=window)
    n0 = counts()
    lse = torch.full(q.shape[:3], float("nan"))
    o = flash_attention(q, k, v, lse=lse, **kw)
    assert torch.equal(o, attention_ref(q, k, v, **kw))
    assert torch.equal(lse, attention_lse_ref(q, k, **kw))
    grads = tuple(torch.empty_like(x) for x in (q, k, v))
    got = flash_attention_bwd(q, k, v, o, do, lse=lse, grads=grads, **kw)
    want = attention_bwd_lse_ref(q, k, v, o, do, lse, **kw)
    for g, x, w in zip(got, grads, want):
        assert g is x and torch.equal(g, w)
    assert counts() == n0


def test_autograd_function_saves_the_lse_on_the_wgmma_route():
    """Through the model layout's autograd Function: bf16 at hd 64 saves
    the forward's f32 lse and its backward is the wgmma route's plain
    version, within the bf16 tolerance of the plain autograd (4e-2
    absolute plus 2e-2 relative: P, dS and the outputs rounded to bf16 on
    one side only); f32 saves none and keeps the plain autograd."""
    t = lambda x: x.transpose(1, 2)
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do = (t(x).to(dtype) for x in bf16_inputs(sq=33, sk=33))
        leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        out = flash_sdpa(*leaves, causal=True)
        saved = out.grad_fn.saved_tensors
        if dtype == torch.bfloat16:
            assert saved[4].dtype == torch.float32
            assert torch.equal(saved[4], attention_lse_ref(t(q), t(k)))
        else:
            assert saved[4] is None
        (out.float() * do.float()).sum().backward()
        want = attention_bwd_ref(*(t(x).float() for x in (q, k, v)),
                                 t(do).float())
        tol = (4e-2, 2e-2) if dtype == torch.bfloat16 else (1e-5, 1e-5)
        for x, w in zip(leaves, want):
            assert x.grad.dtype == dtype
            np.testing.assert_allclose(t(x.grad).float().numpy(), w.numpy(),
                                       atol=tol[0], rtol=tol[1])
