"""PyTorch port, the training path's gradients: ``loss.backward()`` against
``jax.value_and_grad(api.loss)`` on the CPU, and the plain versions of
the attention and WKV6 backward kernels against ``jax.grad`` of the
reference's jnp attention and WKV6 oracle.

The reference's own init (``jax.random.PRNGKey(0)``) is carried across
with ``params_from_numpy``, the same numpy batch goes through both, and
the port's gradients come back in the reference's tree through
``params_to_numpy``'s stacking (``api.param_tree``).  Tolerance: the loss
within 1e-4 (absolute and relative), every gradient leaf within
1e-4 · max(1, max|g_ref|) absolute, in f32 — the two sides sum in other
orders, nothing else.  A leaf the loss does not reach (Griffin's unused
tail block) has the reference's zero gradient.  The reference's gradients
are jitted: one compiled program where op-by-op dispatch compiled each op
(reduced recurrentgemma's ``value_and_grad`` 24 s eager, 4 s jitted, on
the CPU), the same function in f32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.kernels.rwkv_scan import ref as JWKV
from repro.models import attention as JA
from repro.models import registry as JREG
from repro_torch import configs as TC
from repro_torch.checkpoint.manager import tree_flatten
from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd
from repro_torch.kernels.flash_attention.ops import flash_sdpa
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
from repro_torch.kernels.rwkv_scan.kernel import wkv6_bwd
from repro_torch.kernels.rwkv_scan.ops import wkv6_seq
from repro_torch.kernels.rwkv_scan.ref import wkv6_bwd_ref
from repro_torch.models import registry as TREG
from repro_torch.models import rglru as TG
from repro_torch.models import rwkv6 as TR
from repro_torch.models import transformer as TT
from repro_torch.models import whisper as TW
from repro_torch.models.common import tree_to_host

TOL = 1e-4
FROM_NUMPY = {"dense": TT, "moe": TT, "vlm": TT, "ssm": TR, "hybrid": TG,
              "audio": TW}

# every family, reduced; qwen also at a capacity factor that drops pairs,
# recurrentgemma with 5 layers and window 6 (a super-block's attention)
FAMILIES = {"smollm_135m": {}, "granite_3_8b": {}, "rwkv6_1_6b": {},
            "qwen2_moe_a2_7b": {},
            "qwen2_moe_a2_7b-drop": {"capacity_factor": 0.5},
            "llama4_scout_17b_a16e": {}, "internvl2_1b": {},
            "whisper_medium": {},
            "recurrentgemma_2b": {"n_layers": 5, "window": 6}}


def configs(case):
    name = case.split("-")[0]
    over = FAMILIES[case]
    return (dataclasses.replace(JC.get_reduced(name), **over),
            dataclasses.replace(TC.get_reduced(name), **over))


def numpy_batch(cfg, b=2, s=12, seed=5):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (b, cfg.n_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return out


def carried_model(jcfg, tcfg, seed=0):
    """(reference params, the port's model with the same weights)."""
    jp = JREG.build(jcfg).init(jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jp, FROM_NUMPY[tcfg.family].params_from_numpy(tree, tcfg, "cpu")


def grad_or_zeros(p):
    """``p.grad``, or zeros for a weight the loss does not reach (the
    reference's gradient of an unused leaf)."""
    return torch.zeros_like(p) if p.grad is None else p.grad


def port_grads(api, model, batch):
    """(loss, the gradient tree on the host in the reference's order)."""
    for p in model.parameters():
        p.grad = None
    loss = api.loss(model, {k: torch.from_numpy(v) for k, v in
                            batch.items()})
    loss.backward()
    return loss, tree_to_host(api.param_tree(model), grad_or_zeros)


def assert_leaves_close(got_tree, want_tree):
    got, _ = tree_flatten(got_tree)
    want = jax.tree_util.tree_leaves(want_tree)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w, np.float32)
        g = np.asarray(g, np.float32)
        assert g.shape == w.shape, (i, g.shape, w.shape)
        bound = TOL * max(1.0, float(np.abs(w).max(initial=0.0)))
        err = float(np.abs(g - w).max(initial=0.0))
        assert err <= bound, (i, err, bound)


def counted_super_blocks(monkeypatch):
    """Count the calls of Griffin's super-block (its forward, and its
    rerun in the backward under the rematerialisation)."""
    calls = []
    block = TG._super_block

    def counted(*args):
        calls.append(1)
        return block(*args)
    monkeypatch.setattr(TG, "_super_block", counted)
    return calls


@pytest.mark.parametrize("case", list(FAMILIES))
def test_loss_and_every_gradient_leaf_match_the_reference(case,
                                                          monkeypatch):
    jcfg, tcfg = configs(case)
    jp, model = carried_model(jcfg, tcfg)
    batch = numpy_batch(jcfg)
    japi = JREG.build(jcfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(japi.loss))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    api = TREG.build(tcfg, device="cpu")
    calls = counted_super_blocks(monkeypatch)
    loss, grads = port_grads(api, model, batch)
    np.testing.assert_allclose(loss.item(), float(jloss), atol=TOL,
                               rtol=TOL)
    assert_leaves_close(grads, jgrads)
    # every weight the loss reaches has a gradient
    reached = [p.grad is not None for p in model.parameters()]
    if tcfg.family != "hybrid":
        assert all(reached)
    else:
        # the gradients came through the rematerialisation: each
        # super-block ran in the forward and again in the backward
        assert len(calls) == 2 * TG.n_super(tcfg) > 0


@pytest.mark.parametrize("name", ["smollm_135m", "rwkv6_1_6b",
                                  "whisper_medium", "recurrentgemma_2b"])
def test_params_to_numpy_is_the_reference_tree(name):
    """``params_to_numpy`` gives the reference's tree: same structure, same
    leaf shapes, dtypes and values (the inverse of params_from_numpy)."""
    jcfg, tcfg = JC.get_reduced(name), TC.get_reduced(name)
    jp, model = carried_model(jcfg, tcfg)
    mod = FROM_NUMPY[tcfg.family]
    got = mod.params_to_numpy(model, tcfg)
    leaves, _ = tree_flatten(got)
    want = jax.tree_util.tree_leaves(jp)
    assert len(leaves) == len(want)
    for g, w in zip(leaves, want):
        assert g.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, np.asarray(w))
    assert type(got).__name__ == type(jp).__name__
    assert got._fields == jp._fields
    back = mod.params_to_numpy(mod.params_from_numpy(got, tcfg, "cpu"),
                               tcfg)
    for g, w in zip(tree_flatten(back)[0], leaves):
        np.testing.assert_array_equal(g, w)


def test_params_to_numpy_keeps_bf16_bit_for_bit():
    """bf16 leaves come back as CPU bf16 tensors of the reference's bits,
    and ``params_from_numpy`` takes them back."""
    jcfg = dataclasses.replace(JC.get_reduced("smollm_135m"),
                               dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(TC.get_reduced("smollm_135m"),
                               dtype=torch.bfloat16)
    jp, model = carried_model(jcfg, tcfg)
    got = TT.params_to_numpy(model, tcfg)
    back = TT.params_to_numpy(TT.params_from_numpy(got, tcfg, "cpu"), tcfg)
    for g, b, w in zip(tree_flatten(got)[0], tree_flatten(back)[0],
                       jax.tree_util.tree_leaves(jp)):
        assert g.dtype == b.dtype == torch.bfloat16
        np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                      np.asarray(w).view(np.int16))
        assert torch.equal(b.view(torch.int16), g.view(torch.int16))


def test_serving_paths_record_no_graph():
    """forward stays under inference_mode (no autograd node) while the
    weights are trainable and loss records the graph."""
    cfg = TC.get_reduced("smollm_135m")
    api = TREG.build(cfg, device="cpu")
    model = api.init(torch.Generator().manual_seed(0))
    assert all(p.requires_grad for p in model.parameters())
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 8))}
    out = api.forward(model, batch)
    assert out.is_inference() and out.grad_fn is None
    loss = api.loss(model, batch)
    assert loss.grad_fn is not None


# --------------------------------------------------------------------------
# the plain backward versions against jax.grad of the reference's jnp code
# --------------------------------------------------------------------------

ATTN_CASES = [  # b, h, kv, sq, sk, hd, causal, window
    (2, 4, 2, 16, 16, 16, True, 0),      # causal, GQA
    (1, 2, 2, 12, 12, 32, False, 0),     # full
    (2, 4, 1, 20, 20, 16, True, 5),      # window, MQA
    (1, 4, 2, 10, 7, 16, False, 0),      # Sq != Sk (cross)
    (1, 2, 1, 18, 6, 16, True, 4),       # rows that see no key
    (1, 2, 2, 9, 14, 32, False, 3)]      # full window, Sq < Sk


def attn_inputs(seed, b, h, kv, sq, sk, hd):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, hd), (b, sk, kv, hd), (b, sk, kv, hd),
                      (b, sq, h, hd))]


@pytest.mark.parametrize("b,h,kv,sq,sk,hd,causal,window", ATTN_CASES)
def test_attention_backward_plain_version_matches_jax_grad(
        b, h, kv, sq, sk, hd, causal, window):
    q, k, v, do = attn_inputs(sq * 7 + sk, b, h, kv, sq, sk, hd)
    f = lambda q, k, v: jnp.sum(JA._sdpa_naive(
        q, k, v, causal=causal, window=window) * do)
    want = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(q, k, v)
    t = lambda a: torch.from_numpy(a).transpose(1, 2)   # kernel layout
    got = attention_bwd_ref(t(q), t(k), t(v), t(do), causal=causal,
                            window=window)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.transpose(1, 2).numpy(), w,
                                   atol=1e-5, rtol=1e-5)
    # the wrapper on a CPU tensor and the model-layout autograd Function
    got_w = flash_attention_bwd(t(q), t(k), t(v), t(q), t(do),
                                causal=causal, window=window)
    for g, w in zip(got_w, got):
        assert torch.equal(g, w)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = flash_sdpa(*leaves, causal=causal, window=window)
    (out * torch.from_numpy(do)).sum().backward()
    for x, w in zip(leaves, want):
        np.testing.assert_allclose(x.grad.numpy(), w, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("b,h,t,n", [(2, 3, 1, 16), (1, 2, 9, 16),
                                     (2, 2, 17, 16)])
def test_wkv6_backward_plain_version_matches_jax_grad(b, h, t, n):
    rng = np.random.default_rng(b * 100 + t)
    r, k, v, do = (rng.standard_normal((b, h, t, n)).astype(np.float32)
                   for _ in range(4))
    w = rng.uniform(0.45, 0.95, (b, h, t, n)).astype(np.float32)
    u = rng.standard_normal((h, n)).astype(np.float32)
    f = lambda *xs: jnp.sum(JWKV.wkv6_ref(*xs) * do)
    want = jax.jit(jax.grad(f, argnums=(0, 1, 2, 3, 4)))(r, k, v, w, u)
    ts = [torch.from_numpy(a) for a in (r, k, v, w, u, do)]
    got = wkv6_bwd_ref(*ts)
    for g, x in zip(got, want):
        np.testing.assert_allclose(g.numpy(), x, atol=1e-4, rtol=1e-4)
    got_w = wkv6_bwd(*ts)
    for g, x in zip(got_w, got):
        assert torch.equal(g, x)
    # the model-layout autograd Function ([B,T,H,N])
    leaves = [torch.from_numpy(a).transpose(1, 2).contiguous()
              .requires_grad_(True) for a in (r, k, v, w)]
    leaves.append(torch.from_numpy(u).requires_grad_(True))
    out = wkv6_seq(*leaves)
    (out * torch.from_numpy(do).transpose(1, 2)).sum().backward()
    for x, g in zip(leaves[:4], got[:4]):
        assert torch.equal(x.grad.transpose(1, 2), g)
    assert torch.equal(leaves[4].grad, got[4])


def test_backward_wrappers_count_no_launch_on_cpu():
    n_fa, n_wkv = flash_attention_bwd.launches, wkv6_bwd.launches
    q, k, v, do = (torch.from_numpy(a).transpose(1, 2)
                   for a in attn_inputs(0, 1, 2, 1, 8, 8, 16))
    flash_attention_bwd(q, k, v, q, do)
    x = torch.rand((1, 2, 4, 16))
    wkv6_bwd(x, x, x, x, torch.rand((2, 16)), x)
    assert (flash_attention_bwd.launches, wkv6_bwd.launches) == (n_fa, n_wkv)
