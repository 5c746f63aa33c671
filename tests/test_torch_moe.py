"""PyTorch port, MoE and VLM serving paths against the JAX reference on the
CPU: ``moe_ffn`` (with drops, with padded experts, at a decode batch where
the capacity is 1, top-1 with a shared expert), the load-balancing loss,
and the MoE transformer's forward, loss, prefill and decode; then the VLM
prefix forward and loss of reduced internvl2-1b.

The reference's own init (``jax.random.PRNGKey(0)``) is carried across
with ``params_from_numpy``; the same numpy-seeded tokens and embeddings
go through both.  Tolerance 1e-4 (absolute and relative) in f32, as in
test_torch_models.py: the two sides sum in other orders, nothing else
(the routing decisions, which are discrete, must be equal)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import moe as JM
from repro.models import registry as JREG
from repro.models import transformer as JT
from repro_torch import configs as TC
from repro_torch.models import moe as TM
from repro_torch.models import registry as TREG
from repro_torch.models import transformer as TT

TOL = 1e-4
# reduced qwen2-moe (60 experts top-4 with 4 shared: reduced to 4 top-4,
# 1 shared), the same with its experts padded to 16, and llama4-scout
# (16 experts top-1 with 1 shared)
MOE = {"qwen": ("qwen2_moe_a2_7b", {}),
       "qwen-padded": ("qwen2_moe_a2_7b", {"moe_pad_experts": True}),
       "scout": ("llama4_scout_17b_a16e", {})}


def close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def carried(name, **over):
    """(reference config, reference params, port config, port model)."""
    jcfg = dataclasses.replace(JC.get_reduced(name), **over)
    tcfg = dataclasses.replace(TC.get_reduced(name), **over)
    jp = JREG.build(jcfg).init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jcfg, jp, tcfg, TT.params_from_numpy(tree, tcfg, "cpu")


@pytest.fixture(scope="module", params=list(MOE))
def moe(request):
    name, over = MOE[request.param]
    return carried(name, **over)


def layer0(jp):
    """Layer 0's MoE weights of the stacked reference params."""
    return jax.tree_util.tree_map(lambda a: a[0], jp.layers.moe)


@pytest.mark.parametrize("factor", [None, 0.5])
@pytest.mark.parametrize("b,s", [(2, 24), (4, 1)])
def test_moe_ffn_matches_the_reference(moe, b, s, factor):
    """At the config's capacity factor (1.25) and at 0.5, where pairs drop,
    over B·S = 48 tokens and over a decode batch of 4 tokens (capacity 1
    for llama4-scout's top-1 of 4 experts)."""
    jcfg, jp, tcfg, tp = moe
    if factor is not None:
        jcfg = dataclasses.replace(jcfg, capacity_factor=factor)
        tcfg = dataclasses.replace(tcfg, capacity_factor=factor)
    x = np.random.default_rng(b * s).standard_normal(
        (b, s, jcfg.d_model)).astype(np.float32)
    want = JM.moe_ffn(layer0(jp), jnp.asarray(x), jcfg)
    got = TM.moe_ffn(tp.layers[0].moe, torch.from_numpy(x), tcfg)
    close(got, want)
    _, _, pos = TM.route(tp.layers[0].moe, torch.from_numpy(x).reshape(
        b * s, -1), tcfg)
    cap = TM.capacity(tcfg, b * s)
    if factor is not None:
        assert bool((pos >= cap).any())           # pairs were dropped
    if (b, s, factor, tcfg.top_k) == (4, 1, None, 1):
        assert cap == 1


def test_padded_experts_hold_no_tokens():
    jcfg, jp, tcfg, tp = carried("qwen2_moe_a2_7b", moe_pad_experts=True)
    assert TM.padded_experts(tcfg) == JM.padded_experts(jcfg) == 16
    m = tp.layers[0].moe
    assert m.w_gate.shape[0] == 16 and m.router.shape[1] == tcfg.n_experts
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (64, jcfg.d_model)).astype(np.float32))
    _, topi, _ = TM.route(m, x, tcfg)
    assert int(topi.max()) < tcfg.n_experts


def test_top_k_breaks_ties_toward_the_lower_expert():
    """Equal gates pick the lower index first, as jax.lax.top_k does."""
    cfg = dataclasses.replace(TC.get_reduced("qwen2_moe_a2_7b"), top_k=2)
    m = TM.init_moe(torch.Generator().manual_seed(0), cfg, device="cpu")
    with torch.no_grad():
        m.router.zero_()                           # every gate 1/E
    _, topi, pos = TM.route(m, torch.ones((3, cfg.d_model)), cfg)
    assert topi.tolist() == [[0, 1]] * 3
    assert pos.tolist() == [[0, 0], [1, 1], [2, 2]]
    jv, ji = jax.lax.top_k(jnp.full((3, 4), 0.25), 2)
    assert np.asarray(ji).tolist() == topi.tolist()


def test_aux_load_balance_loss_matches_the_reference(moe):
    jcfg, jp, tcfg, tp = moe
    x = np.random.default_rng(7).standard_normal(
        (2, 16, jcfg.d_model)).astype(np.float32)
    close(TM.aux_load_balance_loss(torch.from_numpy(x), tp.layers[0].moe,
                                   tcfg),
          JM.aux_load_balance_loss(jnp.asarray(x), layer0(jp), jcfg))


def test_moe_forward_and_loss_match_the_reference(moe):
    jcfg, jp, tcfg, tp = moe
    toks = tokens(1, 2, 12, jcfg.vocab)
    close(TT.forward(tp, torch.from_numpy(toks), tcfg),
          JT.forward(jp, jnp.asarray(toks), jcfg))
    close(TT.lm_loss(tp, torch.from_numpy(toks), tcfg),
          JT.lm_loss(jp, jnp.asarray(toks), jcfg))


def test_moe_prefill_and_decode_match_the_reference(moe):
    jcfg, jp, tcfg, tp = moe
    toks = tokens(2, 2, 12, jcfg.vocab)
    jl, jst = JT.prefill(jp, jnp.asarray(toks[:, :8]), jcfg, 16)
    tl, tst = TT.prefill(tp, torch.from_numpy(toks[:, :8]), tcfg, 16)
    close(tl, jl)
    close(tst.cache.k, jst.cache.k)
    close(tst.cache.v, jst.cache.v)
    for i in range(8, 12):
        jl, jst = JT.decode_step(jp, jst, jnp.asarray(toks[:, i]), jcfg)
        tl, tst = TT.decode_step(tp, tst, torch.from_numpy(toks[:, i]),
                                 tcfg)
        close(tl, jl)
        close(tst.cache.k, jst.cache.k)
        assert tst.pos == int(jst.pos)


def test_moe_params_from_numpy_keeps_none_and_shapes():
    """The stacked MoE leaves split a layer each; a config without shared
    experts keeps them None."""
    jcfg, jp, tcfg, tp = carried("qwen2_moe_a2_7b", n_shared_experts=0,
                                 shared_expert_ff=0)
    assert jp.layers.moe.shared_gate is None
    for i, lp in enumerate(tp.layers):
        assert lp.mlp is None and lp.moe.shared_gate is None
        assert lp.moe.router.dtype == torch.float32
        np.testing.assert_array_equal(lp.moe.w_up.detach().numpy(),
                                      np.asarray(jp.layers.moe.w_up[i]))
    toks = tokens(4, 2, 10, jcfg.vocab)
    close(TT.forward(tp, torch.from_numpy(toks), tcfg),
          JT.forward(jp, jnp.asarray(toks), jcfg))


def test_moe_port_init_has_the_reference_shapes(moe):
    jcfg, jp, tcfg, tp = moe
    model = TREG.build(tcfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    got = {k: (tuple(v.shape), v.dtype) for k, v in model.named_parameters()}
    want = {k: (tuple(v.shape), v.dtype) for k, v in tp.named_parameters()}
    assert got == want


# --------------------------------------------------------------------------
# the VLM prefix (internvl2-1b)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vlm():
    return carried("internvl2_1b")


def test_vlm_prefix_forward_and_loss_match_the_reference(vlm):
    jcfg, jp, tcfg, tp = vlm
    toks = tokens(5, 2, 12, jcfg.vocab)
    patches = np.random.default_rng(6).standard_normal(
        (2, jcfg.n_patches, jcfg.d_model)).astype(np.float32)
    want = JT.forward(jp, jnp.asarray(toks), jcfg,
                      prefix_embed=jnp.asarray(patches))
    got = TT.forward(tp, torch.from_numpy(toks), tcfg,
                     prefix_embed=torch.from_numpy(patches))
    assert got.shape == (2, jcfg.n_patches + 12, jcfg.vocab)
    close(got, want)
    close(TT.lm_loss(tp, torch.from_numpy(toks), tcfg,
                     prefix_embed=torch.from_numpy(patches)),
          JT.lm_loss(jp, jnp.asarray(toks), jcfg,
                     prefix_embed=jnp.asarray(patches)))


def test_vlm_registry_takes_the_patches(vlm):
    """The registry's loss reads ``patches``, as the reference's does; its
    prefill runs on the tokens alone, as the reference's does."""
    jcfg, jp, tcfg, tp = vlm
    toks = tokens(8, 2, 10, jcfg.vocab)
    patches = np.random.default_rng(9).standard_normal(
        (2, jcfg.n_patches, jcfg.d_model)).astype(np.float32)
    japi, tapi = JREG.build(jcfg), TREG.build(tcfg, device="cpu")
    jb = {"tokens": jnp.asarray(toks), "patches": jnp.asarray(patches)}
    tb = {"tokens": torch.from_numpy(toks),
          "patches": torch.from_numpy(patches)}
    close(tapi.loss(tp, tb), japi.loss(jp, jb))
    jl, _ = japi.prefill(jp, jb, 16)
    tl, _ = tapi.prefill(tp, tb, 16)
    close(tl, jl)
    batch = TREG.make_batch(tcfg, 3, 5, torch.Generator().manual_seed(1),
                            "cpu")
    assert batch["patches"].shape == (3, tcfg.n_patches, tcfg.d_model)
    assert batch["patches"].dtype == torch.float32


def test_moe_serving_self_consistency_without_drops():
    """With capacity_factor = n_experts / top_k nothing drops, so prefill
    then decode equals the forward (the chip check's consistency cell)."""
    cfg = TC.get_reduced("qwen2_moe_a2_7b")
    cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    api = TREG.build(cfg, device="cpu")
    model = api.init(torch.Generator().manual_seed(2))
    toks = TREG.make_batch(cfg, 2, 12, torch.Generator().manual_seed(3),
                           "cpu")["tokens"]
    full = api.forward(model, {"tokens": toks})
    lp, st = api.prefill(model, {"tokens": toks[:, :11]}, 16)
    close(lp, full[:, 10].numpy(), 2e-3)
    ld, st = api.decode_step(model, st, toks[:, 11])
    close(ld, full[:, 11].numpy(), 2e-3)
