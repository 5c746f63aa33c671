"""PyTorch port, Griffin / RecurrentGemma (the hybrid family) against the
JAX reference on the CPU: the RG-LRU scan against ``_rglru_scan``, the
recurrent branch, ``forward``, ``loss`` and ``decode_step`` across the
local-attention ring's wrap, and the registry's entries.

Reduced recurrentgemma-2b has 2 layers, so no super-block and no
attention; the model cases also run it with 5 layers (one super-block of
recurrent, recurrent, local attention, then 2 tail blocks, the published
26 layers' 8 + 2 pattern) and a window of 6, so decode wraps the ring
within 10 tokens.  The reference's own init is carried across with
``params_from_numpy``; the same numpy-seeded inputs go through both.
Tolerance 1e-4 (absolute and relative) in f32, as in
test_torch_models.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import registry as JREG
from repro.models import rglru as JG
from repro_torch import configs as TC
from repro_torch.models import registry as TREG
from repro_torch.models import rglru as TG

TOL = 1e-4
CASES = {"reduced": {}, "super-block": {"n_layers": 5, "window": 6}}


def close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


@pytest.fixture(scope="module", params=list(CASES))
def carried(request):
    over = CASES[request.param]
    jcfg = dataclasses.replace(JC.get_reduced("recurrentgemma_2b"), **over)
    tcfg = dataclasses.replace(TC.get_reduced("recurrentgemma_2b"), **over)
    jp = JG.init_griffin(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jcfg, jp, tcfg, TG.params_from_numpy(tree, tcfg, "cpu")


@pytest.mark.parametrize("s", [1, 2, 7, 64, 100])
@pytest.mark.parametrize("with_h0", [False, True])
def test_scan_matches_the_reference(s, with_h0):
    rng = np.random.default_rng(s)
    a = rng.uniform(0.5, 1.0, (2, s, 8)).astype(np.float32)
    b = rng.standard_normal((2, s, 8)).astype(np.float32)
    h0 = rng.standard_normal((2, 8)).astype(np.float32) if with_h0 else None
    want = JG._rglru_scan(jnp.asarray(a), jnp.asarray(b),
                          None if h0 is None else jnp.asarray(h0))
    got = TG._rglru_scan(torch.from_numpy(a), torch.from_numpy(b),
                         None if h0 is None else torch.from_numpy(h0))
    close(got, want)
    # and the sequential recurrence
    h = np.zeros((2, 8), np.float32) if h0 is None else h0
    for t in range(s):
        h = a[:, t] * h + b[:, t]
    close(got[:, -1], h)


def test_recurrent_branch_matches_the_reference(carried):
    jcfg, jp, tcfg, tp = carried
    x = np.random.default_rng(1).standard_normal(
        (2, 9, jcfg.d_model)).astype(np.float32)
    jrec = jax.tree_util.tree_map(lambda a: a[0], jp.tail)
    close(TG._rec_train(tp.tail[0], torch.from_numpy(x)),
          JG._rec_train(jrec, jnp.asarray(x)))


def test_forward_and_loss_match_the_reference(carried):
    jcfg, jp, tcfg, tp = carried
    toks = tokens(2, 2, 12, jcfg.vocab)
    close(TG.forward(tp, torch.from_numpy(toks), tcfg),
          JG.forward(jp, jnp.asarray(toks), jcfg))
    close(TG.lm_loss(tp, torch.from_numpy(toks), tcfg),
          JG.lm_loss(jp, jnp.asarray(toks), jcfg))


def test_decode_across_the_window_wrap_matches_the_reference(carried):
    jcfg, jp, tcfg, tp = carried
    toks = tokens(3, 2, 10, jcfg.vocab)
    jst = JG.init_state(jcfg, 2)
    tst = TG.init_state(tcfg, 2, "cpu")
    assert tst.attn.k.shape == jst.attn.k.shape
    for i in range(toks.shape[1]):
        jl, jst = JG.decode_step(jp, jst, jnp.asarray(toks[:, i]), jcfg)
        tl, tst = TG.decode_step(tp, tst, torch.from_numpy(toks[:, i]), tcfg)
        close(tl, jl)
        for got, want in ((tst.rec1, jst.rec1), (tst.rec2, jst.rec2),
                          (tst.tail, jst.tail), (tst.attn, jst.attn)):
            for g, w in zip(got, want):
                close(g, w)
        assert tst.pos == int(jst.pos) == i + 1


def test_decode_matches_forward(carried):
    """Step-by-step decode reproduces the forward's logits past the
    window (tests/test_models.py's griffin check, at its tolerance)."""
    jcfg, jp, tcfg, tp = carried
    api = TREG.build(tcfg, device="cpu")
    toks = torch.from_numpy(tokens(4, 1, 10, jcfg.vocab))
    full = api.forward(tp, {"tokens": toks})
    st = api.decode_init(tp, {"tokens": toks}, 0)
    outs = []
    for t in range(toks.shape[1]):
        lg, st = api.decode_step(tp, st, toks[:, t])
        outs.append(lg)
    close(torch.stack(outs, 1), full.numpy(), 1e-3)


def test_registry_and_init_match_the_reference(carried):
    jcfg, jp, tcfg, tp = carried
    toks = tokens(5, 2, 8, jcfg.vocab)
    japi, tapi = JREG.build(jcfg), TREG.build(tcfg, device="cpu")
    assert tapi.prefill is None and japi.prefill is None
    close(tapi.loss(tp, {"tokens": torch.from_numpy(toks)}),
          japi.loss(jp, {"tokens": jnp.asarray(toks)}))
    model = tapi.init(torch.Generator().manual_seed(0))
    got = {k: (tuple(v.shape), v.dtype) for k, v in model.named_parameters()}
    want = {k: (tuple(v.shape), v.dtype) for k, v in tp.named_parameters()}
    assert got == want
    assert (TG.n_super(tcfg), TG.n_tail(tcfg)) == (JG.n_super(jcfg),
                                                   JG.n_tail(jcfg))
    full = TC.get("recurrentgemma_2b")
    assert (TG.n_super(full), TG.n_tail(full)) == (8, 2)
