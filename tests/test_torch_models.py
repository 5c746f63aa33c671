"""PyTorch port, LM serving paths: configs, registry, shared numerics and the
dense transformer and RWKV6 models against the JAX reference on the CPU.

The reference's own init (``jax.random.PRNGKey(0)``) is carried across
with ``params_from_numpy``; the same seeded tokens go through both.
Tolerance 1e-4 (absolute and relative) in f32 for every model output:
logits, KV caches, recurrent states and losses — the two sides sum in
other orders, nothing else.  The port's own prefill/decode == forward
checks mirror tests/test_models.py with its tolerances."""
import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import common as JCM
from repro.models import registry as JREG
from repro.models import rwkv6 as JR
from repro.models import transformer as JT
from repro_torch import configs as TC
from repro_torch.models import common as TCM
from repro_torch.models import registry as TREG
from repro_torch.models import rwkv6 as TR
from repro_torch.models import transformer as TT

TOL = 1e-4
DENSE = ["smollm_135m", "granite_3_8b"]
DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}


def close(got, want, tol=TOL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


# --------------------------------------------------------------------------
# configs and registry
# --------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", JC.ALL_ARCHS)
def test_configs_equal_the_reference_field_for_field(name, reduced):
    get_j = JC.get_reduced if reduced else JC.get
    get_t = TC.get_reduced if reduced else TC.get
    jcfg, tcfg = get_j(name), get_t(name)
    jf = dataclasses.asdict(jcfg)
    tf = dataclasses.asdict(tcfg)
    assert list(jf) == list(tf)
    jf["dtype"] = DTYPES[jf["dtype"]]
    assert jf == tf
    assert (tcfg.hd, tcfg.is_moe) == (jcfg.hd, jcfg.is_moe)
    for alias in (name, name.replace("_", "-")):
        assert TC.canon(alias) == JC.canon(alias)


@pytest.mark.parametrize("name", JC.ALL_ARCHS)
def test_registry_builds_every_config(name):
    """Every family is ported: the registry builds each config, with a
    prefill exactly where the reference has one."""
    cfg = TC.get_reduced(name)
    api = TREG.build(cfg, device="cpu")
    assert api.cfg is cfg
    japi = JREG.build(JC.get_reduced(name))
    assert (api.prefill is None) == (japi.prefill is None)
    assert (api.prefill is None) == (cfg.family in ("ssm", "hybrid",
                                                    "audio"))


def test_registry_defaults_to_cuda(monkeypatch):
    """Without a card the default device raises instead of falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TC.get_reduced("smollm_135m")
    with pytest.raises(RuntimeError, match="CUDA"):
        TREG.build(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        TREG.make_batch(cfg, 2, 8)


def test_registry_imports_no_unported_model():
    """The registry loads exactly the port's model modules, every family's
    (and so nothing of the reference)."""
    code = ("import sys, repro_torch.models.registry\n"
            "print(' '.join(sorted(m for m in sys.modules if m.startswith("
            "'repro_torch.models.'))))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"},
                         cwd=__file__.rsplit("/tests/", 1)[0])
    assert out.stdout.split() == [
        f"repro_torch.models.{m}" for m in
        ("attention", "common", "moe", "registry", "rglru", "rwkv6",
         "transformer", "whisper")]


def test_make_batch():
    cfg = TC.get_reduced("rwkv6_1_6b")
    a = TREG.make_batch(cfg, 3, 9, torch.Generator().manual_seed(4), "cpu")
    b = TREG.make_batch(cfg, 3, 9, torch.Generator().manual_seed(4), "cpu")
    assert a["tokens"].shape == (3, 9) and torch.equal(a["tokens"],
                                                       b["tokens"])
    assert 0 <= int(a["tokens"].min()) and int(a["tokens"].max()) < cfg.vocab


# --------------------------------------------------------------------------
# shared numerics
# --------------------------------------------------------------------------

def test_norms_rope_and_cross_entropy_match_the_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    sc = rng.standard_normal(16).astype(np.float32)
    bi = rng.standard_normal(16).astype(np.float32)
    pos = np.broadcast_to(np.arange(100, 105), (2, 5)).astype(np.int32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    close(TCM.rms_norm(tx, torch.from_numpy(sc), 1e-6),
          JCM.rms_norm(jx, jnp.asarray(sc), 1e-6))
    close(TCM.layer_norm(tx, torch.from_numpy(sc), torch.from_numpy(bi)),
          JCM.layer_norm(jx, jnp.asarray(sc), jnp.asarray(bi)))
    close(TCM.apply_rope(tx, torch.from_numpy(pos.copy()), 10_000.0),
          JCM.apply_rope(jx, jnp.asarray(pos), 10_000.0))
    logits = rng.standard_normal((2, 5, 40)).astype(np.float32)
    labels = rng.integers(0, 40, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) < 0.6).astype(np.float32)
    for m in (None, mask):
        close(TCM.cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels),
                                None if m is None else torch.from_numpy(m)),
              JCM.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                None if m is None else jnp.asarray(m)))


# --------------------------------------------------------------------------
# models: the reference's weights carried across
# --------------------------------------------------------------------------

def carried(name):
    """(reference config, reference params, port config, port model)."""
    jcfg, tcfg = JC.get_reduced(name), TC.get_reduced(name)
    jp = JREG.build(jcfg).init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    conv = TR if tcfg.family == "ssm" else TT
    return jcfg, jp, tcfg, conv.params_from_numpy(tree, tcfg, "cpu")


@pytest.fixture(scope="module", params=DENSE)
def dense(request):
    return carried(request.param)


@pytest.fixture(scope="module")
def rwkv():
    return carried("rwkv6_1_6b")


def test_params_from_numpy_keeps_values_dtypes_and_shapes():
    """bf16 weights arrive bit for bit, per layer, in the reference's
    shapes (wq [D,H,hd], ...)."""
    jcfg = dataclasses.replace(JC.get_reduced("smollm_135m"),
                               dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(TC.get_reduced("smollm_135m"),
                               dtype=torch.bfloat16)
    jp = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tp = TT.params_from_numpy(tree, tcfg, "cpu")
    for i, lp in enumerate(tp.layers):
        got = lp.attn.wq.detach()
        assert got.dtype == torch.bfloat16
        want = np.asarray(tree.layers.attn.wq[i]).view(np.uint16)
        np.testing.assert_array_equal(got.view(torch.int16).numpy().view(
            np.uint16), want)
    assert tp.lm_head is None and tp.head().shape == (tcfg.d_model,
                                                      tcfg.vocab)


@pytest.mark.parametrize("name", DENSE + ["rwkv6_1_6b"])
def test_port_init_has_the_reference_shapes(name):
    """The port's own init (a torch.Generator) gives every weight the
    reference's shape and dtype, layer by layer."""
    jcfg, jp, tcfg, _ = carried(name)
    api = TREG.build(tcfg, device="cpu")
    model = api.init(torch.Generator().manual_seed(0))
    conv = TR if tcfg.family == "ssm" else TT
    ref = conv.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 tcfg, "cpu")
    got = {k: (tuple(v.shape), v.dtype) for k, v in model.named_parameters()}
    want = {k: (tuple(v.shape), v.dtype) for k, v in ref.named_parameters()}
    assert got == want
    assert not any(v.requires_grad for v in model.parameters())


def test_dense_forward_and_loss_match_the_reference(dense):
    jcfg, jp, tcfg, tp = dense
    toks = tokens(1, 2, 12, jcfg.vocab)
    got = TT.forward(tp, torch.from_numpy(toks), tcfg)
    assert got.is_inference()
    close(got, JT.forward(jp, jnp.asarray(toks), jcfg))
    close(TT.lm_loss(tp, torch.from_numpy(toks), tcfg),
          JT.lm_loss(jp, jnp.asarray(toks), jcfg))


def test_dense_prefill_and_decode_match_the_reference(dense):
    jcfg, jp, tcfg, tp = dense
    toks = tokens(2, 2, 12, jcfg.vocab)
    jl, jst = JT.prefill(jp, jnp.asarray(toks[:, :8]), jcfg, 16)
    tl, tst = TT.prefill(tp, torch.from_numpy(toks[:, :8]), tcfg, 16)
    close(tl, jl)
    close(tst.cache.k, jst.cache.k)
    close(tst.cache.v, jst.cache.v)
    assert tst.pos == int(jst.pos) == 8
    for i in range(8, 12):
        jl, jst = JT.decode_step(jp, jst, jnp.asarray(toks[:, i]), jcfg)
        tl, tst = TT.decode_step(tp, tst, torch.from_numpy(toks[:, i]),
                                 tcfg)
        close(tl, jl)
        close(tst.cache.k, jst.cache.k)
        close(tst.cache.v, jst.cache.v)
        assert tst.pos == int(jst.pos)


def test_dense_decode_ring_buffer_wraps_like_the_reference(dense):
    """Past s_max the decode cache is a ring (floor-mod slots)."""
    jcfg, jp, tcfg, tp = dense
    toks = tokens(3, 1, 9, jcfg.vocab)
    jst = JT.init_decode(jcfg, 1, 4)
    tst = TT.init_decode(tcfg, 1, 4, "cpu")
    for i in range(9):
        jl, jst = JT.decode_step(jp, jst, jnp.asarray(toks[:, i]), jcfg)
        tl, tst = TT.decode_step(tp, tst, torch.from_numpy(toks[:, i]),
                                 tcfg)
        close(tl, jl)
    close(tst.cache.k, jst.cache.k)


def test_rwkv_forward_and_loss_match_the_reference(rwkv):
    jcfg, jp, tcfg, tp = rwkv
    toks = tokens(4, 2, 12, jcfg.vocab)
    close(TR.forward(tp, torch.from_numpy(toks), tcfg),
          JR.forward(jp, jnp.asarray(toks), jcfg))
    close(TR.lm_loss(tp, torch.from_numpy(toks), tcfg),
          JR.lm_loss(jp, jnp.asarray(toks), jcfg))


def test_rwkv_decode_matches_the_reference(rwkv):
    jcfg, jp, tcfg, tp = rwkv
    toks = tokens(5, 2, 4, jcfg.vocab)
    jst = JR.init_state(jcfg, 2)
    tst = TR.init_state(tcfg, 2, "cpu")
    assert tst.wkv.dtype == torch.float32
    for i in range(4):
        jl, jst = JR.decode_step(jp, jst, jnp.asarray(toks[:, i]), jcfg)
        tl, tst = TR.decode_step(tp, tst, torch.from_numpy(toks[:, i]),
                                 tcfg)
        close(tl, jl)
        for got, want in zip(tst, jst):
            close(got, want)


# --------------------------------------------------------------------------
# the port's own serving-path checks (tests/test_models.py:66-104)
# --------------------------------------------------------------------------

def test_prefill_decode_parity_transformer():
    """prefill(tokens) then decode_step must agree with full forward."""
    cfg = TC.get_reduced("smollm_135m")
    api = TREG.build(cfg, device="cpu")
    model = api.init(torch.Generator().manual_seed(2))
    toks = TREG.make_batch(cfg, 2, 12, torch.Generator().manual_seed(3),
                           "cpu")["tokens"]
    full = api.forward(model, {"tokens": toks})
    logits_p, st = api.prefill(model, {"tokens": toks[:, :11]}, 16)
    close(logits_p, full[:, 10].numpy(), 2e-3)
    logits_d, st = api.decode_step(model, st, toks[:, 11])
    close(logits_d, full[:, 11].numpy(), 2e-3)
    assert st.pos == 12


def test_decode_matches_forward_rwkv():
    """Step-by-step decode must reproduce the full forward's logits."""
    cfg = TC.get_reduced("rwkv6_1_6b")
    api = TREG.build(cfg, device="cpu")
    model = api.init(torch.Generator().manual_seed(4))
    batch = TREG.make_batch(cfg, 1, 6, torch.Generator().manual_seed(5),
                            "cpu")
    full = api.forward(model, batch)
    st = api.decode_init(model, batch, 0)
    outs = []
    for t in range(6):
        lg, st = api.decode_step(model, st, batch["tokens"][:, t])
        outs.append(lg)
    close(torch.stack(outs, 1), full.numpy(), 1e-3)
    assert np.isfinite(float(api.loss(model, batch)))
