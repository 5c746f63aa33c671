"""PyTorch port, Whisper (the audio family) against the JAX reference on the
CPU at reduced whisper-medium: ``encode``, ``decode_train``, ``loss``,
``init_decode`` (the precomputed cross K/V) and ``decode_step`` over
several steps, and the registry's entries.

The reference's own init (``jax.random.PRNGKey(0)``, ``max_pos`` 64) is
carried across with ``params_from_numpy``; the same numpy-seeded frames
and tokens go through both.  Tolerance 1e-4 (absolute and relative) in
f32, as in test_torch_models.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import registry as JREG
from repro.models import whisper as JW
from repro_torch import configs as TC
from repro_torch.models import registry as TREG
from repro_torch.models import whisper as TW

TOL = 1e-4
MAX_POS = 64


def close(got, want, tol=TOL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.fixture(scope="module")
def carried():
    jcfg, tcfg = JC.get_reduced("whisper_medium"), TC.get_reduced(
        "whisper_medium")
    jp = JW.init_whisper(jax.random.PRNGKey(0), jcfg, max_pos=MAX_POS)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jcfg, jp, tcfg, TW.params_from_numpy(tree, tcfg, "cpu")


def inputs(seed, cfg, b=2, s=10):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((b, cfg.n_frames, cfg.d_model)).astype(
        np.float32)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    return frames, toks


def test_sinusoid_matches_the_reference():
    close(TW._sinusoid(37, 16), JW._sinusoid(37, 16), 1e-6)


def test_encode_decode_train_and_loss_match_the_reference(carried):
    jcfg, jp, tcfg, tp = carried
    frames, toks = inputs(1, jcfg)
    jenc = JW.encode(jp, jnp.asarray(frames), jcfg)
    tenc = TW.encode(tp, torch.from_numpy(frames), tcfg)
    close(tenc, jenc)
    close(TW.decode_train(tp, torch.from_numpy(toks), tenc, tcfg),
          JW.decode_train(jp, jnp.asarray(toks), jenc, jcfg))
    close(TW.loss(tp, torch.from_numpy(frames), torch.from_numpy(toks),
                  tcfg),
          JW.loss(jp, jnp.asarray(frames), jnp.asarray(toks), jcfg))


def test_init_decode_and_decode_steps_match_the_reference(carried):
    jcfg, jp, tcfg, tp = carried
    frames, toks = inputs(2, jcfg, s=6)
    jst = JW.init_decode(jp, jnp.asarray(frames), jcfg, 8)
    tst = TW.init_decode(tp, torch.from_numpy(frames), tcfg, 8)
    close(tst.cross_k, jst.cross_k)
    close(tst.cross_v, jst.cross_v)
    assert tst.self_cache.k.shape == jst.self_cache.k.shape
    for i in range(toks.shape[1]):
        jl, jst = JW.decode_step(jp, jst, jnp.asarray(toks[:, i]), jcfg)
        tl, tst = TW.decode_step(tp, tst, torch.from_numpy(toks[:, i]), tcfg)
        close(tl, jl)
        close(tst.self_cache.k, jst.self_cache.k)
        close(tst.self_cache.v, jst.self_cache.v)
        assert tst.pos == int(jst.pos) == i + 1


def test_decode_steps_reproduce_decode_train(carried):
    """Step-by-step decode over the precomputed cross K/V gives the full
    decoder's logits (the chip check's consistency cell)."""
    jcfg, jp, tcfg, tp = carried
    frames, toks = inputs(3, jcfg, s=7)
    f, t = torch.from_numpy(frames), torch.from_numpy(toks)
    full = TW.forward(tp, f, t, tcfg)
    st = TW.init_decode(tp, f, tcfg, 8)
    outs = []
    for i in range(t.shape[1]):
        lg, st = TW.decode_step(tp, st, t[:, i], tcfg)
        outs.append(lg)
    close(torch.stack(outs, 1), full.numpy(), 1e-3)


def test_registry_entries_match_the_reference(carried):
    jcfg, jp, tcfg, tp = carried
    frames, toks = inputs(4, jcfg, s=5)
    japi, tapi = JREG.build(jcfg), TREG.build(tcfg, device="cpu")
    assert tapi.prefill is None and japi.prefill is None
    jb = {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}
    tb = {"tokens": torch.from_numpy(toks), "frames": torch.from_numpy(frames)}
    close(tapi.loss(tp, tb), japi.loss(jp, jb))
    jst = japi.decode_init(jp, jb, 8)
    tst = tapi.decode_init(tp, tb, 8)
    jl, _ = japi.decode_step(jp, jst, jnp.asarray(toks[:, 0]))
    tl, _ = tapi.decode_step(tp, tst, torch.from_numpy(toks[:, 0]))
    close(tl, jl)


def test_port_init_has_the_reference_shapes(carried):
    """The port's own init gives every weight the reference's shape and
    dtype (the registry's max_pos, 33,024, for the decoder positions)."""
    jcfg, jp, tcfg, tp = carried
    model = TW.init_whisper(torch.Generator().manual_seed(0), tcfg,
                            max_pos=MAX_POS, device="cpu")
    got = {k: (tuple(v.shape), v.dtype) for k, v in model.named_parameters()}
    want = {k: (tuple(v.shape), v.dtype) for k, v in tp.named_parameters()}
    assert got == want
    close(model.enc_pos, tp.enc_pos, 1e-6)
    api = TREG.build(tcfg, device="cpu")
    assert api.init(torch.Generator().manual_seed(0)).dec_pos.shape == (
        33_024, tcfg.d_model)
    batch = TREG.make_batch(tcfg, 3, 5, torch.Generator().manual_seed(1),
                            "cpu")
    assert batch["frames"].shape == (3, tcfg.n_frames, tcfg.d_model)
    assert batch["frames"].dtype == torch.float32
