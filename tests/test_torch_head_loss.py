"""PyTorch port, the head and its f32 loss on the training path
(``models/common.py::head_loss``, ``kernels/head_loss``): the fused
route's plain version against the composition it replaces, the head over
every position then ``cross_entropy(logits[:, P:][:, :-1], tokens[:, 1:],
mask)``, on the CPU.  No JAX.

Tolerances.  In f32 the loss and the gradients of the head's input, the
head and the embedding are bit for bit the composition's: the plain
version repeats its ops, and each product sums over the same terms (the
pad columns add exact zeros).  The final norm's scale (and bias) sum their
gradient over the positions, which are now only the loss's rows, so they
are held within 4 f32 ulps of the leaf's largest entry.  In bf16 the loss
is bit for bit too, and a gradient within 1e-2 of its leaf's largest entry
(between two and three bf16 ulps: a product that drops the zero rows may
round its bf16 output another way).
"""
import dataclasses

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import configs as TC
from repro_torch.kernels.head_loss import ops as HO
from repro_torch.kernels.head_loss.kernel import loss_rows
from repro_torch.models import registry as TREG
from repro_torch.models import rglru as TG
from repro_torch.models import rwkv6 as TR
from repro_torch.models import transformer as TT
from repro_torch.models import whisper as TW
from repro_torch.models.common import (cross_entropy, flat_params, head_loss,
                                       rms_norm)

B, S, D = 2, 12, 32
F32_ULPS = 4 * torch.finfo(torch.float32).eps
BF16_TOL = 1e-2


def _same(got, want, dtype, exact=True):
    """``got`` == ``want`` bit for bit (f32, ``exact``), else within the
    module's tolerance of ``want``'s largest entry."""
    if dtype == torch.float32 and exact:
        assert torch.equal(got, want)
        return
    tol = F32_ULPS if dtype == torch.float32 else BF16_TOL
    scale = want.float().abs().max().clamp(min=1e-30)
    assert ((got.float() - want.float()).abs().max() <= tol * scale), \
        ((got.float() - want.float()).abs().max(), scale)


# --------------------------------------------------------------------------
# a tiny LM: embedding (+ a prefix), final norm, head
# --------------------------------------------------------------------------

def tiny(dtype, v, tied, prefix, masked):
    g = torch.Generator().manual_seed(0)
    p = dict(embed=torch.randn(v, D, generator=g) * 0.5,
             ln=0.1 * torch.randn(D, generator=g))
    if not tied:
        p["head"] = torch.randn(D, v, generator=g) * 0.5
    if prefix:
        p["patches"] = torch.randn(B, prefix, D, generator=g)
    p = {k: t.to(dtype).requires_grad_() for k, t in p.items()}
    tokens = torch.randint(0, v, (B, S), generator=g)
    tokens[0, 3] = v - 1          # a label next to the pad columns
    tokens[1, -1] = v - 1
    mask = None
    if masked:
        mask = (torch.rand(B, S - 1, generator=g) > 0.3).float()
    return p, tokens, mask


def _hidden(p, tokens):
    x = p["embed"][tokens]
    if "patches" in p:
        x = torch.cat([p["patches"], x], dim=1)
    return torch.tanh(x)


def composed_loss(p, tokens, mask):
    """Today's composition: the head over every position, then the f32
    loss over the text positions but the last."""
    y = rms_norm(_hidden(p, tokens), p["ln"])
    w = p["embed"].T if "head" not in p else p["head"]
    logits = torch.einsum("bsd,dv->bsv", y, w)
    prefix = p["patches"].shape[1] if "patches" in p else 0
    return cross_entropy(logits[:, prefix:][:, :-1], tokens[:, 1:], mask)


def fused_loss(p, tokens, mask):
    w = p["embed"] if "head" not in p else p["head"].T
    prefix = p["patches"].shape[1] if "patches" in p else 0
    return head_loss(_hidden(p, tokens), lambda h: rms_norm(h, p["ln"]), w,
                     tokens, prefix=prefix, mask=mask)


def losses_and_grads(fn, p, tokens, mask):
    p = {k: t.detach().clone().requires_grad_() for k, t in p.items()}
    loss = fn(p, tokens, mask)
    loss.backward()
    return loss.detach(), {k: t.grad for k, t in p.items()}


def check_against_composition(p, tokens, mask, dtype):
    want, gw = losses_and_grads(composed_loss, p, tokens, mask)
    got, gg = losses_and_grads(fused_loss, p, tokens, mask)
    assert torch.isfinite(got)
    assert torch.equal(got, want), (got, want)
    for k in gw:
        _same(gg[k], gw[k], dtype, exact=k != "ln")


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("prefix", [0, 3])
@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("v", [509, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_fused_loss_matches_the_composition(dtype, v, tied, prefix, masked):
    p, tokens, mask = tiny(dtype, v, tied, prefix, masked)
    check_against_composition(p, tokens, mask, dtype)


@pytest.mark.parametrize("case", ["equal_logits", "magnitude_1e4"])
@pytest.mark.parametrize("v", [509, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_fused_loss_is_stable(dtype, v, case):
    """Rows of equal logits (a zero head: the loss is log V) and logits
    of magnitude 1e4 (the log-sum-exp's max taken out first)."""
    p, tokens, mask = tiny(dtype, v, False, 0, False)
    with torch.no_grad():
        if case == "equal_logits":
            p["head"].zero_()
        else:
            p["head"].mul_(1e4 / 4)
    check_against_composition(p, tokens, mask, dtype)
    loss, _ = losses_and_grads(fused_loss, p, tokens, mask)
    if case == "equal_logits":
        assert loss.item() == pytest.approx(torch.log(torch.tensor(
            float(v))).item(), rel=1e-6)
    else:
        assert torch.isfinite(loss) and loss.item() > 100.0


# --------------------------------------------------------------------------
# the loss kernel's plain version and the padding
# --------------------------------------------------------------------------

@pytest.mark.parametrize("write_grad", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_loss_rows_plain_version(dtype, write_grad):
    """nll is logsumexp − gold over the V logits; the buffer becomes
    (softmax − one-hot) · scale, pad columns 0 (only read without
    ``write_grad``)."""
    g = torch.Generator().manual_seed(3)
    n, v = 7, 100
    vp = HO.padded(v)
    assert vp == 128
    buf = (torch.randn(n, vp, generator=g) * 3).to(dtype)
    labels = torch.randint(0, v, (n,), generator=g)
    labels[0] = v - 1
    scale = torch.rand(n, generator=g)
    x = buf[:, :v].float().clone()
    before = buf.clone()
    nll = loss_rows(buf, v, labels, scale, write_grad=write_grad)
    want = torch.logsumexp(x, -1) - x[torch.arange(n), labels]
    assert torch.equal(nll, want)
    if not write_grad:
        assert torch.equal(buf, before)
        return
    grad = torch.softmax(x, -1)
    grad[torch.arange(n), labels] -= 1
    grad *= scale[:, None]
    _same(buf[:, :v], grad.to(dtype), dtype, exact=False)
    assert torch.all(buf[:, v:] == 0)
    # each row of softmax − one-hot sums to 0
    assert buf.float().sum(-1).abs().max() < (
        1e-5 if dtype == torch.float32 else 2e-2)


def test_loss_rows_refuses_what_the_kernel_does_not_take():
    buf = torch.zeros(4, 100)
    labels = torch.zeros(4, dtype=torch.int64)
    scale = torch.ones(4)
    with pytest.raises(ValueError, match="multiple of 64"):
        loss_rows(buf, 100, labels, scale)
    buf = torch.zeros(4, 128)
    with pytest.raises(ValueError, match="int64"):
        loss_rows(buf, 100, labels.int(), scale)
    with pytest.raises(ValueError, match="float32"):
        loss_rows(buf, 100, labels, scale.double())
    with pytest.raises(ValueError, match="multiple of 64"):
        loss_rows(buf, 129, labels, scale)


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("v", [509, 512, 64])
def test_pad_vocab_keeps_the_layout(v, transposed):
    """A copy with zero rows up to the next multiple of 64 in the head's
    own layout, or the head itself when V is one; the padding follows
    from V alone."""
    w = torch.randn(D, v).T if transposed else torch.randn(v, D)
    wp = HO.pad_vocab(w)
    assert wp.shape == (HO.padded(v), D) and wp.shape[0] % 64 == 0
    assert (wp.stride(0) == 1) == transposed
    assert torch.equal(wp[:v], w) and torch.all(wp[v:] == 0)
    assert (wp.data_ptr() == w.data_ptr()) == (v % 64 == 0)


def _write_flags(monkeypatch):
    """The ``write_grad`` of every loss kernel call, in order."""
    seen = []

    def spy(buf, v, labels, scale, *, write_grad=True):
        seen.append(write_grad)
        return loss_rows(buf, v, labels, scale, write_grad=write_grad)
    monkeypatch.setattr(HO, "loss_rows", spy)
    return seen


def test_no_gradient_wanted_reads_the_buffer_only(monkeypatch):
    """Under ``no_grad`` (an eval loss) the op gives the same loss, keeps
    nothing for a backward and has the kernel only read the logits,
    though the weights require a gradient; with grad mode on it writes."""
    p, tokens, mask = tiny(torch.float32, 509, True, 0, False)
    want = composed_loss(p, tokens, mask).detach()
    seen = _write_flags(monkeypatch)
    with torch.no_grad():
        got = fused_loss(p, tokens, mask)
    assert not got.requires_grad
    assert torch.equal(got, want)
    assert seen == [False]
    assert torch.equal(fused_loss(p, tokens, mask).detach(), want)
    assert seen == [False, True]


@pytest.mark.parametrize("name", ["internvl2_1b", "whisper_medium"])
def test_inference_mode_loss_only_reads(monkeypatch, name):
    """A serving cell's eval loss (``api.loss`` under ``inference_mode``,
    trainable weights) has the kernel read the logits without writing
    their gradient, and gives the training loss's value."""
    cfg = TC.get_reduced(name)
    api = TREG.build(cfg, device="cpu")
    batch = TREG.make_batch(cfg, B, S, torch.Generator().manual_seed(1),
                            "cpu")
    model = api.init(torch.Generator().manual_seed(0))
    want = api.loss(model, batch).detach()
    seen = _write_flags(monkeypatch)
    with torch.inference_mode():
        got = api.loss(model, batch)
    assert seen == [False]
    assert torch.equal(got, want)


def test_fake_tensors_trace_the_products_only():
    """The dry-run planner's fake tensors: the head's product and its two
    backward products are traced, no kernel or plain version runs."""
    with FakeTensorMode():
        h = torch.empty((30, D), requires_grad=True)
        w = torch.empty((509, D), requires_grad=True)
        labels = torch.zeros(30, dtype=torch.int64)
        loss = HO.head_loss(h, w, labels)
        loss.backward()
        assert h.grad.shape == h.shape and w.grad.shape == w.shape


# --------------------------------------------------------------------------
# every family's training loss
# --------------------------------------------------------------------------

FAMILIES = ["smollm_135m", "qwen2_moe_a2_7b", "internvl2_1b", "rwkv6_1_6b",
            "recurrentgemma_2b", "whisper_medium"]
MODULES = {"dense": TT, "moe": TT, "vlm": TT, "ssm": TR, "hybrid": TG,
           "audio": TW}


def composed_api_loss(cfg, model, batch):
    """The families' training loss before the fused head: ``_forward``'s
    logits over every position, then ``cross_entropy``."""
    tokens = batch["tokens"]
    mod = MODULES[cfg.family]
    if mod is TW:
        logits = TW._forward(model, batch["frames"], tokens, cfg)
    elif mod is TT:
        pe = batch.get("patches")
        logits = TT._forward(model, tokens, cfg, prefix_embed=pe)
        if pe is not None:
            logits = logits[:, pe.shape[1]:]
    else:
        logits = mod._forward(model, tokens, cfg)
    return cross_entropy(logits[:, :-1], tokens[:, 1:])


@pytest.mark.parametrize("dtype,vocab", [(torch.float32, 512),
                                         (torch.float32, 509),
                                         (torch.bfloat16, 509)],
                         ids=["f32-512", "f32-509", "bf16-509"])
@pytest.mark.parametrize("name", FAMILIES)
def test_family_loss_matches_the_composition(name, dtype, vocab):
    """``api.loss`` (each family's ``lm_loss``, whisper's ``loss``)
    gives the composition's loss bit for bit and its gradients, every
    leaf."""
    cfg = dataclasses.replace(TC.get_reduced(name), dtype=dtype,
                              vocab=vocab)
    api = TREG.build(cfg, device="cpu")
    batch = TREG.make_batch(cfg, B, S, torch.Generator().manual_seed(1),
                            "cpu")
    out = []
    for fn in (lambda m: composed_api_loss(cfg, m, batch),
               lambda m: api.loss(m, batch)):
        model = api.init(torch.Generator().manual_seed(0))
        loss = fn(model)
        loss.backward()
        out.append((loss.detach(),
                    [p.grad for p in flat_params(api.param_tree(model))]))
    (want, gw), (got, gg) = out
    assert torch.equal(got, want), (got, want)
    assert len(gw) == len(gg)
    for a, b in zip(gg, gw):
        assert (a is None) == (b is None)
        if b is not None:
            _same(a, b, dtype, exact=False)
