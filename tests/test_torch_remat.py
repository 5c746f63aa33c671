"""PyTorch port, the training forwards' rematerialisation: every family
checkpoints its layers as the reference's ``jax.checkpoint`` does
(``repro/models/transformer.py:109``, ``rwkv6.py:277``, ``whisper.py:130``
and ``:157``, ``rglru.py:221``).

For each family, on a reduced f32 config at batch 2:

* **the saves**: what autograd keeps for ``loss.backward()``, read through
  ``torch.autograd.graph.saved_tensors_hooks``.  A layer (Griffin: a
  super-block) keeps only its checkpoint's tensor inputs, exactly: x
  [B, S, D] (RWKV6, Griffin); x and the positions [B, S] (dense, MoE,
  VLM); an encoder layer's x [B, T, D], and a decoder layer's x [B, S, D]
  and the encoder's output [B, T, D] (whisper).  So a model of 2L layers
  saves exactly those L times more than one of L layers, and holds
  exactly L more layer inputs in memory: what every layer shares (the
  positions, whisper's encoder output) is one storage however many
  layers save it.  With ``checkpoint`` replaced by a direct call (in
  ``models/common.py::remat_layers``, which every family's training
  forward loops its layers through), each layer keeps its internals.
* **the values**: the loss and every gradient leaf with the
  rematerialisation equal those with ``checkpoint`` replaced by a direct
  call, bit for bit, and each layer's forward runs twice a step (once in
  the backward), against once.

The reference's side is held at 1e-4 in tests/test_torch_train_grad.py.
"""
import collections
import dataclasses

import pytest
import torch

from repro_torch import configs as TC
from repro_torch.models import common as TCOM
from repro_torch.models import registry as TREG
from repro_torch.models import rglru as TG
from repro_torch.models import rwkv6 as TR
from repro_torch.models import transformer as TT
from repro_torch.models import whisper as TW

B, S = 2, 12

# case: (config, overrides, the model module, its layer functions, the
# layers of one unit of depth, the fewest saves a unit keeps without the
# rematerialisation); qwen at a capacity factor that drops pairs,
# recurrentgemma with window 6
CASES = {
    "smollm_135m": ("smollm_135m", {}, TT, ("_layer_fwd",), 1, 30),
    "qwen2_moe_a2_7b-drop": ("qwen2_moe_a2_7b", {"capacity_factor": 0.5},
                             TT, ("_layer_fwd",), 1, 50),
    "internvl2_1b": ("internvl2_1b", {}, TT, ("_layer_fwd",), 1, 30),
    "rwkv6_1_6b": ("rwkv6_1_6b", {}, TR, ("_layer_seq",), 1, 50),
    "whisper_medium": ("whisper_medium", {}, TW,
                       ("_enc_layer", "_dec_layer"), 1, 50),
    "recurrentgemma_2b": ("recurrentgemma_2b", {"window": 6}, TG,
                          ("_super_block",), 3, 50),
}


def config(case, units):
    """The case's reduced f32 config at ``units`` units of depth (a
    whisper unit is an encoder and a decoder layer; a Griffin unit a
    super-block of three layers)."""
    name, over, _, _, per_unit, _ = CASES[case]
    cfg = dataclasses.replace(TC.get_reduced(name), **over,
                              n_layers=units * per_unit)
    if cfg.family == "audio":
        cfg = dataclasses.replace(cfg, n_enc_layers=units)
    if cfg.family == "hybrid":
        assert TG.n_super(cfg) == units and TG.n_tail(cfg) == 0
    return cfg


def model_and_batch(cfg):
    api = TREG.build(cfg, device="cpu")
    model = api.init(torch.Generator().manual_seed(0))
    batch = TREG.make_batch(cfg, B, S, torch.Generator().manual_seed(1),
                            "cpu")
    return api, model, batch


def direct_calls(monkeypatch):
    """``checkpoint`` in ``remat_layers`` replaced by a direct call."""
    monkeypatch.setattr(TCOM, "checkpoint", lambda fn, *a, **kw: fn(*a))


def kept_tensors(cfg):
    """The tensors autograd keeps for ``loss.backward()``, as (shape,
    storage) pairs (outside a rematerialised region, whose own hooks take
    its saves)."""
    api, model, batch = model_and_batch(cfg)
    saved = []

    def pack(t):
        saved.append((tuple(t.shape), t.untyped_storage().data_ptr()))
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = api.loss(model, batch)
    loss.backward()
    return saved


def by_storage(saves):
    """The kept tensors' shapes, one per storage (its first save's)."""
    first = {}
    for shape, ptr in saves:
        first.setdefault(ptr, shape)
    return collections.Counter(first.values())


def unit_saves(cfg):
    """What one unit of depth saves for the backward under the
    rematerialisation (shape: count), and the storages it adds."""
    d = cfg.d_model
    if cfg.family == "audio":
        enc, dec = (B, cfg.n_frames, d), (B, S, d)
        # the encoder layer's x; the decoder layer's x and enc_out
        return {enc: 2, dec: 1}, {enc: 1, dec: 1}
    rows = S + (cfg.n_patches if cfg.family == "vlm" else 0)
    x = (B, rows, d)
    if cfg.family in ("ssm", "hybrid"):
        return {x: 1}, {x: 1}
    return {x: 1, (B, rows): 1}, {x: 1}


@pytest.mark.parametrize("case", list(CASES))
def test_a_layer_keeps_only_its_input(case, monkeypatch):
    saves, storages = unit_saves(config(case, 1))
    units = (1, 2)
    kept = {}
    for remat in (True, False):
        if not remat:
            direct_calls(monkeypatch)
        for n in units:
            kept[remat, n] = kept_tensors(config(case, n))
    lo, hi = units
    # L more layers: exactly L more of each checkpoint input saved ...
    extra = collections.Counter(shape for shape, _ in kept[True, hi])
    extra.subtract(shape for shape, _ in kept[True, lo])
    assert +extra == {k: (hi - lo) * v for k, v in saves.items()}
    assert len(kept[True, hi]) - len(kept[True, lo]) == (
        (hi - lo) * sum(saves.values()))
    # ... and L more layer inputs in memory: what the layers share
    # (positions, the encoder's output) is one storage
    grown = by_storage(kept[True, hi])
    grown.subtract(by_storage(kept[True, lo]))
    assert +grown == {k: (hi - lo) * v for k, v in storages.items()}
    # without the rematerialisation each layer keeps its internals
    floor = CASES[case][-1]
    assert len(kept[False, hi]) - len(kept[False, lo]) > (hi - lo) * floor
    assert len(kept[False, lo]) > len(kept[True, lo])


def counted(monkeypatch, mod, names):
    """Count the calls of ``mod``'s layer functions."""
    calls = []
    for name in names:
        fn = getattr(mod, name)

        def wrapped(*args, fn=fn):
            calls.append(1)
            return fn(*args)
        monkeypatch.setattr(mod, name, wrapped)
    return calls


def loss_and_grads(cfg):
    api, model, batch = model_and_batch(cfg)
    loss = api.loss(model, batch)
    loss.backward()
    return loss.detach(), [p.grad for p in model.parameters()]


@pytest.mark.parametrize("case", list(CASES))
def test_rematerialised_gradients_are_bit_for_bit(case, monkeypatch):
    _, _, mod, names, _, _ = CASES[case]
    cfg = config(case, 2)
    layers = 2 * len(names)     # calls of the layer functions in a forward
    out = {}
    for remat in (True, False):
        with monkeypatch.context() as m:
            if not remat:
                direct_calls(m)
            calls = counted(m, mod, names)
            out[remat] = loss_and_grads(cfg)
            # under the remat each layer's forward runs again in the
            # backward
            assert len(calls) == layers * (2 if remat else 1)
    (loss, grads), (loss0, grads0) = out[True], out[False]
    assert torch.equal(loss, loss0)
    assert len(grads) == len(grads0) > 0
    for g, g0 in zip(grads, grads0):
        assert (g is None) == (g0 is None)
        if g is not None:
            assert g.dtype == torch.float32
            assert torch.equal(g, g0)
