"""PyTorch port, Qwen1.5-MoE-A2.7B as published (``configs/
qwen1_5_moe_a2_7b.py``) at a reduced size on the CPU: d 64, 4 heads of 16
with q/k/v biases, 8 routed experts of width 32 shared by ``ep_size`` 4
ranks (2 held), top-2, a gated shared expert of width 96, 2 layers, f32.

Held to the benchmark's plain reference (``portbench/reference/moe.py``),
which imports nothing of the program: the logits, the loss and every
leaf's gradient, on seeded random weights (every leaf drawn, biases and
norm gains included).  Tolerances: 2e-5 relative to each tensor's largest
magnitude for the logits and the loss, 1e-4 for each gradient leaf.  Both
sides are float32 on the CPU and route the same pairs; they differ only in
the order of their sums (einsum against matmul, a grouped product against
a product per expert, the rotary embedding's and the norm's arrangement),
a few float32 ulps a product, and the backward doubles the depth of such
sums.

Besides: the un-normalised top-k, the shared expert's gate and the biases
each change the result; dropless routing equals the capacity path where
nothing drops; the four ranks' partial outputs, with the shared expert
counted once, add up to the uncut layer (and to the reference's); the
remat's second pass routes bit for bit as the first, and the step's
gradients equal those without the remat bit for bit; the counters; the
MoE spans under a profiler, and none without one; decode through the
cache with the biases agrees with the full forward; the registry's
published entry.
"""
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench.reference import moe as RM
from portbench.reference.common import Products
from portbench.weights import tree_leaves
from repro_torch import configs as TC
from repro_torch.launch.train import make_train_step
from repro_torch.models import common as TCOM
from repro_torch.models import moe as M
from repro_torch.models import registry as TREG
from repro_torch.models.common import flat_params
from repro_torch.obs import spans as S
from repro_torch.optim import adamw

B, SEQ = 2, 16
SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=32,
             vocab=256, n_experts=8, top_k=2, shared_expert_ff=96,
             dtype=torch.float32, ep_size=4, ep_rank=0)


def small(**over):
    return dataclasses.replace(TC.get("qwen1.5-moe-a2.7b"),
                               **dict(SMALL, **over))


def ref_model(cfg) -> dict:
    """The reference's sizes for ``cfg``."""
    return dict(n_layers=cfg.n_layers, d_model=cfg.d_model,
                n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.hd, vocab=cfg.vocab, norm_eps=cfg.norm_eps,
                rope_theta=cfg.rope_theta, n_experts=cfg.n_experts,
                top_k=cfg.top_k, moe_d_ff=cfg.d_ff,
                shared_d_ff=cfg.shared_expert_ff,
                norm_topk_prob=cfg.norm_topk_prob, ep_size=cfg.ep_size,
                ep_rank=cfg.ep_rank)


def build(cfg, seed=0):
    """The program's API and model, every leaf drawn from ``seed`` (norm
    gains and biases too, so that none is trivially 0)."""
    api = TREG.build(cfg, device="cpu")
    model = api.init(torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for path, parts in tree_leaves(api.param_tree(model)):
            for p in parts:
                if p.ndim == 1 or ".b" in path \
                        or "shared_expert_gate" in path:
                    p.copy_(0.3 * torch.randn(p.shape, generator=gen))
    return api, model


def ref_weights(api, model) -> dict:
    """The program's weights as the reference takes them: {path: tensor
    or [tensor a layer]}, float32 leaves that require a gradient."""
    out = {}
    for path, parts in tree_leaves(api.param_tree(model)):
        ws = [p.detach().float().clone().requires_grad_(True) for p in parts]
        out[path] = ws if path.startswith("layers.") else ws[0]
    return out


def batch(cfg, seed=1):
    return TREG.make_batch(cfg, B, SEQ, torch.Generator().manual_seed(seed),
                           "cpu")


def close(got, want, rtol):
    scale = want.detach().abs().max().clamp(min=1e-30)
    err = (got.detach() - want.detach()).abs().max() / scale
    assert err <= rtol, (float(err), rtol)


VARIANTS = {"published": {}, "norm_topk_prob": {"norm_topk_prob": True},
            "ep_rank_3": {"ep_rank": 3}, "one_rank": {"ep_size": 1}}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_program_matches_the_reference(variant):
    cfg = small(**VARIANTS[variant])
    api, model = build(cfg)
    bt = batch(cfg)
    m = ref_model(cfg)
    w = ref_weights(api, model)
    close(api.forward(model, bt),
          RM.logits(w, bt["tokens"], m, Products()), 2e-5)
    loss = api.loss(model, bt)
    loss.backward()
    nll, count = RM.loss_sums(w, bt, m, Products())
    ref_loss = nll / count
    ref_loss.backward()
    close(loss, ref_loss, 2e-5)
    for path, parts in tree_leaves(api.param_tree(model)):
        want = w[path] if isinstance(w[path], list) else [w[path]]
        for p, r in zip(parts, want):
            assert p.grad is not None and r.grad is not None, path
            close(p.grad, r.grad, 1e-4)


@pytest.mark.parametrize("what", ["norm_topk_prob", "shared_expert_gate",
                                  "biases"])
def test_each_published_option_changes_the_result(what):
    """The un-normalised top-k, the shared expert's gate and the q/k/v
    biases each take part: turning one off (the same other weights)
    moves the loss, and the reference agrees with the program both ways
    for the top-k."""
    cfg = small()
    api, model = build(cfg)
    bt = batch(cfg)
    base = float(api.loss(model, bt).detach())
    if what == "norm_topk_prob":
        cfg2 = small(norm_topk_prob=True)
        api2 = TREG.build(cfg2, device="cpu")
        other = float(api2.loss(model, bt).detach())
        w = ref_weights(api, model)
        nll, count = RM.loss_sums(w, bt, ref_model(cfg2), Products())
        assert abs(other - float(nll / count)) <= 2e-5 * abs(other)
    else:
        with torch.no_grad():
            for lp in model.layers:
                if what == "biases":
                    for b in (lp.attn.bq, lp.attn.bk, lp.attn.bv):
                        b.zero_()
                else:
                    # sigmoid(0) = 1/2 for every token: the gate's input
                    # no longer matters
                    lp.moe.shared_expert_gate.zero_()
        other = float(api.loss(model, bt).detach())
    assert abs(other - base) > 1e-4, (base, other)


def test_dropless_equals_the_capacity_path_where_nothing_drops():
    cfg = small(ep_size=1)
    api, model = build(cfg)
    bt = batch(cfg)
    cap = dataclasses.replace(cfg, moe_dropless=False,
                              capacity_factor=cfg.n_experts / cfg.top_k)
    assert M.capacity(cap, B * SEQ) == B * SEQ
    x = torch.randn((B, SEQ, cfg.d_model), generator=torch.Generator()
                    .manual_seed(5))
    for lp in model.layers:
        with M.counting():
            want = M.moe_ffn(lp.moe, x, cap)
            got = M.moe_ffn(lp.moe, x, cfg)
        close(got, want, 1e-6)
        assert M.read_counters([lp.moe])[0]["dropped"] == 0
    close(TREG.build(cap, device="cpu").loss(model, bt),
          api.loss(model, bt), 1e-6)


def test_the_capacity_path_routes_through_route(monkeypatch):
    """The capacity path takes its gates, experts and queue positions from
    ``moe.route``, once a layer's forward, which a wrapper of it (such as
    chip_smoke's drop count) sees; the dropless path does not queue."""
    cfg = dataclasses.replace(small(ep_size=1), moe_dropless=False,
                              capacity_factor=0.5)
    api, model = build(cfg)
    seen = []
    real = M.route

    def counted(params, xt, c):
        out = real(params, xt, c)
        seen.append(out[2].numel())
        return out
    monkeypatch.setattr(M, "route", counted)
    api.loss(model, batch(cfg))
    assert seen == [B * SEQ * cfg.top_k] * cfg.n_layers
    seen.clear()
    api, model = build(small())
    api.loss(model, batch(small()))
    assert seen == []


def rank_share(full: M.MoEParams, cfg, rank: int) -> M.MoEParams:
    """Rank ``rank``'s layer: the full layer's router and shared expert,
    and its slice of the routed experts."""
    e = cfg.n_experts // cfg.ep_size
    cut = slice(rank * e, (rank + 1) * e)
    return M.MoEParams(full.router.detach(), full.w_gate.detach()[cut],
                       full.w_up.detach()[cut], full.w_down.detach()[cut],
                       full.shared_gate.detach(), full.shared_up.detach(),
                       full.shared_down.detach(),
                       full.shared_expert_gate.detach())


def test_the_ranks_shares_add_up_to_the_whole_layer():
    """The share test: the four ranks' partial outputs, with the
    shared expert (which every rank computes alike) counted once, add up
    to the uncut layer's output, and to the reference's uncut layer."""
    whole = small(ep_size=1)
    api, model = build(whole)
    full = model.layers[0].moe
    x = torch.randn((B, SEQ, whole.d_model),
                    generator=torch.Generator().manual_seed(7))
    want = M.moe_ffn(full, x, whole).detach()
    parts = []
    with torch.no_grad():
        for r in range(4):
            cfg = dataclasses.replace(whole, ep_size=4, ep_rank=r)
            parts.append(M.moe_ffn(rank_share(full, cfg, r), x, cfg))
    # the shared expert's gated output, which every rank adds alike
    hs = x.reshape(-1, whole.d_model)
    shared = (torch.sigmoid(hs @ full.shared_expert_gate)
              * ((torch.nn.functional.silu(hs @ full.shared_gate)
                  * (hs @ full.shared_up)) @ full.shared_down)
              ).reshape(x.shape).detach()
    total = sum(p - shared for p in parts) + shared
    close(total, want, 1e-5)
    lw = {f"moe.{f}": getattr(full, f).detach()
          for f in M.MoEGatedTree._fields}
    ref = RM.sparse_block(lw, hs, ref_model(whole), Products())
    close(total, ref.reshape(x.shape), 1e-5)
    # a rank's part without the shared expert is not the whole
    assert (parts[0] - want).abs().max() > 1e-3


def test_remat_replay_routes_bit_for_bit(monkeypatch):
    cfg = small()
    api, model = build(cfg)
    bt = batch(cfg)
    plans = []
    real = M._dropless_plan

    def record(params, topi, c):
        plan = real(params, topi, c)
        held, rows, pos, ends = plan
        plans.append((held.clone(), rows.clone(), pos.clone(),
                      ends.clone()))
        return plan
    monkeypatch.setattr(M, "_dropless_plan", record)
    api.loss(model, bt).backward()
    grads = [p.grad.clone() for p in flat_params(api.param_tree(model))]
    # each layer routed twice: its forward, then its replay in the backward
    assert len(plans) == 2 * cfg.n_layers
    first, replay = plans[:cfg.n_layers], plans[cfg.n_layers:][::-1]
    for a, b in zip(first, replay):
        assert all(torch.equal(u, v) for u, v in zip(a, b))
    # without the remat the step's gradients are the same bits
    for p in flat_params(api.param_tree(model)):
        p.grad = None
    monkeypatch.setattr(TCOM, "checkpoint", lambda fn, *a, **kw: fn(*a))
    api.loss(model, bt).backward()
    for g, p in zip(grads, flat_params(api.param_tree(model))):
        assert torch.equal(g, p.grad)


def test_counters():
    cfg = small()
    api, model = build(cfg)
    bt = batch(cfg)
    # nothing is counted unless counting is on
    api.loss(model, bt).backward()
    assert M.read_counters([lp.moe for lp in model.layers]) == \
        [None] * cfg.n_layers
    with M.counting():
        api.loss(model, bt).backward()
    counts = M.read_counters([lp.moe for lp in model.layers])
    # the first layer's routing, worked out again from its input
    x = model.embed.detach()[bt["tokens"]]
    lp = model.layers[0]
    h = TCOM.rms_norm(x + M_attention(lp, x, cfg), lp.ln_mlp, cfg.norm_eps)
    _, topi = M.top_k(lp.moe, h.reshape(-1, cfg.d_model), cfg)
    e = cfg.n_experts // cfg.ep_size
    lo = cfg.ep_rank * e
    per = torch.stack([(topi == lo + i).sum() for i in range(e)])
    c = counts[0]
    assert (c["kept"], c["largest"], c["dropped"]) == (
        int(per.sum()), int(per.max()), 0)
    # one count a forward, none for the remat's replay
    assert c["calls"] == 1 and c["sums"]["kept"] == c["kept"]
    assert 0 < c["kept"] < B * SEQ * cfg.top_k     # a share, not all
    # the capacity path counts what it drops
    drop = dataclasses.replace(small(ep_size=1), moe_dropless=False,
                               capacity_factor=0.5)
    api2, model2 = build(drop)
    # under a profiler alone the capacity path counts nothing
    with profile(activities=[ProfilerActivity.CPU]):
        api2.loss(model2, bt)
    assert M.read_counters([model2.layers[0].moe]) == [None]
    with M.counting():
        api2.loss(model2, bt)
    c2 = M.read_counters([model2.layers[0].moe])[0]
    cap = M.capacity(drop, B * SEQ)
    assert c2["largest"] <= cap
    assert c2["kept"] + c2["dropped"] == B * SEQ * drop.top_k
    assert c2["dropped"] > 0


def M_attention(lp, x, cfg):
    from repro_torch.models import attention as A
    h = TCOM.rms_norm(x, lp.ln_attn, cfg.norm_eps)
    return A.attention_train(lp.attn, h, cfg, causal=True)


MOE_SPANS = (S.MOE_ROUTE, S.MOE_EXPERTS, S.MOE_SHARED)


def test_spans_under_a_profiler_and_none_without():
    cfg = small()
    api, model = build(cfg)
    state = adamw.init(flat_params(api.param_tree(model)))
    step = make_train_step(api, adamw.AdamWConfig())
    bt = batch(cfg)
    M.take_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(model, state, bt)
    evs = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith(S.PREFIX)]
    names = [e[0] for e in evs]
    layers = [e for e in evs if e[0] == S.LAYER]
    replays = [e for e in evs if e[0] == S.REMAT_REPLAY]
    for n in MOE_SPANS:
        got = [e for e in evs if e[0] == n]
        # once in each layer's forward and once in its replay
        assert len(got) == 2 * cfg.n_layers, (n, names)
        for e in got:
            assert any(o[1] <= e[1] and e[2] <= o[2]
                       for o in layers + replays), n
    back = [e for e in evs if e[0] == S.MOE_EXPERTS_BACKWARD]
    bw = next(e for e in evs if e[0] == S.BACKWARD)
    assert len(back) == cfg.n_layers
    assert all(bw[1] <= e[1] and e[2] <= bw[2] for e in back)
    # each layer's counts of the profiled forward (not its replay) are
    # kept for the traced run's readers, once
    last = M.read_counters([lp.moe for lp in model.layers])
    taken = M.take_counts()
    assert taken == [[c["kept"], c["largest"], c["dropped"]] for c in last]
    assert M.take_counts() == []
    # without a profiler: no range at all, the same shared no-op
    assert not S.enabled() and S.span(S.MOE_ROUTE) is S.span(S.MOE_SHARED)
    made = []
    real = torch._C._profiler._RecordFunctionFast
    try:
        torch._C._profiler._RecordFunctionFast = \
            lambda *a: made.append(a) or real(*a)
        step(model, state, bt)
    finally:
        torch._C._profiler._RecordFunctionFast = real
    assert made == []
    assert M.take_counts() == []


def test_decode_with_biases_matches_the_forward():
    cfg = small()
    api, model = build(cfg)
    bt = batch(cfg)
    full = api.forward(model, bt)
    logits, state = api.prefill(model, {"tokens": bt["tokens"][:, :-4]},
                                SEQ)
    close(logits, full[:, SEQ - 5], 1e-5)
    for i in range(SEQ - 4, SEQ):
        logits, state = api.decode_step(model, state, bt["tokens"][:, i])
        close(logits, full[:, i], 1e-5)


def test_the_tree_grows_the_new_leaves_only_when_present():
    paths = lambda cfg: [p for p, _ in tree_leaves(TREG.build(
        cfg, device="cpu").param_tree(build(cfg)[1]))]
    pub = paths(small())
    assert {"layers.attn.bq", "layers.attn.bk", "layers.attn.bv",
            "layers.moe.shared_expert_gate"} <= set(pub)
    base = paths(TC.get_reduced("qwen2_moe_a2_7b"))
    assert not any(p.endswith((".bq", ".bk", ".bv", "shared_expert_gate"))
                   for p in base)
    # the published leaves follow the reference's, in its order
    assert list(RM.expected_shapes(ref_model(small()))) == pub


def test_the_registry_gives_the_published_model():
    cfg = TC.get("qwen1.5-moe-a2.7b")
    assert TC.canon("qwen1.5-moe-a2.7b") == "qwen1_5_moe_a2_7b"
    assert "qwen1_5_moe_a2_7b" not in TC.ALL_ARCHS
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.hd, cfg.d_ff, cfg.vocab) == (
        "moe", 24, 2048, 16, 16, 128, 1408, 151936)
    assert (cfg.n_experts, cfg.top_k, cfg.n_shared_experts,
            cfg.shared_expert_ff) == (60, 4, 1, 5632)
    assert (cfg.rope_theta, cfg.norm_eps, cfg.tie_embeddings) == (
        1e6, 1e-6, False)
    assert cfg.qkv_bias and cfg.shared_expert_gate and cfg.moe_dropless
    assert not cfg.norm_topk_prob and not cfg.moe_router_f32
    rank = dataclasses.replace(cfg, n_layers=12, ep_size=4, ep_rank=0)
    assert rank.held_experts == 15
    # the structure at the cell's size, on no device
    model = TREG.build(rank, device="meta").init(None)
    moe = model.layers[0].moe
    assert tuple(moe.w_gate.shape) == (15, 2048, 1408)
    assert tuple(moe.router.shape) == (2048, 60)
    assert moe.router.dtype == torch.bfloat16
    assert tuple(model.layers[0].attn.bq.shape) == (16, 128)
    with pytest.raises(ValueError):
        dataclasses.replace(cfg, ep_size=7).held_experts


def test_a_train_step_through_the_normal_path():
    cfg = small()
    api, model = build(cfg)
    state = adamw.init(flat_params(api.param_tree(model)))
    step = make_train_step(api, adamw.AdamWConfig(lr=1e-2, warmup_steps=1))
    bt = batch(cfg)
    losses = []
    for _ in range(3):
        model, state, met = step(model, state, bt)
        losses.append(float(met["loss"]))
    assert all(torch.isfinite(torch.tensor(losses)))
    assert losses[-1] < losses[0]
