"""Mixture-of-Experts FFN with capacity-bounded token dispatch.  The port of
:mod:`repro.models.moe`.

Tokens are routed top-k by an f32 router, each expert processes a fixed
capacity ``cap`` of tokens (a (token, choice) pair whose place in its
expert's queue is ``cap`` or later is dropped), and the expert products
batch over the expert dimension (``torch.bmm``: plain batched matrix
products, which the reference leaves to XLA outside any kernel).  Two
places where PyTorch's defaults differ from JAX's:

* the top k come from a stable descending sort, so equal gates pick the
  lower expert index first, as ``jax.lax.top_k`` does (``torch.topk``
  promises no order);
* the combine gathers each kept (token, choice)'s expert output and adds
  a token's k contributions in choice order, where the reference
  scatter-adds: ``index_add_`` on CUDA adds with atomics, in no fixed
  order, so its bf16 sums would change from run to run.

A training step rematerialises each layer (:mod:`repro_torch.models.
transformer`), so the routing runs twice on the same input, and the
backward's second pass must route every pair as the forward did.  It
does: the router's product and softmax are the same ops on the same
values, the top k come from the stable sort, the queue positions from a
cumsum over the pairs in token-major order, the dispatch writes each kept
pair to its own (expert, slot) (only the dropped pairs share a column,
which is cut off), and the combine gathers; nothing accumulates in an
order that can change between the two passes.

The port's own options (:class:`repro_torch.models.common.PortArchConfig`;
each default is the reference's behaviour), which a published model such
as Qwen1.5-MoE-A2.7B needs:

* ``ep_size`` / ``ep_rank``: the layer holds the experts
  ``[rank·E/ep, (rank+1)·E/ep)`` of one expert-parallel rank.  It routes
  every token over all E and computes only its own experts' part of the
  result (plus the shared expert, which every rank computes alike); it
  adds nothing for the absent ranks or their exchange.
* ``moe_dropless``: no capacity and no dropped pair.  The kept (token,
  choice) pairs are sorted stably by expert (token-major within an
  expert), each expert's run of rows goes through the grouped products
  (:mod:`repro_torch.kernels.moe_gmm`: gate and up, SiLU·up, down), and
  the combine gathers each token's pairs and adds them in choice order
  with their gates.  The dispatch's sizes are the upper bound n·k rows;
  the groups' ends stay on the device, so nothing syncs with the host and
  the remat's second pass routes and sums bit for bit as the first.
* ``norm_topk_prob`` False: the top-k gates are the softmax's own.
* ``shared_expert_gate``: the shared expert's output times
  ``sigmoid(x · w_sg)``, ``w_sg`` [D, 1].
* ``moe_router_f32`` False: the router's weight in the model's dtype, its
  logits rounded to it, the softmax in f32 (a published ``gate`` Linear).

Spans (:mod:`repro_torch.obs.spans`): ``rt/moe/route``, ``rt/moe/experts``,
``rt/moe/shared`` in each layer's forward, and ``rt/backward/moe_experts``
over the routed experts' backward.  Counters, kept on the device while
:func:`counting` is on (or, on the dropless path, while a profiler runs,
for a traced run's readers), and read by
:func:`read_counters` (by layer) or :func:`take_counts` (every record, in
order): each layer's pairs kept on its experts, its largest expert's
pairs, and the pairs dropped (0 when dropless).  Otherwise a forward
counts nothing and launches nothing for it.
"""
from __future__ import annotations

import contextlib
import weakref
from collections import deque, namedtuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.moe_gmm.ops import grouped_mm
from repro_torch.models.common import ArchConfig, dense_init, param
from repro_torch.obs import spans

#: The weights in the reference's order: router [D, E] (f32); w_gate,
#: w_up [E, D, F]; w_down [E, F, D]; shared_gate, shared_up [D, Fs] and
#: shared_down [Fs, D], or None without shared experts.  E is the experts
#: this rank holds.
FIELDS = ("router", "w_gate", "w_up", "w_down", "shared_gate", "shared_up",
          "shared_down")
#: The reference's ``MoEParams`` node.
MoETree = namedtuple("MoEParams", FIELDS)
#: The node with the shared expert's gate ``shared_expert_gate`` [D, 1]
#: (``cfg.shared_expert_gate``), which the reference has not.
MoEGatedTree = namedtuple("MoEParams", FIELDS + ("shared_expert_gate",))


class MoEParams(nn.Module):
    def __init__(self, router, w_gate, w_up, w_down, shared_gate=None,
                 shared_up=None, shared_down=None, shared_expert_gate=None):
        super().__init__()
        for name, t in zip(MoEGatedTree._fields,
                           (router, w_gate, w_up, w_down, shared_gate,
                            shared_up, shared_down, shared_expert_gate)):
            setattr(self, name, None if t is None else param(t))


def tree_class(params: MoEParams):
    """:data:`MoEGatedTree` for a layer with the shared expert's gate,
    else :data:`MoETree`."""
    return MoETree if params.shared_expert_gate is None else MoEGatedTree


def padded_experts(cfg: ArchConfig) -> int:
    """Expert-array size: padded to a multiple of 16 when the EP knob is on
    (padded experts receive no tokens — the router stays at n_experts);
    with ``ep_size`` > 1 the experts this rank holds."""
    if cfg.ep_size > 1:
        return cfg.held_experts
    if cfg.moe_pad_experts:
        return -(-cfg.n_experts // 16) * 16
    return cfg.n_experts


def init_moe(gen: torch.Generator, cfg: ArchConfig, dtype=None,
             device=None) -> MoEParams:
    dtype = dtype or cfg.dtype
    d, e, f = cfg.d_model, padded_experts(cfg), cfg.d_ff
    fs = cfg.shared_expert_ff or (cfg.n_shared_experts * f)
    init = lambda shape, in_axis, dt=dtype: dense_init(
        gen, shape, in_axis=in_axis, dtype=dt, device=device)
    shared = cfg.n_shared_experts > 0
    gated = shared and cfg.shared_expert_gate
    return MoEParams(
        router=init((d, cfg.n_experts), 0,
                    torch.float32 if cfg.moe_router_f32 else dtype),
        w_gate=init((e, d, f), 1), w_up=init((e, d, f), 1),
        w_down=init((e, f, d), 1),
        shared_gate=init((d, fs), 0) if shared else None,
        shared_up=init((d, fs), 0) if shared else None,
        shared_down=init((fs, d), 0) if shared else None,
        shared_expert_gate=init((d, 1), 0) if gated else None)


def capacity(cfg: ArchConfig, n: int) -> int:
    """Slots per expert for ``n`` tokens (the reference's formula)."""
    return max(1, int(cfg.capacity_factor * n * cfg.top_k / cfg.n_experts))


def top_k(params: MoEParams, xt: torch.Tensor, cfg: ArchConfig):
    """xt [n, D] -> (gate weights [n, k] f32, experts [n, k]) over all
    ``n_experts``: the router's logits (in f32, or rounded to the model's
    dtype when the router is held in it), the softmax in f32, the top k
    from a stable descending sort, renormalised to sum 1 unless
    ``norm_topk_prob`` is False."""
    k = cfg.top_k
    if cfg.moe_router_f32:
        logits = xt.float() @ params.router
    else:
        logits = (xt @ params.router).float()
    gates = torch.softmax(logits, dim=-1)
    topv, topi = torch.sort(gates, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :k], topi[:, :k]
    if cfg.norm_topk_prob:
        topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    return topv, topi


def route(params: MoEParams, xt: torch.Tensor, cfg: ArchConfig):
    """xt [n, D] -> (gate weights [n, k] f32, experts [n, k], queue
    positions [n, k]): each (token, choice)'s place in its expert's queue,
    counted over the n·k pairs in token-major order."""
    topv, topi = top_k(params, xt, cfg)
    onehot = F.one_hot(topi.reshape(-1), padded_experts(cfg))   # [n·k, e]
    pos = onehot.cumsum(0).gather(1, topi.reshape(-1, 1)) - 1
    return topv, topi, pos.reshape(topi.shape)


def moe_ffn(params: MoEParams, x: torch.Tensor,
            cfg: ArchConfig) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D]: the routed experts this rank holds, then
    the shared expert.  Top-k routing with capacity dropping, or dropless
    with ``cfg.moe_dropless``."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    dropless = cfg.moe_dropless
    if cfg.ep_size > 1 and not dropless:
        raise ValueError("an expert-parallel share needs moe_dropless")
    with spans.span(spans.MOE_ROUTE):
        if dropless:
            topv, topi = top_k(params, xt, cfg)
            plan = _dropless_plan(params, topi, cfg)
        else:
            topv, topi, pos = route(params, xt, cfg)
            plan = _capacity_plan(params, topi, pos, cfg)
    with spans.span(spans.MOE_EXPERTS):
        out = (_dropless_experts if dropless else _capacity_experts)(
            params, xt, topv, topi, plan)
    if params.shared_gate is not None:
        with spans.span(spans.MOE_SHARED):
            hs = xt @ params.shared_gate
            us = xt @ params.shared_up
            ys = (F.silu(hs) * us) @ params.shared_down
            if params.shared_expert_gate is not None:
                ys = torch.sigmoid(xt @ params.shared_expert_gate) * ys
            out = out + ys
    return out.reshape(b, s, d).to(x.dtype)


def _capacity_plan(params: MoEParams, topi: torch.Tensor, pos: torch.Tensor,
                   cfg: ArchConfig):
    """(queue positions, kept [n, k], capacity): each expert takes its
    first ``capacity`` pairs in token-major order (``pos``, from
    :func:`route`) and drops the rest."""
    cap = capacity(cfg, topi.shape[0])
    keep = pos < cap
    if _counted(profiled=False):
        flat = topi.reshape(-1)
        load = torch.zeros(padded_experts(cfg), dtype=flat.dtype,
                           device=flat.device).scatter_add_(
            0, flat, torch.ones_like(flat)).clamp(max=cap)
        _count(params, load.sum(), load.max(), (~keep).sum())
    return pos, keep, cap


def _capacity_experts(params: MoEParams, xt, topv, topi, plan):
    """The routed experts' part, [n, D], at capacity (``torch.bmm`` over
    every expert)."""
    pos, keep, cap = plan
    n, d = xt.shape
    e, k = params.w_gate.shape[0], topi.shape[1]
    # dispatch: slot (e, p) holds token id + 1 (0 = empty); dropped pairs
    # land in column cap, which is cut off
    flat_e = topi.reshape(-1)
    flat_pos = torch.where(keep, pos, cap).reshape(-1)
    token_id = torch.arange(n, device=xt.device).repeat_interleave(k)
    slots = torch.zeros((e, cap + 1), dtype=torch.int64, device=xt.device)
    slots[flat_e, flat_pos] = token_id + 1
    slots = slots[:, :cap]
    occupied = slots > 0
    xe = xt[torch.clamp(slots - 1, min=0)] * occupied[..., None]  # [e,cap,d]

    h = torch.bmm(xe, params.w_gate)
    u = torch.bmm(xe, params.w_up)
    y = torch.bmm(F.silu(h) * u, params.w_down)                 # [e,cap,d]

    # combine: each kept pair's output times its gate, a token's k pairs
    # added in choice order (dropped pairs add a zero)
    gate = torch.where(keep, topv, 0.0).to(y.dtype)             # [n, k]
    picked = y[topi, torch.clamp(pos, max=cap - 1)]             # [n,k,d]
    return _combine(picked, gate)


def _combine(picked: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """picked [n, k, D] times gate [n, k], a token's k added in choice
    order."""
    contrib = picked * gate[..., None]
    out = contrib[:, 0]
    for j in range(1, contrib.shape[1]):
        out = out + contrib[:, j]
    return out


class _Dispatch(torch.autograd.Function):
    """xt [n, D] -> its rows ``xt[rows]`` in the sorted pairs' order; the
    backward adds each token's k rows of the gradient in choice order
    (``pos`` [n, k]: each pair's sorted row), by gathers: no atomics, so
    its sums are the same bits every time."""

    @staticmethod
    def forward(ctx, xt, rows, pos):
        ctx.save_for_backward(pos)
        return xt.index_select(0, rows)

    @staticmethod
    def backward(ctx, g):
        pos, = ctx.saved_tensors
        out = g.index_select(0, pos[:, 0])
        for j in range(1, pos.shape[1]):
            out = out + g.index_select(0, pos[:, j])
        return out, None, None


def _dropless_plan(params: MoEParams, topi: torch.Tensor, cfg: ArchConfig):
    """(held [n, k], each sorted row's token [n·k], each pair's sorted row
    [n, k], the groups): the n·k pairs (token-major) get the key of their
    held expert, or E_h past the held ones; a stable sort by key puts each
    held expert's pairs in one run, in token order, and the rest after
    them.  The runs' ends come from the sorted keys on the device."""
    n, k = topi.shape
    e_h = padded_experts(cfg)
    lo = cfg.ep_rank * e_h
    held = (topi >= lo) & (topi < lo + e_h)
    key = torch.where(held, topi - lo, e_h).reshape(-1)
    sorted_key, order = torch.sort(key, stable=True)
    pos = torch.empty_like(order).scatter_(
        0, order, torch.arange(n * k, device=topi.device))
    ends = torch.searchsorted(sorted_key, torch.arange(e_h,
                                                       device=topi.device),
                              right=True, out_int32=True)
    if _counted():
        load = torch.diff(ends, prepend=ends.new_zeros(1))
        _count(params, ends[-1], load.max(), torch.zeros_like(ends[-1]))
    return held, order // k, pos.view(n, k), ends


def _dropless_experts(params: MoEParams, xt, topv, topi, plan):
    """The routed experts' part, [n, D], with no capacity: the sorted rows
    through the grouped products (rows past the last run are 0), then
    each token's k rows times their gates (0 for a pair on another rank's
    expert), added in choice order."""
    held, rows, pos, ends = plan
    n, d = xt.shape
    xr = xt.view_as(xt)         # the routed experts' own input
    spans.close_in_backward(xr, spans.MOE_EXPERTS_BACKWARD)
    xs = _Dispatch.apply(xr, rows, pos)                         # [n·k, D]
    h = grouped_mm(xs, params.w_gate, ends)
    u = grouped_mm(xs, params.w_up, ends)
    y = grouped_mm(F.silu(h) * u, params.w_down, ends)          # [n·k, D]
    gate = torch.where(held, topv, 0.0).to(y.dtype)             # [n, k]
    out = _combine(y.index_select(0, pos.reshape(-1)).view(n, -1, d), gate)
    spans.open_in_backward(out, spans.MOE_EXPERTS_BACKWARD)
    return out


# --------------------------------------------------------------------------
# counters
# --------------------------------------------------------------------------

#: The counted forwards, oldest first: (the layer's :class:`MoEParams`,
#: weakly, and its ``[kept, largest, dropped]`` on the device).  Bounded,
#: so that counting nobody reads grows nothing.
_RECORD: deque = deque(maxlen=4096)
_COUNTING = [0]


@contextlib.contextmanager
def counting():
    """Within the block, each MoE layer's forward records its counts (as
    a dropless layer's does while a profiler runs)."""
    _COUNTING[0] += 1
    try:
        yield
    finally:
        _COUNTING[0] -= 1


def _counted(profiled: bool = True) -> bool:
    """Whether this forward records its counts: counting is on (or, with
    ``profiled``, a profiler runs), and it is not the remat's second
    pass.  The capacity path (serving, the reference's configs) passes
    False, so that a profiled decode step launches only its own work."""
    return ((_COUNTING[0] > 0 or (profiled and spans.enabled()))
            and torch._C._current_graph_task_id() < 0)


def _count(params: MoEParams, kept, largest, dropped) -> None:
    """Record a layer's routing on the device: the pairs kept on this
    rank's experts, its largest expert's pairs, the pairs dropped.  No
    host read."""
    _RECORD.append((weakref.ref(params), torch.stack(
        [kept, largest, dropped]).detach().to(torch.int64)))


def read_counters(layers) -> list:
    """Each MoE layer's counters in the record, read back: ``kept``,
    ``largest`` and ``dropped`` of its last counted forward, their sums
    and the forwards counted (``calls``); None for a layer with none.
    ``layers`` holds the layers' :class:`MoEParams`."""
    out = []
    for p in layers:
        mine = [c for ref, c in _RECORD if ref() is p]
        if not mine:
            out.append(None)
            continue
        last = mine[-1].tolist()
        sums = torch.stack(mine).sum(0).tolist()
        out.append(dict(zip(("kept", "largest", "dropped"), last),
                        sums=dict(zip(("kept", "largest", "dropped"), sums)),
                        calls=len(mine)))
    return out


def take_counts() -> list:
    """``[[kept, largest, dropped]]`` of every counted forward since the
    record was last taken, oldest first (a step's layers in order), read
    back at once; the record is then emptied."""
    if not _RECORD:
        return []
    out = torch.stack([c for _, c in _RECORD]).cpu().tolist()
    _RECORD.clear()
    return out


def aux_load_balance_loss(x: torch.Tensor, params: MoEParams,
                          cfg: ArchConfig) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss."""
    n = x.shape[0] * x.shape[1]
    logits = x.reshape(n, -1).float() @ params.router
    gates = torch.softmax(logits, dim=-1)
    top1 = torch.argmax(gates, dim=-1)
    frac = F.one_hot(top1, cfg.n_experts).float().mean(0)
    prob = gates.mean(0)
    return cfg.n_experts * torch.sum(frac * prob)


def layer_from_numpy(tree, i: int, t) -> MoEParams:
    """Layer ``i`` of the reference's stacked ``MoEParams`` (numpy leaves,
    ``None`` for absent shared experts), each leaf through ``t``."""
    return MoEParams(*(None if getattr(tree, f) is None else
                       t(getattr(tree, f)[i]) for f in FIELDS))
