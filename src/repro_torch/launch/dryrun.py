"""Dry-run planner: count one rank's program for every (arch × shape × mesh)
cell on the production mesh, on the host.  The port of
:mod:`repro.launch.dryrun`.

The reference lowers and compiles each cell on 512 placeholder devices.
Here a cell's program is one rank's, under the sharded train step's layout
(:func:`repro_torch.launch.train.shard_train_fns`) on
:func:`~repro_torch.launch.mesh.make_production_mesh`: the rank holds its
blocks of the weights (and of the AdamW moments), gathers them whole over
its ``model`` row, and computes its rows of the batch; training then sums
the gradients over the mesh and updates the rank's blocks.  The program
runs on fake tensors (``FakeTensorMode``: shapes only, nothing allocated,
on the CPU route: attention is its plain, naive version) and
:func:`repro_torch.roofline.analyze.analyze_program` counts its FLOPs,
bytes and collective bytes.

The reference's probe algebra is kept: small probes of 1 and 2
layer-units, cost(L) = a + b·L extrapolated to the real depth (exact for
homogeneous stacks).  RWKV's recurrence is not traced on fake tensors
(a Python loop over time in its plain version), so its known body is
added as the reference adds it (``_rwkv_time_corrected``), here for the
rank's rows and all heads.

Programs per shape: train_4k -> the sharded train step (gather, forward,
backward, gradient all-reduce, AdamW); prefill_32k -> the gather and
``api.prefill`` (``api.loss`` for the recurrent families); decode_* ->
the gather and ``api.decode_step`` (one token against a seq-len state).
One JSON a cell under ``--out`` (an incremental cache), in the
reference's layout, so :mod:`repro_torch.roofline.report` reads either
package's output.  The rates are the H100's (host figures: nothing runs on
a device).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --mesh both --out /tmp/dryrun [--force]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch import configs as cfglib
from repro_torch.checkpoint.manager import tree_flatten
from repro_torch.launch import shapes as shp
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.train import ShardedStep, rank_rows
from repro_torch.models import registry
from repro_torch.models.common import Layers
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as sh
from repro_torch.roofline import analyze


def count_params(params_spec, cfg) -> tuple[float, float]:
    """(total, active) parameter counts from the spec tree."""
    leaves = tree_flatten(params_spec)[0]
    total = sum(float(math.prod(l.shape)) for l in leaves)
    active = total
    if cfg.is_moe:
        names = tree_flatten(sh.name_tree(params_spec))[0]
        expert = sum(float(math.prod(l.shape))
                     for n, l in zip(names, leaves)
                     if ".moe.w_" in n)
        active = total - expert * (1 - cfg.top_k / cfg.n_experts)
    return total, active


def probe_cfg(cfg, k: int):
    """Config with k layer-units (see module docstring).

    Returns (cfg_k, units_real): linear extrapolation target is
    cost(units_real) from probes at units k=1,2.
    """
    if cfg.family == "hybrid":
        # unit = (rec, rec, attn) super-block; tail rec layers ≈ 1/3 super
        from repro_torch.models import rglru
        units_real = rglru.n_super(cfg) + rglru.n_tail(cfg) / 3.0
        return dataclasses.replace(cfg, n_layers=3 * k,
                                   unroll_layers=True), units_real
    if cfg.family == "audio":
        # unit = one encoder + one decoder layer (24/24 in whisper-medium)
        units_real = cfg.n_layers
        return dataclasses.replace(cfg, n_layers=k, n_enc_layers=k,
                                   unroll_layers=True), units_real
    return dataclasses.replace(cfg, n_layers=k,
                               unroll_layers=True), cfg.n_layers


def _program(cfg, shape, multi_pod, opt_cfg):
    """One rank's program for a config variant, on fake tensors (inside
    the caller's ``FakeTensorMode``): ``(fn, args, collectives)``."""
    api = registry.build(cfg, device="cpu")
    mesh = make_production_mesh(multi_pod=multi_pod)
    model = api.init(torch.Generator())
    comm = analyze.CountingCollectives(mesh)
    step = ShardedStep(api, mesh, model, opt_cfg or adamw.AdamWConfig(),
                       comm=comm)
    params = step.shard_params()
    fake = lambda spec: torch.empty(spec.shape, dtype=spec.dtype)
    if shape.kind == "train":
        batch = {k: fake(v) for k, v in shp.batch_specs(cfg, shape).items()}
        return step, (params, step.shard_opt(), batch), comm
    if shape.kind == "prefill":
        batch = {k: fake(v) for k, v in shp.batch_specs(cfg, shape).items()}

        def prefill_fn(params, batch):
            step.gather_params(params)
            rows = rank_rows(cfg, shape.batch, mesh)
            mine = {k: v[rows] for k, v in batch.items()}
            with torch.inference_mode():
                if api.prefill is not None:
                    return api.prefill(model, mine, shape.seq)
                return api.loss(model, mine)   # recurrent: the forward
        return prefill_fn, (params, batch), comm
    # decode: the rank's rows of the state and the tokens
    rows = rank_rows(cfg, shape.batch, mesh)
    n = rows.stop - rows.start
    state = shp.decode_state_specs(api, dataclasses.replace(shape, batch=n))
    state = tree_flatten(state)[1](iter([
        fake(x) if isinstance(x, torch.Tensor) else x
        for x in tree_flatten(state)[0]]))
    tok = fake(shp.token_spec(shape))

    def decode_fn(params, state, tok):
        step.gather_params(params)
        return api.decode_step(model, state, tok[rows])
    return decode_fn, (params, state, tok), comm


def _count(cfg, shape, multi_pod, opt_cfg) -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        fn, args, comm = _program(cfg, shape, multi_pod, opt_cfg)
        return analyze.analyze_program(fn, *args, collectives=comm)


def _probe_costs(cfg, shape, multi_pod, opt_cfg, attn):
    """1/2-unit probes -> per-unit costs, extrapolated."""
    out = {}
    for k in (1, 2):
        cfg_k, units_real = probe_cfg(
            dataclasses.replace(cfg, attn_impl=attn), k)
        out[k] = _count(cfg_k, shape, multi_pod, opt_cfg)
    b = {m: out[2][m] - out[1][m]
         for m in ("flops", "bytes_accessed")}
    b["coll"] = out[2]["collectives"]["total"] \
        - out[1]["collectives"]["total"]
    a = {m: out[1][m] - b[m] for m in ("flops", "bytes_accessed")}
    a["coll"] = out[1]["collectives"]["total"] - b["coll"]

    def extrap(units):
        return {m: max(a[m] + b[m] * units, 0.0)
                for m in ("flops", "bytes_accessed", "coll")}

    _, units_real = probe_cfg(cfg, 1)
    est = extrap(units_real)
    est["units_real"] = units_real
    est["per_unit"] = b
    est["fixed"] = a
    kinds = analyze.COLLECTIVES
    est["per_kind"] = {
        kd: max(2 * out[1]["collectives"]["per_kind"][kd]
                - out[2]["collectives"]["per_kind"][kd]
                + (out[2]["collectives"]["per_kind"][kd]
                   - out[1]["collectives"]["per_kind"][kd]) * units_real,
                0.0) for kd in kinds}
    est["counts"] = out[1]["collectives"]["counts"]
    return est


def _rwkv_time_corrected(cfg, shape, multi_pod, opt_cfg, attn, est,
                         b_dev=None, h_dev=None):
    """RWKV train/prefill: the WKV recurrence is added from its
    *structurally known* body — a weight-free elementwise state update
    with NO collectives — on top of the layer-probe extrapolation:

      per token/layer:  flops ≈ 5·B·H·N²  (kv outer + out + decay-update,
                        fwd; ×3 for bwd recompute+grads)
      bytes ≈ state r/w (2·B·H·N²·4 B, ÷chunk when chunked) + rkvw slices
      collectives: 0  (so the probe-extrapolated value stands)

    ``b_dev`` rows and ``h_dev`` heads a device; None: the reference's
    layout (batch over 16 data shards, heads over 16 model shards).
    """
    mesh_div = 16   # model-axis shards of the H dim
    if b_dev is None:
        b_dev = shape.batch // 16 if shape.batch >= 16 else shape.batch
    h = cfg.d_model // cfg.rwkv_head_dim
    if h_dev is None:
        h_dev = max(h // mesh_div, 1)
    n = cfg.rwkv_head_dim
    layers = cfg.n_layers
    mult = 3.0 if shape.kind == "train" else 1.0   # bwd recompute+grad
    body_flops = 5.0 * b_dev * h_dev * n * n * mult
    chunk = max(cfg.rwkv_chunk, 1)
    state_rw = 2.0 * b_dev * h_dev * n * n * 4.0 / chunk
    stream = 5.0 * b_dev * h_dev * n * 4.0
    body_bytes = (state_rw + stream) * mult
    s = shape.seq
    return dict(
        flops=est["flops"] + s * layers * body_flops,
        bytes_accessed=est["bytes_accessed"] + s * layers * body_bytes,
        coll=est["coll"],
    )


def pad_heads_cfg(cfg):
    """Deployment padding: q-heads up to a multiple of 16 (and kv heads up
    to a divisor of that) so attention shards over the model axis instead
    of being replicated.  head_dim is pinned so only the head count
    grows (a deployment superset of the assigned config)."""
    if cfg.n_heads == 0 or cfg.n_heads % 16 == 0:
        return cfg
    h = -(-cfg.n_heads // 16) * 16
    kv = max(cfg.n_kv_heads, 1)
    while h % kv:
        kv += 1
    return dataclasses.replace(cfg, n_heads=h, n_kv_heads=kv,
                               head_dim=cfg.hd)


def _state_bytes(params, mesh) -> int:
    """A rank's resident state under the layout: the whole weights (the
    gather's target), its blocks of them and of the two f32 moments."""
    leaves = [p for x in tree_flatten(params)[0]
              for p in (x.parts if isinstance(x, Layers) else [x])]
    specs = sh.flat_pspecs(params, mesh)
    whole = sum(p.numel() * p.element_size() for p in leaves)
    blocks = sum(math.prod(b.stop - b.start for b in
                           sh.block_slices(p.shape, s, mesh))
                 * (p.element_size() + 8) for p, s in zip(leaves, specs))
    return whole + blocks


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               opt_cfg=None, attn: str = "naive",
               moe_pad: bool = False, rwkv_chunk: int = 0,
               pad_heads: bool = False) -> dict:
    cfg = cfglib.get(arch)
    cfg = dataclasses.replace(cfg, attn_impl=attn, moe_pad_experts=moe_pad,
                              rwkv_chunk=rwkv_chunk)
    if pad_heads:
        cfg = pad_heads_cfg(cfg)
    shape = shp.SHAPES[shape_name]
    ok, why = shp.cell_supported(cfg, shape)
    if not ok:
        return dict(status="skipped", reason=why)

    # ---- 1. the full-depth model's shapes and the rank's state ----
    t0 = time.time()
    params_spec = shp.params_specs(registry.build(cfg, device="meta"))
    mesh = make_production_mesh(multi_pod=multi_pod)
    state_bytes = _state_bytes(params_spec, mesh)
    t_lower = time.time() - t0

    # ---- 2. probes of 1 and 2 units, counted ----
    t0 = time.time()
    est = _probe_costs(cfg, shape, multi_pod, opt_cfg, attn)
    t_count = time.time() - t0
    if cfg.family == "ssm" and shape.kind in ("train", "prefill"):
        rows = rank_rows(cfg, shape.batch, mesh)
        corrected = _rwkv_time_corrected(
            cfg, shape, multi_pod, opt_cfg, attn, est,
            b_dev=rows.stop - rows.start,
            h_dev=cfg.d_model // cfg.rwkv_head_dim)
        est.update(corrected)
        est["time_loop_corrected"] = True

    flops = est["flops"]
    bytes_accessed = est["bytes_accessed"]
    coll = est["coll"]
    rl = analyze.roofline(flops, bytes_accessed, coll)

    n_chips = mesh.size
    n_total, n_active = count_params(params_spec, cfg)
    training = shape.kind == "train"
    tokens = shape.batch * (shape.seq if shape.kind != "decode" else 1)
    mf = analyze.model_flops(n_active, tokens, training)
    hlo_global = flops * n_chips
    return dict(
        status="ok", arch=arch, shape=shape_name,
        mesh="multi" if multi_pod else "single", n_chips=n_chips,
        params_total=n_total, params_active=n_active,
        tokens=tokens, model_flops=mf, attn=attn,
        flops=flops, bytes_accessed=bytes_accessed,
        collective_bytes=coll, roofline=rl,
        useful_ratio=mf / hlo_global if hlo_global else 0.0,
        # the reference's compile record, for report.py: here the model's
        # build on meta (lower_s), the probes' counting (compile_s), the
        # rank's resident state (arguments, donated back as outputs), and
        # the collectives extrapolated to the full depth
        scan_compile=dict(
            lower_s=t_lower, compile_s=t_count,
            memory=dict(argument_size_in_bytes=state_bytes,
                        output_size_in_bytes=state_bytes,
                        temp_size_in_bytes=None, alias_size_in_bytes=None,
                        generated_code_size_in_bytes=None),
            raw_flops_scan_counted_once=None,
            collectives_per_kind=est["per_kind"],
            collective_counts=est["counts"]),
        probes=dict(per_unit=est["per_unit"], fixed=est["fixed"],
                    units_real=est["units_real"],
                    time_loop_corrected=est.get("time_loop_corrected",
                                                False)),
    )


ARCH_NAMES = [a.replace("_", "-") for a in cfglib.ALL_ARCHS]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--attn", default="naive", choices=["naive", "chunked"])
    ap.add_argument("--moe-pad", action="store_true")
    ap.add_argument("--rwkv-chunk", type=int, default=0)
    ap.add_argument("--pad-heads", action="store_true")
    args = ap.parse_args(argv)

    archs = ARCH_NAMES if args.arch == "all" else [args.arch]
    shapes = list(shp.SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)

    failures = 0
    t_all = time.time()
    for arch in archs:
        for shape_name in shapes:
            for multi in meshes:
                tag = f"{cfglib.canon(arch)}__{shape_name}__" \
                      f"{'multi' if multi else 'single'}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path) and not args.force:
                    print(f"[dryrun] cached {tag}")
                    continue
                print(f"[dryrun] {tag} ...", flush=True)
                try:
                    info = lower_cell(arch, shape_name, multi,
                                      attn=args.attn,
                                      moe_pad=args.moe_pad,
                                      rwkv_chunk=args.rwkv_chunk,
                                      pad_heads=args.pad_heads)
                except Exception as e:      # a cell's failure is its record
                    info = dict(status="error", error=str(e),
                                traceback=traceback.format_exc())
                    failures += 1
                    print(f"[dryrun] FAILED {tag}: {e}")
                with open(path, "w") as f:
                    json.dump(info, f, indent=2, default=str)
                if info.get("status") == "ok":
                    rl = info["roofline"]
                    print(f"[dryrun] {tag}: dominant={rl['dominant']} "
                          f"bound={rl['bound_s'] * 1e3:.2f}ms "
                          f"count={info['scan_compile']['compile_s']:.1f}s",
                          flush=True)
    print(f"[dryrun] host seconds {time.time() - t_all:.1f}")
    if failures:
        raise SystemExit(f"{failures} cells failed")
    print("[dryrun] all requested cells done")


if __name__ == "__main__":
    main()
