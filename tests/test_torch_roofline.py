"""PyTorch port of the planner (``roofline/analyze.py``,
``roofline/report.py``, ``launch/dryrun.py``) against the reference on
the CPU.

``collective_bytes`` on HLO text from the reference (a compiled
``shard_map`` with an all-reduce, an all-gather and a reduce-scatter, and
the async and tuple forms XLA prints) gives the reference's dict; so do
``roofline`` and ``model_flops`` on equal inputs, ``count_params`` on
every config's full-size tree (``meta`` against ``eval_shape``),
``probe_cfg``, ``pad_heads_cfg``, ``_rwkv_time_corrected`` (at the
reference's layout) and ``report.py``'s markdown on a fixed directory of
cell JSONs.  ``lower_cell`` skips ``long_500k`` on a full-attention arch
with the reference's reason, and counts smollm-135m's ``train_4k`` on the
single production mesh: one rank's FLOPs are the analytic count of its
program exactly, 6·N·S for the matmul weights, 2·N'·S more for those a
layer's rematerialisation runs again (N': every layer weight but w_down),
and 22·S²·hd·H·L for the plain attention (the forward's 2 products and
its lse's Q·Kᵀ, twice under the remat; the backward's 5), so
``useful_ratio`` is 6·N·tokens / (256 × that) = 0.3199 (within 1%;
0.4162 before the layers were rematerialised), and its collective bytes
are the weights' gather and the gradient's all-reduce, counted from the
shapes.  Exact equality elsewhere: the functions are arithmetic on equal
inputs.
"""
import contextlib
import dataclasses
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS, get as jget
from repro.launch import shapes as JS
from repro.models.registry import build as jbuild
from repro.roofline import analyze as JAN
from repro.roofline import report as JRP
from repro_torch.configs import get
from repro_torch.launch import dryrun as TD
from repro_torch.launch import mesh as TM
from repro_torch.launch import shapes as shp
from repro_torch.models import registry
from repro_torch.roofline import analyze as TAN
from repro_torch.roofline import report as TRP


@pytest.fixture(scope="module")
def jdry():
    """The reference's ``launch/dryrun.py``.  It sets ``XLA_FLAGS`` (512
    host devices) when imported: JAX's backend is made first, so this
    process keeps its devices, and the variable is put back for the
    processes other tests start."""
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return dryrun


def reference_hlo() -> str:
    """A compiled reference program with three collectives, plus the async
    (start/done) and tuple forms XLA prints on a mesh."""
    from jax.sharding import Mesh, PartitionSpec as P
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))

    def f(x, y):
        return (jax.lax.psum(x, "model"),
                jax.lax.all_gather(y, "data", tiled=True),
                jax.lax.psum_scatter(y.astype(jnp.float32), "model",
                                     tiled=True))
    g = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(P("data", "model"),
                                                     P("data")),
                              out_specs=(P("data", "model"), P(),
                                         P("data", "model")),
                              check_vma=False))
    text = g.lower(jnp.ones((8, 16)), jnp.ones((8, 4), jnp.bfloat16)
                   ).compile().as_text()
    return text + """
  %all-gather-start.1 = (bf16[64,576]{1,0}, bf16[1024,576]{1,0}) all-gather-start(bf16[64,576]{1,0} %p), channel_id=2, replica_groups=[16,16]<=[256], dimensions={0}
  %all-gather-done.1 = bf16[1024,576]{1,0} all-gather-done((bf16[64,576]{1,0}, bf16[1024,576]{1,0}) %all-gather-start.1)
  %all-reduce-start.2 = f32[4096]{0} all-reduce-start(f32[4096]{0} %g), channel_id=3, replica_groups={{0,1,2,3}}, to_apply=%add
  %all-reduce-done.2 = f32[4096]{0} all-reduce-done(f32[4096]{0} %all-reduce-start.2)
  %all-to-all.2 = (s32[8,16]{1,0}, s32[8,16]{1,0}) all-to-all(s32[8,16]{1,0} %a, s32[8,16]{1,0} %b), channel_id=4
  %collective-permute.1 = u8[4096]{0} collective-permute(u8[4096]{0} %q), channel_id=5, source_target_pairs={{0,1},{1,0}}
  %fusion.3 = f32[10]{0} fusion(f32[10]{0} %y), kind=kLoop, calls=%fused
"""


def test_collective_bytes_matches_the_reference():
    text = reference_hlo()
    got = TAN.collective_bytes(text)
    assert got == JAN.collective_bytes(text)
    assert all(got["counts"][k] for k in TAN.COLLECTIVES[:5])
    for dtype, dims in (("bf16", "64,576"), ("pred", ""), ("f8e4m3fn", "3")):
        assert TAN._shape_bytes(dtype, dims) == JAN._shape_bytes(dtype, dims)


def test_roofline_and_model_flops_match_the_reference():
    for f, b, c in ((1e15, 2e12, 3e10), (5e12, 9e13, 0.0), (0.0, 1.0, 7e9)):
        kw = dict(peak=2e14, hbm=1e12, ici=5e10)
        assert TAN.roofline(f, b, c, **kw) == JAN.roofline(f, b, c, **kw)
        assert TAN.roofline(f, b, c) == JAN.roofline(
            f, b, c, peak=989e12, hbm=3.35e12, ici=450e9)
    assert (TAN.PEAK_FLOPS_BF16, TAN.HBM_BW, TAN.LINK_BW) == \
        (TM.BF16_TENSOR_OPS_S, TM.HBM_BYTES_S, TM.NVLINK_BYTES_S) == \
        (989e12, 3.35e12, 450e9)
    for n, t, train in ((1.35e8, 1 << 20, True), (8e9, 4096, False)):
        assert TAN.model_flops(n, t, train) == JAN.model_flops(n, t, train)


@pytest.mark.parametrize("name", ALL_ARCHS)
def test_count_probe_and_pad_heads_match_the_reference(jdry, name):
    cfg, jcfg = get(name), jget(name)
    tp = shp.params_specs(registry.build(cfg, device="meta"))
    assert TD.count_params(tp, cfg) == jdry.count_params(
        JS.params_specs(jbuild(jcfg)), jcfg)
    fields = lambda c: {k: v for k, v in dataclasses.asdict(c).items()
                        if k != "dtype"}
    for k in (1, 2):
        (c, units), (jc, junits) = TD.probe_cfg(cfg, k), \
            jdry.probe_cfg(jcfg, k)
        assert fields(c) == fields(jc) and units == junits
    assert fields(TD.pad_heads_cfg(cfg)) == fields(jdry.pad_heads_cfg(jcfg))


def test_rwkv_time_corrected_matches_the_reference(jdry):
    est = dict(flops=1.25e15, bytes_accessed=3.5e13, coll=7.0e9)
    for chunk in (0, 16):
        cfg = dataclasses.replace(get("rwkv6_1_6b"), rwkv_chunk=chunk)
        jcfg = dataclasses.replace(jget("rwkv6_1_6b"), rwkv_chunk=chunk)
        for shape_name in ("train_4k", "prefill_32k"):
            for multi in (False, True):
                assert TD._rwkv_time_corrected(
                    cfg, shp.SHAPES[shape_name], multi, None, "naive",
                    dict(est)) == jdry._rwkv_time_corrected(
                    jcfg, JS.SHAPES[shape_name], multi, None, "naive",
                    dict(est))
    assert TD.ARCH_NAMES == jdry.ARCH_NAMES


def _cell(arch, shape, mesh, dominant, status="ok"):
    rl = dict(compute_s=1.5e-3, memory_s=2.25e-3, collective_s=4e-4,
              dominant=dominant, bound_s=2.25e-3,
              roofline_fraction=0.6666)
    return dict(status=status, arch=arch, shape=shape, mesh=mesh,
                roofline=rl, useful_ratio=0.41616,
                scan_compile=dict(compile_s=12.4, memory=dict(
                    argument_size_in_bytes=3 << 30,
                    temp_size_in_bytes=None),
                    collective_counts={"all-gather": 1, "all-reduce": 1}),
                error="boom " * 20)


def test_report_markdown_matches_the_reference(tmp_path):
    cells = {
        "smollm_135m__train_4k__single": _cell("smollm-135m", "train_4k",
                                                "single", "memory_s"),
        "smollm_135m__decode_32k__single": _cell(
            "smollm-135m", "decode_32k", "single", "collective_s"),
        "granite_3_8b__prefill_32k__single": _cell(
            "granite-3-8b", "prefill_32k", "single", "compute_s"),
        "granite_3_8b__long_500k__single": dict(status="skipped",
                                                reason="sub-quadratic"),
        "rwkv6_1_6b__train_4k__single": _cell("rwkv6-1.6b", "train_4k",
                                               "single", "memory_s",
                                               status="error"),
        "smollm_135m__train_4k__multi": _cell("smollm-135m", "train_4k",
                                               "multi", "memory_s"),
    }
    for tag, d in cells.items():
        (tmp_path / f"{tag}.json").write_text(json.dumps(d))
    outs = []
    for mod in (TRP, JRP):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.main(str(tmp_path))
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and "| smollm-135m | train_4k |" in outs[0]


def test_lower_cell_skips_long_500k_on_full_attention(tmp_path):
    for name in ALL_ARCHS:
        if get(name).subquadratic:
            continue
        want = dict(status="skipped",
                    reason=JS.cell_supported(jget(name),
                                             JS.SHAPES["long_500k"])[1])
        assert TD.lower_cell(name.replace("_", "-"), "long_500k",
                             False) == want
    TD.main(["--arch", "granite-3-8b", "--shape", "long_500k", "--mesh",
             "both", "--out", str(tmp_path)])
    assert sorted(os.listdir(tmp_path)) == [
        "granite_3_8b__long_500k__multi.json",
        "granite_3_8b__long_500k__single.json"]


def test_analyze_program_counts_a_matmul():
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        x = torch.empty((64, 32), dtype=torch.bfloat16)
        w = torch.empty((32, 16), dtype=torch.bfloat16)
        info = TAN.analyze_program(lambda a, b: a @ b, x, w)
    assert info["flops"] == 2 * 64 * 32 * 16
    assert info["bytes_accessed"] == 2 * (64 * 32 + 32 * 16 + 64 * 16)
    assert info["collectives"]["total"] == 0
    assert info["memory"]["argument_size_in_bytes"] == 2 * (64 * 32 + 32 * 16)


def test_smollm_train_4k_single_cell_counts_its_program():
    cfg = get("smollm_135m")
    d = TD.lower_cell("smollm-135m", "train_4k", False)
    assert d["status"] == "ok" and d["n_chips"] == 256
    s, hd, h, layers = 4096, cfg.hd, cfg.n_heads, cfg.n_layers
    n_total = d["params_total"]
    n_norm = cfg.d_model * (2 * layers + 1)
    # the products each layer's recompute runs again (its checkpoint, the
    # reference's jax.checkpoint): wq, wk, wv, wo, w_gate and w_up; the
    # recompute stops once the last tensor the backward keeps (w_down's
    # input) is back, so w_down's product is not rerun
    d_m, kv, ff = cfg.d_model, cfg.n_kv_heads, cfg.d_ff
    n_rerun = layers * (2 * d_m * h * hd + 2 * d_m * kv * hd + 2 * d_m * ff)
    # one rank: 1 of the 256 rows, every weight gathered whole; the tied
    # head (V a multiple of 64: no pad) over the S − 1 positions that
    # carry a loss; the attention a layer: the forward's Q·Kᵀ and P·V and
    # its lse's Q·Kᵀ (6·S²·hd a head), twice under the remat, and the
    # plain backward's five products (10·S²·hd)
    assert cfg.vocab % 64 == 0
    flops = (6 * (n_total - n_norm) * s - 6 * cfg.vocab * d_m
             + 2 * n_rerun * s + 22 * s * s * hd * h * layers)
    assert d["flops"] == pytest.approx(flops, rel=1e-9)
    assert d["tokens"] == 256 * s
    assert d["model_flops"] == 6 * n_total * 256 * s
    want = 6 * n_total * 256 * s / (256 * flops)
    assert abs(want - 0.3199) < 1e-4
    assert d["useful_ratio"] == pytest.approx(want, rel=0.01)
    # the gather: every sharded weight's 16 blocks (bf16, each padded to
    # 4 bytes); the all-reduce: every gradient and the loss in f32
    api = registry.build(cfg, device="meta")
    from repro_torch.models.common import flat_params
    from repro_torch.parallel import sharding as sh
    tree = api.param_tree(api.init(None))
    mesh = TM.make_production_mesh()
    gather = sum(16 * (-(-(p.numel() // 16 * 2) // 4) * 4)
                 for p, spec in zip(flat_params(tree),
                                    sh.flat_pspecs(tree, mesh))
                 if any(e is not None for e in spec))
    assert d["collective_bytes"] == 4 * (n_total + 1) + gather
    assert d["roofline"]["dominant"] in ("compute_s", "memory_s")
