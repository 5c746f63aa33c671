"""The AdamW kernels' launch planning (``kernels/adamw/ops.py``) and the
optimizer's CPU route, on the CPU.

The planning is plain Python, so its promises are checked here: every
element of every leaf lies in exactly one block, the ragged rest of a leaf
only in its last chunk, a list longer than a table takes several
launches, a leaf's kind names its types and whether it is aligned, a
gradient that is not contiguous is copied, and what the kernels do not
take is refused.  The CPU route of ``optim/adamw.py`` runs the loop the
optimizer ran before the kernels, moved to ``kernels/adamw/ref.py``, bit for
bit, and no kernel.  The kernels themselves are held to that loop on the
card (``tests/test_torch_cuda.py``, marker ``cuda``).
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.adamw import kernel as K
from repro_torch.kernels.adamw import ops
from repro_torch.kernels.adamw.ref import global_norm_ref, update_ref
from repro_torch.optim import adamw


def blocks_of(launch, numels):
    """What each block of ``launch`` works on, found as the kernel finds
    it (the last leaf whose first chunk is at or before the block):
    ``[(leaf, start, length)]``."""
    out = []
    for b in range(launch.first[-1]):
        j = max(j for j in range(len(launch.leaves))
                if launch.first[j] <= b)
        i = launch.leaves[j]
        at = (b - launch.first[j]) * ops.CHUNK
        out.append((i, at, min(ops.CHUNK, numels[i] - at)))
    return out


NUMELS = {
    "small": [1, 7, 15, 1000, 8, 9],
    "chunk_edges": [ops.CHUNK - 1, ops.CHUNK, ops.CHUNK + 1,
                    3 * ops.CHUNK + 5],
    "with_empty": [0, 5, 0, 2 * ops.CHUNK, 0],
    "over_2e28": [2 ** 28 + 3, 1, 2048 * 33],
}


@pytest.mark.parametrize("case", list(NUMELS))
def test_plan_covers_every_element_once(case):
    numels = NUMELS[case]
    launches = ops.plan(numels)
    seen = {i: [] for i, n in enumerate(numels) if n}
    for launch in launches:
        for i, at, length in blocks_of(launch, numels):
            assert 0 < length <= ops.CHUNK
            seen[i].append((at, length))
    for i, spans in seen.items():
        spans.sort()
        ends = [0] + [at + length for at, length in spans]
        # the spans abut from 0 to the leaf's end: each element once
        assert [at for at, _ in spans] == ends[:-1]
        assert ends[-1] == numels[i]
        # every chunk but the last is whole, so 8-element vectors tile it;
        # the ragged rest is the last chunk's
        assert all(length == ops.CHUNK for _, length in spans[:-1])
        assert spans[-1][1] == numels[i] - (len(spans) - 1) * ops.CHUNK
    assert ops.blocks(launches) == sum(ops.n_chunks(n) for n in numels)


@pytest.mark.parametrize("n,max_leaves", [(1500, ops.MAX_LEAVES), (7, 3),
                                          (6, 3)])
def test_plan_splits_a_list_past_the_table(n, max_leaves):
    rng = np.random.default_rng(n)
    numels = [int(x) for x in rng.integers(1, 5 * ops.CHUNK, n)]
    launches = ops.plan(numels, max_leaves)
    assert len(launches) == math.ceil(n / max_leaves)
    assert [i for la in launches for i in la.leaves] == list(range(n))
    base = 0
    for la in launches:
        assert 0 < len(la.leaves) <= max_leaves
        assert la.base == base and la.first[0] == 0
        assert len(la.first) == len(la.leaves) + 1
        assert all(la.first[j + 1] - la.first[j] == ops.n_chunks(numels[i])
                   for j, i in enumerate(la.leaves))
        base += la.first[-1]
    assert ops.blocks(launches) == base
    assert ops.plan([]) == [] and ops.blocks([]) == 0


def test_kind_names_types_and_alignment():
    bf, f32 = torch.bfloat16, torch.float32
    assert ops.kind(bf, bf, (64, 128, 4096, 16)) == ops.GRAD_BF16 \
        | ops.PARAM_BF16 | ops.ALIGNED
    assert ops.kind(None, f32, (0, 64, 64, 64)) == ops.GRAD_NONE \
        | ops.ALIGNED
    assert ops.kind(f32, bf, (64, 64, 64, 64)) == ops.GRAD_F32 \
        | ops.PARAM_BF16 | ops.ALIGNED
    assert ops.kind(bf, None, (64,)) == ops.GRAD_BF16 | ops.ALIGNED
    # one element past a 16-byte boundary: every element goes alone
    assert ops.kind(bf, None, (66,)) == ops.GRAD_BF16
    assert ops.kind(bf, bf, (64, 66, 64, 64)) == ops.GRAD_BF16 \
        | ops.PARAM_BF16
    assert ops.kind(None, f32, (0, 64, 64, 68)) == ops.GRAD_NONE


def test_tables_read_each_tensor_where_it_lies():
    """Addresses, counts and kinds from the tensors themselves: a view one
    element past a 16-byte boundary is not aligned."""
    p = torch.zeros(65, dtype=torch.bfloat16)[1:]
    m, v = torch.zeros(64), torch.zeros(64)
    g = torch.zeros(64, dtype=torch.bfloat16)
    table, copied = ops.update_table([g, None], [m, m.clone()],
                                     [v, v.clone()], [p, m.clone()])
    assert table.ptrs[0] == [g.data_ptr(), 0]
    assert table.ptrs[1][0] == p.data_ptr() and table.numels == [64, 64]
    assert table.kinds == [ops.GRAD_BF16 | ops.PARAM_BF16,
                           ops.GRAD_NONE | ops.ALIGNED]
    assert (copied, table.keep) == (0, [])
    norms = ops.norm_table([None, g, p])
    assert norms.ptrs == [[g.data_ptr(), p.data_ptr()]]
    assert norms.kinds == [ops.GRAD_BF16 | ops.ALIGNED, ops.GRAD_BF16]


def test_tables_copy_a_gradient_that_is_not_contiguous():
    p = torch.randn(8, 6).to(torch.bfloat16)
    m, v = torch.randn(8, 6), torch.randn(8, 6).abs()
    g_t = torch.randn(6, 8).to(torch.bfloat16).T        # strided gradient
    table, copied = ops.update_table(
        [p.clone(), g_t, None], [m, m.clone(), m.clone()],
        [v, v.clone(), v.clone()], [p, p.clone(), p.clone()])
    assert copied == 1
    assert table.ptrs[1][0] == p.data_ptr()             # no copy
    assert table.ptrs[2][0] == m.data_ptr()
    (g_c,) = table.keep                                  # kept alive
    assert g_c.is_contiguous() and torch.equal(g_c, g_t)
    assert table.ptrs[0][1] == g_c.data_ptr() and table.ptrs[0][2] == 0
    norms = ops.norm_table([None, g_t, p])
    assert len(norms.keep) == 1 and torch.equal(norms.keep[0], g_t)
    assert norms.ptrs == [[norms.keep[0].data_ptr(), p.data_ptr()]]


@pytest.mark.parametrize("bad", ["dtype", "moment", "shape", "lengths",
                                 "strided_weight", "norm_dtype"])
def test_tables_refuse_what_the_kernels_do_not_take(bad):
    p, m, v = torch.zeros(4), torch.zeros(4), torch.zeros(4)
    g = torch.zeros(4)
    if bad == "norm_dtype":
        with pytest.raises(ValueError):
            ops.norm_table([g, g.half()])
        return
    args = {"dtype": ([g.half()], [m], [v], [p]),
            "moment": ([g], [m.double()], [v], [p]),
            "shape": ([g], [m], [v.view(2, 2)], [p]),
            "lengths": ([g, g], [m], [v], [p]),
            "strided_weight": ([g], [m], [v],
                               [torch.zeros(4, 2)[:, 0]])}[bad]
    with pytest.raises(ValueError):
        ops.update_table(*args)


def test_arrays_hold_the_launch_leaves_in_order():
    numels = [5, 70_000, 3]
    table = ops.Table([[11, 12, 13], [0, 22, 23]], numels, [1, 2, 6], [])
    launch = ops.plan(numels, max_leaves=2)[1]
    g, p, n, first, kind = K._arrays(launch, table)
    assert g.tolist() == [13] and p.tolist() == [23]
    assert n.tolist() == [3] and first.tolist() == [0, 1]
    assert kind.tolist() == [6]
    assert (g.dtype, n.dtype, first.dtype, kind.dtype) == (
        np.uint64, np.int64, np.int32, np.uint8)
    g, p, n, first, kind = K._arrays(ops.plan(numels)[0], table)
    assert p.tolist() == [0, 22, 23] and first.tolist() == [0, 1, 3, 4]


# ---------------------------------------------------------------------------
# the CPU route is the loop the optimizer ran before the kernels, which now
# lives in ref.py (held to the JAX reference by tests/test_torch_optim.py)
# ---------------------------------------------------------------------------

def loop_update(cfg, grads, state, params):
    """The optimizer's scalars, then ref.py's norm and loop."""
    step = state.step + 1
    lr = adamw.schedule(cfg, step)
    gn = global_norm_ref(grads)
    scale = torch.clamp(cfg.clip_norm / (gn + 1e-9), max=1.0)
    stepf = step.float()
    update_ref(grads, state.m, state.v, params, lr, scale,
               1 - cfg.b1 ** stepf, 1 - cfg.b2 ** stepf, cfg.b1, cfg.b2,
               cfg.eps, cfg.weight_decay)
    return step, gn, lr


SHAPES = [(), (7,), (3, 5), (1000,), (65537,), (33, 17)]


def cpu_leaves(seed, dtype, grad_scale):
    rng = np.random.default_rng(seed)
    t = lambda s, k=1.0: torch.from_numpy(
        np.asarray(rng.standard_normal(s) * k, np.float32))
    params = [t(s).to(dtype) for s in SHAPES]
    grads = [None if i == 3 else t(s, grad_scale).to(dtype)
             for i, s in enumerate(SHAPES)]
    ms = [t(s, 1e-3) for s in SHAPES]
    vs = [t(s, 1e-2).square() for s in SHAPES]
    return grads, ms, vs, params


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("grad_scale", [0.001, 10.0])  # unclipped, clipped
@pytest.mark.parametrize("step0", [0, 6])              # steps 1 and 7
def test_cpu_update_is_the_old_loop_bit_for_bit(dtype, grad_scale, step0):
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=3, total_steps=20)
    grads, ms, vs, params = cpu_leaves(step0, dtype, grad_scale)
    copy = lambda xs: [None if x is None else x.clone() for x in xs]
    og, om, ov, op = copy(grads), copy(ms), copy(vs), copy(params)
    step = torch.tensor(step0, dtype=torch.int32)
    launches = (K.update.launches, K.sumsq.launches)
    _, st, info = adamw.update(cfg, grads, adamw.AdamWState(step, ms, vs),
                               params)
    want_step, want_gn, want_lr = loop_update(
        cfg, og, adamw.AdamWState(step, om, ov), op)
    assert (K.update.launches, K.sumsq.launches) == launches
    assert torch.equal(st.step, want_step)
    assert info["grad_norm"].numpy().tobytes() == want_gn.numpy().tobytes()
    assert info["lr"].numpy().tobytes() == want_lr.numpy().tobytes()
    assert (float(info["grad_norm"]) > cfg.clip_norm) == (grad_scale > 1)
    for got, want in zip(ms + vs + params, om + ov + op):
        assert got.dtype == want.dtype
        assert got.view(-1).view(torch.uint8).numpy().tobytes() == \
            want.view(-1).view(torch.uint8).numpy().tobytes()


def test_cpu_global_norm_is_the_old_sum_bit_for_bit():
    grads = cpu_leaves(9, torch.bfloat16, 3.0)[0] + [None]
    got = adamw.global_norm(grads)
    want = global_norm_ref(grads)
    assert got.dtype == torch.float32 and got.shape == ()
    assert got.numpy().tobytes() == want.numpy().tobytes()
    assert float(adamw.global_norm([None])) == 0.0
