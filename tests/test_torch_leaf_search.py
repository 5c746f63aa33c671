"""PyTorch port, leaf-search kernel: the plain version and the wrapper on CPU
tensors against the reference's Pallas kernel (interpret mode) and its jnp
oracle, on the reference kernel test's shapes, a ragged batch and the tree's
own uint8 versions; the pool wrapper on a bulkloaded tree; the CUDA kernel
against the plain version is in test_torch_cuda.py.  Tolerance: exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tree as JT
from repro.kernels.leaf_search.kernel import leaf_search as j_leaf_search
from repro.kernels.leaf_search.ops import lookup_leaves as j_lookup_leaves
from repro.kernels.leaf_search.ref import leaf_search_ref as j_ref
from repro_torch.core import tree as TT
from repro_torch.kernels.leaf_search.kernel import leaf_search
from repro_torch.kernels.leaf_search.ops import lookup_leaves
from repro_torch.kernels.leaf_search.ref import leaf_search_ref


def make_inputs(seed, b, f):
    """The reference kernel test's generator (tests/test_kernels.py)."""
    rng = np.random.default_rng(seed)
    keys = np.stack([rng.choice(9_000, f, replace=False)
                     for _ in range(b)]).astype(np.int32)
    vals = rng.integers(0, 1 << 20, (b, f)).astype(np.int32)
    q = np.where(rng.random(b) < 0.5,
                 keys[np.arange(b), rng.integers(0, f, b)],
                 20_000 + np.arange(b)).astype(np.int32)
    fev = rng.integers(0, 4, (b, f)).astype(np.int32)
    rev = fev.copy()
    rev[: b // 8] += 1
    fnv = rng.integers(0, 4, b).astype(np.int32)
    rnv = fnv.copy()
    rnv[b // 8: b // 4] += 1
    free = np.zeros(b, np.int32)
    free[b // 4: b // 4 + 4] = 1
    return [q, keys, vals, fev, rev, fnv, rnv, free]


def assert_outputs_equal(ref, got):
    dtypes = (torch.int32, torch.bool, torch.bool)
    for r, g, dt in zip(ref, got, dtypes):
        assert g.dtype == dt
        np.testing.assert_array_equal(np.asarray(r), g.numpy())


@pytest.mark.parametrize("b,f,bt", [(256, 8, 64), (512, 16, 128),
                                    (128, 32, 128), (256, 64, 256),
                                    (300, 16, 300), (1, 16, 1)])
def test_plain_version_matches_pallas_kernel_and_oracle(b, f, bt):
    host = make_inputs(b * f, b, f)
    jargs = [jnp.asarray(a) for a in host]
    pallas = j_leaf_search(*jargs, bt=bt, interpret=True)
    oracle = j_ref(*jargs)
    targs = [torch.from_numpy(a) for a in host]
    assert_outputs_equal(pallas, leaf_search_ref(*targs))
    assert_outputs_equal(oracle, leaf_search_ref(*targs))
    # the wrapper on CPU tensors runs the plain version
    assert_outputs_equal(oracle, leaf_search(*targs))


def test_uint8_versions_match_int32_versions():
    """The tree keeps FEV/REV as uint8; the kernel takes both widths."""
    host = make_inputs(5, 512, 16)
    targs = [torch.from_numpy(a) for a in host]
    narrow = list(targs)
    narrow[3], narrow[4] = targs[3].to(torch.uint8), targs[4].to(torch.uint8)
    for a, b in zip(leaf_search(*targs), leaf_search(*narrow)):
        assert torch.equal(a, b)


def test_empty_batch_returns_empty_outputs():
    host = make_inputs(1, 4, 16)
    targs = [torch.from_numpy(a)[:0] for a in host]
    value, found, cons = leaf_search(*targs)
    assert value.shape == found.shape == cons.shape == (0,)


@pytest.mark.parametrize("break_arg", ["dtype", "shape", "contiguity",
                                       "fanout"])
def test_wrapper_refuses_what_the_kernel_does_not_take(break_arg):
    host = make_inputs(2, 8, 16)
    targs = [torch.from_numpy(a) for a in host]
    if break_arg == "dtype":
        targs[1] = targs[1].to(torch.int64)
    elif break_arg == "shape":
        targs[5] = targs[5][:4]
    elif break_arg == "contiguity":
        targs[2] = torch.from_numpy(np.asfortranarray(host[2]))
    else:
        wide = make_inputs(2, 8, 300)
        targs = [torch.from_numpy(a) for a in wide]
    n0 = leaf_search.launches
    with pytest.raises((TypeError, ValueError)):
        leaf_search(*targs)
    assert leaf_search.launches == n0


def test_lookup_leaves_on_a_bulkloaded_tree():
    kw = dict(n_ms=2, nodes_per_ms=512, fanout=8, n_locks_per_ms=1024,
              max_height=6, n_cs=2)
    rng = np.random.default_rng(0)
    keys = rng.choice(100_000, size=300, replace=False).astype(np.int32)
    jcfg, tcfg = JT.TreeConfig(**kw), TT.TreeConfig(**kw)
    jst = JT.bulkload(jcfg, keys, keys * 3)
    tst = TT.bulkload(tcfg, keys, keys * 3, device="cpu")
    # tear one leaf (node versions) and one entry (entry versions)
    leaves = np.nonzero(np.asarray(jst.level) == 0)[0]
    jst = jst._replace(fnv=jst.fnv.at[leaves[0]].add(1),
                       fev=jst.fev.at[leaves[1], 0].add(1))
    tst.fnv[leaves[0]] += 1
    tst.fev[leaves[1], 0] += 1
    leaf = np.repeat(leaves[:8], 8).astype(np.int32)
    q = np.asarray(jst.keys)[leaf, np.arange(64) % 8].astype(np.int32)
    q[::5] = 123_456                                   # some misses
    want = j_lookup_leaves(jcfg, jst, jnp.asarray(leaf), jnp.asarray(q),
                           interpret=True)
    got = lookup_leaves(tcfg, tst, torch.from_numpy(leaf),
                        torch.from_numpy(q))
    assert_outputs_equal(want, got)
    assert not np.asarray(want[2]).all()          # the torn lanes showed
