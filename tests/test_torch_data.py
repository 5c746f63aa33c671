"""PyTorch port of the synthetic LM data (``data/tokens.py``) against the
reference on the CPU: the batches are NumPy in both packages, so they
must be equal bit for bit — for every family's keys (``tokens``,
``frames``, ``patches``), for a seed and for a ``skip``."""
import itertools

import numpy as np
import pytest

from repro import configs as JC
from repro.data import tokens as JD
from repro_torch import configs as TC
from repro_torch.data import tokens as TD

# one config a family: dense, MoE, VLM (patches), RWKV6, Griffin, Whisper
# (frames)
NAMES = ["smollm_135m", "qwen2_moe_a2_7b", "internvl2_1b", "rwkv6_1_6b",
         "recurrentgemma_2b", "whisper_medium"]


def batches(mod, cfg, n, **kw):
    return list(itertools.islice(mod.synthetic_batches(cfg, 2, 16, **kw), n))


def assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
            assert g[k].tobytes() == w[k].tobytes()


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("seed,skip", [(0, 0), (3, 0), (3, 2)])
def test_synthetic_batches_equal_the_reference(name, seed, skip):
    jcfg, tcfg = JC.get_reduced(name), TC.get_reduced(name)
    got = batches(TD, tcfg, 3, seed=seed, skip=skip)
    assert_same(got, batches(JD, jcfg, 3, seed=seed, skip=skip))
    keys = {"audio": {"tokens", "frames"},
            "vlm": {"tokens", "patches"}}.get(tcfg.family, {"tokens"})
    assert set(got[0]) == keys


def test_skip_resumes_the_stream():
    """``skip=k`` yields the unskipped stream's batches from the k-th."""
    cfg = TC.get_reduced("whisper_medium")
    assert_same(batches(TD, cfg, 2, seed=1, skip=3),
                batches(TD, cfg, 5, seed=1)[3:])


@pytest.mark.parametrize("vocab", [2, 512, 49152])
def test_zipf_tokens_equal_the_reference(vocab):
    got = TD.zipf_tokens(np.random.default_rng(7), 4096, vocab)
    want = JD.zipf_tokens(np.random.default_rng(7), 4096, vocab)
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)
    assert got.min() >= 0 and got.max() < vocab
